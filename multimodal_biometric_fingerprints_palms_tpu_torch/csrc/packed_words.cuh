// 32 pixels of a row to a uint32 word and back, for the kernels that work on
// packed masks (C, thin.cu; G, morph.cu). Bit i of a word is pixel x0 + i of
// its row; a byte mask is 0 or 1 a pixel.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// four 0/1 bytes of a little-endian word -> four bits, and back
static __device__ __forceinline__ uint32_t pack4(uint32_t v) {
  return (v * 0x10204080u) >> 28;
}
static __device__ __forceinline__ uint32_t unpack4(uint32_t nib) {
  return (nib * 0x00204081u) & 0x01010101u;
}

// Bit i of the result is pixel x0 + i of `row` (0 beyond the row's end).
// `vec`: every full word of every row starts on a 16-byte boundary.
static __device__ __forceinline__ uint32_t load_word(const uint8_t* row,
                                                     int x0, int w, bool vec) {
  uint32_t bits = 0;
  if (vec && x0 + 32 <= w) {
    const uint4* p = reinterpret_cast<const uint4*>(row + x0);
    const uint4 a = p[0], b = p[1];
    bits = pack4(a.x) | pack4(a.y) << 4 | pack4(a.z) << 8 | pack4(a.w) << 12 |
           pack4(b.x) << 16 | pack4(b.y) << 20 | pack4(b.z) << 24 |
           pack4(b.w) << 28;
  } else {
    const int n = min(32, w - x0);
    for (int i = 0; i < n; ++i) bits |= (uint32_t)(row[x0 + i] != 0) << i;
  }
  return bits;
}

// Writes the row's real pixels of `bits` (none beyond the row's end).
static __device__ __forceinline__ void store_word(uint8_t* row, int x0,
                                                  int w, bool vec,
                                                  uint32_t bits) {
  if (vec && x0 + 32 <= w) {
    uint4* p = reinterpret_cast<uint4*>(row + x0);
    p[0] = make_uint4(unpack4(bits & 15u), unpack4((bits >> 4) & 15u),
                      unpack4((bits >> 8) & 15u), unpack4((bits >> 12) & 15u));
    p[1] = make_uint4(unpack4((bits >> 16) & 15u), unpack4((bits >> 20) & 15u),
                      unpack4((bits >> 24) & 15u), unpack4(bits >> 28));
  } else {
    const int n = min(32, w - x0);
    for (int i = 0; i < n; ++i) row[x0 + i] = (bits >> i) & 1u;
  }
}
