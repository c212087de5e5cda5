// Kernel G: the tail of the binarize stage, a 3x3-cross opening.
//
// Replaces the TPU kernel ops/pallas_bitpack.py:open_erode_reconstruct_packed
// (_open_erode_reconstruct_kernel with _cross_and / _cross_or /
// _reach_fixpoint), which on 32 images per int32 plane took the opening
// O = (X erode C) dilate C of the mask X by the 3x3 cross C, the marker
// M = O erode C, and the reconstruction by dilation (8-connected) of M inside
// O, up to max_iters sweeps. The frame's border counts as background.
//
// The marker and the reconstruction are absent here because they are the
// identity: the reconstruction of M inside O is O, whatever the mask.
// - Let E = X erode C. For every e in E the cross e + C lies inside the
//   frame (e's four neighbours are in X) and inside O = E dilate C, so e is
//   in M. Hence E is a subset of M.
// - So O = E dilate C is a subset of M dilate C, a subset of M dilated by
//   the 3x3 square: every pixel of O is in M or 8-adjacent to a pixel of M.
// - M is a subset of O by definition. So the first synchronous 8-connected
//   dilation of M inside O returns all of O, and the fixpoint is O.
// The function is therefore out = dilate_cross(erode_cross(mask)), with no
// loop; its plain twin (ops/cuda_morph.py:open_erode_reconstruct_plain)
// still runs the three stages, and the tests hold the two equal.
//
// Layout: 32 pixels of a row to a uint32 word along x (packed_words.cuh), so
// a stencil is a few bitwise operations a word: the words of the rows above
// and below, and one-bit funnel shifts that carry in the edge bit of the
// left and right words. The frame's border and the padding bits of a row's
// last word read as 0 (load_word), so an eroded word has no padding bit set
// and the dilation cannot leak into them; store_word writes only the row's
// real pixels.
//
// Grid: a block owns a band of kRows rows and a strip of up to kWords words
// (256 pixels) of one image. It packs the band's words with two halo rows
// above and below and one halo word left and right into shared memory
// (zeros outside the frame; one barrier), then each thread takes an output
// word: the eroded words above, at and below it, the edge bits of the
// eroded words left and right of it (each from the packed words around
// them; only bit 31 of the left one and bit 0 of the right one are read, so
// their outer carries are 0), and their dilation. No loop, no per-pixel
// division, no per-image shared-memory budget: any H, W >= 1 is taken.
// 320x256 is 10 bands of one strip an image, 1,280 blocks of 256 threads at
// batch 128, a word a thread; a 1024x1024 frame is 128 blocks (narrower
// strips keep a small batch of large frames from leaving SMs idle).
//
// Bound: the mask crosses device memory once each way (2 bytes a pixel; the
// halo rows make the reads (kRows + 4) / kRows of the mask's bytes, most of
// them from L2); about 40 bitwise operations and 11 shared-memory loads a
// word of 32 pixels, far under the bytes.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "packed_words.cuh"

namespace {

constexpr int kRows = 32;               // output rows a block
constexpr int kWords = 8;               // output words a block along a row
constexpr int kThreads = 256;
constexpr int kTile = (kRows + 4) * (kWords + 2);   // words, halos included

// AND (erode) or OR (dilate) over the 3x3 cross of the centre word c, with
// the words above (n) and below (s), and the words left (l) and right (r)
// that carry in the west and east neighbours of bits 0 and 31.
__device__ __forceinline__ uint32_t erode(uint32_t n, uint32_t c, uint32_t s,
                                          uint32_t l, uint32_t r) {
  return c & n & s & __funnelshift_r(c, r, 1) & __funnelshift_l(l, c, 1);
}
__device__ __forceinline__ uint32_t dilate(uint32_t n, uint32_t c, uint32_t s,
                                           uint32_t l, uint32_t r) {
  return c | n | s | __funnelshift_r(c, r, 1) | __funnelshift_l(l, c, 1);
}

__global__ void __launch_bounds__(kThreads)
open_cross_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                  int h, int w, int wpr, int bands, int strips, int vec) {
  __shared__ uint32_t s[kTile];
  int blk = blockIdx.x;
  const int strip = blk % strips;
  blk /= strips;
  const int band = blk % bands;
  const size_t img = (size_t)(blk / bands);
  const int y0 = band * kRows, k0 = strip * kWords;
  const int rows = min(kRows, h - y0), kw = min(kWords, wpr - k0);
  const int pitch = kw + 2;
  const size_t base = img * (size_t)h * (size_t)w;

  // rows y0 - 2 .. y0 + rows + 1, words k0 - 1 .. k0 + kw
  for (int i = threadIdx.x; i < (rows + 4) * pitch; i += kThreads) {
    const int r = i / pitch, j = i - r * pitch;
    const int y = y0 - 2 + r, k = k0 - 1 + j;
    s[i] = y >= 0 && y < h && k >= 0 && k < wpr
               ? load_word(in + base + (size_t)y * w, 32 * k, w, vec)
               : 0u;
  }
  __syncthreads();

  for (int i = threadIdx.x; i < rows * kw; i += kThreads) {
    const int r = i / kw, j = i - r * kw;
    const uint32_t* c = s + (r + 2) * pitch + j + 1;   // the output word
    const uint32_t* lf = c - 1;
    const uint32_t* rt = c + 1;
    const uint32_t up = erode(c[-2 * pitch], c[-pitch], c[0], lf[-pitch],
                              rt[-pitch]);
    const uint32_t at = erode(c[-pitch], c[0], c[pitch], lf[0], rt[0]);
    const uint32_t dn = erode(c[0], c[pitch], c[2 * pitch], lf[pitch],
                              rt[pitch]);
    const uint32_t el = erode(lf[-pitch], lf[0], lf[pitch], 0u, c[0]);
    const uint32_t er = erode(rt[-pitch], rt[0], rt[pitch], c[0], 0u);
    store_word(out + base + (size_t)(y0 + r) * w, 32 * (k0 + j), w, vec,
               dilate(up, at, dn, el, er));
  }
}

}  // namespace

// in, out: (nb, h, w) uint8 0/1. Any nb, h, w >= 1 whose bands and strips
// number fewer than 2^31 blocks.
extern "C" int mbfp_open_erode_reconstruct(const uint8_t* in, uint8_t* out,
                                           int nb, int h, int w,
                                           cudaStream_t stream) {
  if (nb <= 0 || h <= 0 || w <= 0) return (int)cudaErrorInvalidValue;
  const int wpr = (w + 31) / 32;
  const long long bands = (h + kRows - 1) / kRows;
  const long long strips = (wpr + kWords - 1) / kWords;
  const long long blocks = (long long)nb * bands * strips;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  const int vec = w % 16 == 0 && (uintptr_t)in % 16 == 0 &&
                  (uintptr_t)out % 16 == 0;
  open_cross_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(
      in, out, h, w, wpr, (int)bands, (int)strips, vec);
  return (int)cudaGetLastError();
}
