// Kernel C: Zhang-Suen thinning to a fixpoint, then the optional prune of
// isolated pixels.
//
// Replaces the TPU kernel ops/pallas_bitpack.py:zs_thin_bitpacked
// (_zs_bit_kernel / _zs_bit_subpass), which thinned 32 images per int32
// plane in VMEM with a batch-wide while loop. Here one block owns one image
// and the 32 pixels of a word lie along x within that image: one uint32 per
// 32 pixels of a row, ceil(W/32) words a row, packed on load and unpacked on
// store (320x256 is 2,560 words, 10 KB). Thinning is boolean algebra on the
// 3x3 neighbourhood, so a subpass handles a word with about 100 bitwise
// operations: the eight neighbour planes are the words above and below and
// one-bit funnel shifts that carry in the edge bit of the left and right
// words (the frame's border and the padding bits of a row's last word carry
// in zeros, and the padding bits stay zero because a subpass only clears
// bits); 2 <= B <= 6 comes from a bit-sliced adder tree over the eight
// planes, A == 1 from "at least one and not at least two" over the eight
// 0->1 transitions, the two products from three ANDs. A subpass reads the
// state at its start from one shared-memory plane and writes the next state
// into the other (no mark-then-clear pass); one barrier a subpass, and the
// changed flag rides on it (__syncthreads_or), so every image stops at its
// own fixpoint or after max_iters iterations. A converged image stays
// fixed, which makes this the batch-wide loop's result. A frame whose two
// planes exceed one block's shared memory (above about 960x960) keeps one
// plane, holds a thread's new words back until a second barrier, and so
// pays two barriers a subpass; 1024x1024 (128 KB packed) runs that way.
//
// Bound: the mask crosses device memory once each way (2 bytes a pixel); the
// iterations run out of shared memory and registers, so the time goes to
// bitwise instructions and one barrier a subpass, on one SM per image.
// Plain twins: ops/cuda_thin.py:zs_thin_plain (a pixel per element) and
// zs_thin_words_plain (this file's word algebra, in PyTorch).

#include <cuda_runtime.h>
#include <stdint.h>

#include "packed_words.cuh"

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kSmemLimit = 232448;   // bytes one block may use on sm_90
// words a thread holds back in the one-plane form: ceil(kSmemLimit / 4 / 1024)
constexpr int kOwn = 57;

// The eight neighbour planes of word `idx` (centre `c`), ring order
// P2..P9 = N, NE, E, SE, S, SW, W, NW; zeros beyond the frame.
__device__ __forceinline__ void ring(const uint32_t* s, int idx, int h,
                                     int wpr, uint32_t c, uint32_t p[8]) {
  const int r = idx / wpr, k = idx - r * wpr;
  const bool up = r > 0, dn = r + 1 < h, lf = k > 0, rt = k + 1 < wpr;
  const uint32_t n = up ? s[idx - wpr] : 0u, so = dn ? s[idx + wpr] : 0u;
  const uint32_t wl = lf ? s[idx - 1] : 0u, wr = rt ? s[idx + 1] : 0u;
  const uint32_t nl = up && lf ? s[idx - wpr - 1] : 0u;
  const uint32_t nr = up && rt ? s[idx - wpr + 1] : 0u;
  const uint32_t sl = dn && lf ? s[idx + wpr - 1] : 0u;
  const uint32_t sr = dn && rt ? s[idx + wpr + 1] : 0u;
  // bit i is pixel 32k + i: the east neighbour is bit i + 1
  p[0] = n;
  p[1] = __funnelshift_r(n, nr, 1);
  p[2] = __funnelshift_r(c, wr, 1);
  p[3] = __funnelshift_r(so, sr, 1);
  p[4] = so;
  p[5] = __funnelshift_l(sl, so, 1);
  p[6] = __funnelshift_l(wl, c, 1);
  p[7] = __funnelshift_l(nl, n, 1);
}

__device__ __forceinline__ uint32_t maj(uint32_t a, uint32_t b, uint32_t c) {
  return (a & b) | (c & (a ^ b));
}

// One Zhang-Suen subpass on 32 pixels: the word without its removable bits.
__device__ __forceinline__ uint32_t thin_word(uint32_t c, const uint32_t p[8],
                                              bool first) {
  const uint32_t p2 = p[0], p3 = p[1], p4 = p[2], p5 = p[3], p6 = p[4],
                 p7 = p[5], p8 = p[6], p9 = p[7];
  // B = p2 + ... + p9 as bit planes b0 (ones), b1, b2 (b3 set means B == 8,
  // which has b1 == b2 == 0 and fails the first term)
  const uint32_t s0 = p2 ^ p3 ^ p4, c0 = maj(p2, p3, p4);
  const uint32_t s1 = p5 ^ p6 ^ p7, c1 = maj(p5, p6, p7);
  const uint32_t s2 = p8 ^ p9, c2 = p8 & p9;
  const uint32_t b0 = s0 ^ s1 ^ s2, d0 = maj(s0, s1, s2);
  const uint32_t u0 = c0 ^ c1 ^ c2, e0 = maj(c0, c1, c2);
  const uint32_t b1 = u0 ^ d0, e1 = u0 & d0;
  const uint32_t b2 = e0 ^ e1;
  const uint32_t ok_b = (b1 | b2) & ~(b0 & b1 & b2);   // 2 <= B <= 6
  // A == 1: exactly one 0 -> 1 transition round the ring
  uint32_t one = 0u, two = 0u;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint32_t t = ~p[i] & p[(i + 1) & 7];
    two |= one & t;
    one |= t;
  }
  const uint32_t prod = first ? p4 & p6 & (p2 | p8) : p2 & p8 & (p4 | p6);
  return c & ~(ok_b & one & ~two & ~prod);
}

// One subpass over the image. Returns non-zero for the whole block if any
// word changed. Ends in a barrier.
template <bool kTwoPlanes>
__device__ __forceinline__ int subpass(uint32_t* cur, uint32_t* nxt, int h,
                                       int wpr, int nw, bool first) {
  uint32_t held[kTwoPlanes ? 1 : kOwn];
  int changed = 0, n = 0;
  for (int idx = threadIdx.x; idx < nw; idx += blockDim.x, ++n) {
    const uint32_t c = cur[idx];
    uint32_t v = c;
    if (c) {   // an empty word stays empty
      uint32_t p[8];
      ring(cur, idx, h, wpr, c, p);
      v = thin_word(c, p, first);
      changed |= v != c;
    }
    if (kTwoPlanes) nxt[idx] = v; else held[n] = v;
  }
  if (!kTwoPlanes) {
    __syncthreads();   // every thread has read the state it needs
    n = 0;
    for (int idx = threadIdx.x; idx < nw; idx += blockDim.x, ++n)
      cur[idx] = held[n];
  }
  return __syncthreads_or(changed);
}

template <bool kTwoPlanes>
__global__ void __launch_bounds__(kMaxThreads)
zs_thin_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
               int h, int w, int wpr, int max_iters, int prune, int vec) {
  extern __shared__ uint32_t planes[];
  const int nw = h * wpr;
  uint32_t* cur = planes;
  uint32_t* nxt = kTwoPlanes ? planes + nw : planes;
  const size_t base = (size_t)blockIdx.x * h * w;
  for (int idx = threadIdx.x; idx < nw; idx += blockDim.x) {
    const int r = idx / wpr, k = idx - r * wpr;
    cur[idx] = load_word(in + base + (size_t)r * w, 32 * k, w, vec);
  }
  __syncthreads();

  for (int it = 0; it < max_iters; ++it) {
    int changed = subpass<kTwoPlanes>(cur, nxt, h, wpr, nw, true);
    if (kTwoPlanes) { uint32_t* t = cur; cur = nxt; nxt = t; }
    changed |= subpass<kTwoPlanes>(cur, nxt, h, wpr, nw, false);
    if (kTwoPlanes) { uint32_t* t = cur; cur = nxt; nxt = t; }
    if (!changed) break;
  }

  for (int idx = threadIdx.x; idx < nw; idx += blockDim.x) {
    const int r = idx / wpr, k = idx - r * wpr;
    uint32_t c = cur[idx];
    if (c && prune) {   // drop pixels with no 8-neighbour
      uint32_t p[8];
      ring(cur, idx, h, wpr, c, p);
      c &= p[0] | p[1] | p[2] | p[3] | p[4] | p[5] | p[6] | p[7];
    }
    store_word(out + base + (size_t)r * w, 32 * k, w, vec, c);
  }
}

template <bool kTwoPlanes>
int launch(const uint8_t* in, uint8_t* out, int nb, int h, int w, int wpr,
           int max_iters, int prune, int vec, int threads, size_t smem,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      zs_thin_kernel<kTwoPlanes>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  zs_thin_kernel<kTwoPlanes><<<nb, threads, smem, stream>>>(
      in, out, h, w, wpr, max_iters, prune, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// in, out: (nb, h, w) uint8 0/1. The packed image, 4 * h * ceil(w / 32)
// bytes, must fit one block's shared memory (232,448 bytes); twice that, and
// the kernel runs its one-barrier form.
extern "C" int mbfp_zs_thin(const uint8_t* in, uint8_t* out, int nb, int h,
                            int w, int max_iters, int prune,
                            cudaStream_t stream) {
  if (nb <= 0 || h <= 0 || w <= 0) return (int)cudaErrorInvalidValue;
  const int wpr = (w + 31) / 32;
  const long long nw = (long long)h * wpr;
  if (nw * 4 > kSmemLimit) return (int)cudaErrorInvalidValue;
  const bool two = nw * 8 <= kSmemLimit;
  // balanced words per thread, whole warps
  const int per = (int)((nw + kMaxThreads - 1) / kMaxThreads);
  int threads = (int)((nw + per - 1) / per);
  threads = two ? (threads + 31) / 32 * 32 : kMaxThreads;
  const int vec = w % 16 == 0 && (uintptr_t)in % 16 == 0 &&
                  (uintptr_t)out % 16 == 0;
  return two ? launch<true>(in, out, nb, h, w, wpr, max_iters, prune, vec,
                            threads, (size_t)nw * 8, stream)
             : launch<false>(in, out, nb, h, w, wpr, max_iters, prune, vec,
                             threads, (size_t)nw * 4, stream);
}
