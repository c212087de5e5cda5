// Kernel C: Zhang-Suen thinning to a fixpoint, then the optional prune of
// isolated pixels.
//
// Replaces the TPU kernel ops/pallas_bitpack.py:zs_thin_bitpacked
// (_zs_bit_kernel / _zs_bit_subpass), which thinned 32 images per int32
// plane in VMEM with a batch-wide while loop. Here the 32 pixels of a word
// lie along x within one image: one uint32 per 32 pixels of a row,
// ceil(W/32) words a row, packed on load and unpacked on store (320x256 is
// 2,560 words, 10 KB). Thinning is boolean algebra on the 3x3
// neighbourhood, so a subpass handles a word with about 100 bitwise
// operations: the eight neighbour planes are the words above and below and
// one-bit funnel shifts that carry in the edge bit of the left and right
// words (the frame's border and the padding bits of a row's last word carry
// in zeros, and the padding bits stay zero because a subpass only clears
// bits); 2 <= B <= 6 comes from a bit-sliced adder tree over the eight
// planes, A == 1 from "at least one and not at least two" over the eight
// 0->1 transitions, the two products from three ANDs. A subpass reads the
// state at its start from one plane and writes the next state into the
// other (no mark-then-clear pass). Every image stops at its own fixpoint or
// after max_iters iterations; a converged image stays fixed, which makes
// this the batch-wide loop's result.
//
// Two forms, by frame size:
// - One block an image, where both planes fit one block's shared memory
//   (up to about 960x960; 320x256 is 20 KB): the image stays in shared
//   memory for the whole fixpoint, one barrier a subpass, and the changed
//   flag rides on it (__syncthreads_or).
// - Device memory, any larger frame (1024x1024 is 256 KB for two planes).
//   The two planes live in device memory (scratch from the wrapper) and
//   every subpass is one launch over all images, a word a thread: the
//   ping-pong planes give each word the state at the start of the subpass,
//   its neighbours' included, across any block's seam. The flags are three
//   rows of one int per image plus one for the batch. Iteration `it` sets
//   row it % 3 where an image changed, skips an image whose row
//   (it - 1) % 3 entry is 0 (it has converged, so running it again would
//   change nothing), and clears row (it + 1) % 3 for the next iteration
//   (the last launch that read it has finished). The host enqueues kCheck
//   iterations at a time, never past max_iters, and reads the batch's flag
//   of the last one: 0 means every image has converged. Pack, the
//   iterations and the final prune-and-unpack are separate launches; the
//   prune reads the whole final plane, seams included. On one H100 this
//   form took 8 frames of 1024x1024 in 0.31 ms where one block an image
//   with one shared-memory plane (two barriers a subpass, the form it
//   replaced there) took 0.71 ms; at 32 frames of 512x512 the one-block
//   form is faster (0.14 against 0.24 ms), and it stays where it fits.
//
// Bound: the mask crosses device memory once each way (2 bytes a pixel).
// The one-block form iterates out of shared memory and registers, so its
// time goes to bitwise instructions and one barrier a subpass, on one SM
// per image; the device-memory form reads each word's nine neighbours per
// subpass from L1/L2 (a 2048x2048 plane is 512 KB) and pays one launch a
// subpass. Plain twins: ops/cuda_thin.py:zs_thin_plain (a pixel per
// element) and zs_thin_words_plain (this file's word algebra, in PyTorch).

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "packed_words.cuh"

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kSmemLimit = 232448;   // bytes one block may use on sm_90

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

// One subpass over the image, `cur` -> `nxt`. Returns non-zero for the
// whole block if any word changed. Ends in a barrier.
__device__ __forceinline__ int subpass(const uint32_t* cur, uint32_t* nxt,
                                       int h, int wpr, int nw, bool first) {
  int changed = 0;
  for (int idx = threadIdx.x; idx < nw; idx += blockDim.x) {
    const uint32_t c = cur[idx];
    uint32_t v = c;
    if (c) {   // an empty word stays empty
      uint32_t p[8];
      ring(cur, idx, h, wpr, c, p);
      v = thin_word(c, p, first);
      changed |= v != c;
    }
    nxt[idx] = v;
  }
  return __syncthreads_or(changed);
}

__global__ void __launch_bounds__(kMaxThreads)
zs_thin_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
               int h, int w, int wpr, int max_iters, int prune, int vec) {
  extern __shared__ uint32_t planes[];
  const int nw = h * wpr;
  uint32_t* cur = planes;
  uint32_t* nxt = planes + nw;
  const size_t base = (size_t)blockIdx.x * h * w;
  for (int idx = threadIdx.x; idx < nw; idx += blockDim.x) {
    const int r = idx / wpr, k = idx - r * wpr;
    cur[idx] = load_word(in + base + (size_t)r * w, 32 * k, w, vec);
  }
  __syncthreads();

  for (int it = 0; it < max_iters; ++it) {
    // the second subpass writes back into the first plane
    int changed = subpass(cur, nxt, h, wpr, nw, true);
    changed |= subpass(nxt, cur, h, wpr, nw, false);
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

int launch_block(const uint8_t* in, uint8_t* out, int nb, int h, int w,
                 int wpr, int max_iters, int prune, int vec, int threads,
                 size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      zs_thin_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  zs_thin_kernel<<<nb, threads, smem, stream>>>(
      in, out, h, w, wpr, max_iters, prune, vec);
  return (int)cudaGetLastError();
}

// --- the device-memory form ----------------------------------------------

constexpr int kThreadsG = 256;   // words a block, one a thread
constexpr int kCheck = 4;        // iterations enqueued between flag reads

// The words of image `img` that block `blockIdx.x` covers: chunks blocks an
// image, a word a thread; -1 past the image's last word.
__device__ __forceinline__ int word_of(int chunks, int nw, int& img) {
  img = blockIdx.x / chunks;
  const int idx = (blockIdx.x - img * chunks) * kThreadsG + threadIdx.x;
  return idx < nw ? idx : -1;
}

__global__ void __launch_bounds__(kThreadsG)
pack_kernel(const uint8_t* __restrict__ in, uint32_t* __restrict__ plane,
            int h, int w, int wpr, int chunks, int vec) {
  int img;
  const int nw = h * wpr, idx = word_of(chunks, nw, img);
  if (idx < 0) return;
  const int r = idx / wpr, k = idx - r * wpr;
  plane[(size_t)img * nw + idx] = load_word(
      in + ((size_t)img * h + r) * (size_t)w, 32 * k, w, vec);
}

// One subpass of iteration `it` over every live image: `cur` -> `nxt`.
// flags: three rows of nb + 1 ints (per image, then the batch's).
template <bool kFirst>
__global__ void __launch_bounds__(kThreadsG)
subpass_kernel(const uint32_t* __restrict__ cur, uint32_t* __restrict__ nxt,
               int* __restrict__ flags, int nb, int h, int wpr, int chunks,
               int it) {
  int img;
  const int nw = h * wpr, idx = word_of(chunks, nw, img);
  int* now = flags + (it % 3) * (nb + 1);
  if (kFirst && threadIdx.x == 0 && blockIdx.x % chunks == 0) {
    int* next = flags + ((it + 1) % 3) * (nb + 1);
    next[img] = 0;
    if (img == 0) next[nb] = 0;
  }
  // block-uniform: the image converged in the previous iteration
  if (it > 0 && flags[((it + 2) % 3) * (nb + 1) + img] == 0) return;
  int changed = 0;
  if (idx >= 0) {
    const uint32_t* s = cur + (size_t)img * nw;
    const uint32_t c = s[idx];
    uint32_t v = c;
    if (c) {
      uint32_t p[8];
      ring(s, idx, h, wpr, c, p);
      v = thin_word(c, p, kFirst);
      changed = v != c;
    }
    nxt[(size_t)img * nw + idx] = v;
  }
  if (__syncthreads_or(changed) && threadIdx.x == 0) {
    now[img] = 1;
    now[nb] = 1;
  }
}

__global__ void __launch_bounds__(kThreadsG)
store_kernel(const uint32_t* __restrict__ plane, uint8_t* __restrict__ out,
             int h, int w, int wpr, int chunks, int prune, int vec) {
  int img;
  const int nw = h * wpr, idx = word_of(chunks, nw, img);
  if (idx < 0) return;
  const uint32_t* s = plane + (size_t)img * nw;
  const int r = idx / wpr, k = idx - r * wpr;
  uint32_t c = s[idx];
  if (c && prune) {   // drop pixels with no 8-neighbour
    uint32_t p[8];
    ring(s, idx, h, wpr, c, p);
    c &= p[0] | p[1] | p[2] | p[3] | p[4] | p[5] | p[6] | p[7];
  }
  store_word(out + ((size_t)img * h + r) * (size_t)w, 32 * k, w, vec, c);
}

// Scratch of the device-memory form: two planes, then the flags.
size_t device_scratch_bytes(int nb, long long nw) {
  return (size_t)nb * (size_t)nw * 8 + (size_t)(nb + 1) * 3 * sizeof(int);
}

int launch_device(const uint8_t* in, uint8_t* out, void* scratch, int nb,
                  int h, int w, int wpr, int max_iters, int prune, int vec,
                  cudaStream_t stream) {
  const int nw = h * wpr;
  const long long chunks = (nw + kThreadsG - 1) / kThreadsG;
  if (chunks * nb > INT_MAX) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)(chunks * nb);
  uint32_t* a = static_cast<uint32_t*>(scratch);
  uint32_t* b = a + (size_t)nb * nw;
  int* flags = reinterpret_cast<int*>(b + (size_t)nb * nw);
  cudaError_t err = cudaMemsetAsync(flags, 0, (size_t)(nb + 1) * 3 *
                                    sizeof(int), stream);
  if (err != cudaSuccess) return (int)err;
  pack_kernel<<<blocks, kThreadsG, 0, stream>>>(in, a, h, w, wpr,
                                                (int)chunks, vec);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  // every iteration leaves the image in `a`
  for (int it = 0; it < max_iters;) {
    const int stop = max_iters - it > kCheck ? it + kCheck : max_iters;
    for (; it < stop; ++it) {
      subpass_kernel<true><<<blocks, kThreadsG, 0, stream>>>(
          a, b, flags, nb, h, wpr, (int)chunks, it);
      subpass_kernel<false><<<blocks, kThreadsG, 0, stream>>>(
          b, a, flags, nb, h, wpr, (int)chunks, it);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    }
    int any = 0;
    err = cudaMemcpyAsync(&any, flags + ((it - 1) % 3) * (nb + 1) + nb,
                          sizeof(int), cudaMemcpyDeviceToHost, stream);
    if (err == cudaSuccess) err = cudaStreamSynchronize(stream);
    if (err != cudaSuccess) return (int)err;
    if (!any) break;
  }
  store_kernel<<<blocks, kThreadsG, 0, stream>>>(a, out, h, w, wpr,
                                                 (int)chunks, prune, vec);
  return (int)cudaGetLastError();
}

// 0: one block an image; 1: device memory; -1: the form asked for cannot
// take the frame. `form` 0 picks by size, 1 asks for one block, 2 for
// device memory.
int pick(long long nw, int form) {
  const bool fits = nw * 8 <= kSmemLimit;   // both planes
  if (form == 2 || (form == 0 && !fits)) return 1;
  return fits ? 0 : -1;
}

}  // namespace

// Bytes of device scratch mbfp_zs_thin needs for this batch and form (0
// for the one-block forms); -1 in *bytes if the form cannot take the frame.
extern "C" int mbfp_zs_thin_scratch(int nb, int h, int w, int form,
                                    long long* bytes) {
  if (nb <= 0 || h <= 0 || w <= 0 || form < 0 || form > 2)
    return (int)cudaErrorInvalidValue;
  const long long nw = (long long)h * ((w + 31) / 32);
  const int f = pick(nw, form);
  *bytes = f < 0 ? -1 : f == 1 ? (long long)device_scratch_bytes(nb, nw) : 0;
  return 0;
}

// in, out: (nb, h, w) uint8 0/1; scratch: mbfp_zs_thin_scratch's bytes.
// Any h, w >= 1 whose image has fewer than 2^31 words; `form` as above.
extern "C" int mbfp_zs_thin(const uint8_t* in, uint8_t* out, void* scratch,
                            int nb, int h, int w, int max_iters, int prune,
                            int form, cudaStream_t stream) {
  if (nb <= 0 || h <= 0 || w <= 0 || form < 0 || form > 2)
    return (int)cudaErrorInvalidValue;
  const int wpr = (w + 31) / 32;
  const long long nw = (long long)h * wpr;
  if (nw > INT_MAX) return (int)cudaErrorInvalidValue;
  const int f = pick(nw, form);
  if (f < 0 || (f == 1 && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  const int vec = w % 16 == 0 && (uintptr_t)in % 16 == 0 &&
                  (uintptr_t)out % 16 == 0;
  if (f == 1)
    return launch_device(in, out, scratch, nb, h, w, wpr, max_iters, prune,
                         vec, stream);
  // balanced words per thread, whole warps
  const int per = (int)((nw + kMaxThreads - 1) / kMaxThreads);
  const int threads = ((int)((nw + per - 1) / per) + 31) / 32 * 32;
  return launch_block(in, out, nb, h, w, wpr, max_iters, prune, vec, threads,
                      (size_t)nw * 8, stream);
}
