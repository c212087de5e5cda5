// Kernel C: Zhang-Suen thinning to a fixpoint, then the optional prune of
// isolated pixels.
//
// Replaces the TPU kernel ops/pallas_bitpack.py:zs_thin_bitpacked
// (_zs_bit_kernel / _zs_bit_subpass), which thinned 32 images per int32
// plane in VMEM with a batch-wide while loop. Here one block owns one image,
// held in shared memory as one byte per pixel (80 KB at 320x256, above the
// 48 KB default, so the launch raises the block's dynamic shared-memory
// limit). Each subpass marks removable pixels in bit 1 from the state at the
// start of the subpass, then clears them; a block-wide flag ends the loop at
// the image's own fixpoint or after max_iters iterations. A converged image
// stays fixed, so per-image convergence gives the batch-wide loop's result.
// The image is read and written once; the iterations run out of shared
// memory, so the kernel is bound by shared-memory traffic and barriers.
// Plain twin: ops/cuda_thin.py:zs_thin_plain.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;

__device__ __forceinline__ int px(const uint8_t* s, int y, int x, int h,
                                  int w) {
  return (y >= 0 && y < h && x >= 0 && x < w) ? (s[y * w + x] & 1) : 0;
}

// Zhang-Suen removal test; ring P2..P9 = N, NE, E, SE, S, SW, W, NW.
__device__ __forceinline__ bool removable(const uint8_t* s, int y, int x,
                                          int h, int w, bool first) {
  const int p2 = px(s, y - 1, x, h, w), p3 = px(s, y - 1, x + 1, h, w);
  const int p4 = px(s, y, x + 1, h, w), p5 = px(s, y + 1, x + 1, h, w);
  const int p6 = px(s, y + 1, x, h, w), p7 = px(s, y + 1, x - 1, h, w);
  const int p8 = px(s, y, x - 1, h, w), p9 = px(s, y - 1, x - 1, h, w);
  const int b = p2 + p3 + p4 + p5 + p6 + p7 + p8 + p9;
  const int a = (!p2 & p3) + (!p3 & p4) + (!p4 & p5) + (!p5 & p6) +
                (!p6 & p7) + (!p7 & p8) + (!p8 & p9) + (!p9 & p2);
  const bool c = first ? ((p2 & p4 & p6) == 0 && (p4 & p6 & p8) == 0)
                       : ((p2 & p4 & p8) == 0 && (p2 & p6 & p8) == 0);
  return b >= 2 && b <= 6 && a == 1 && c;
}

__global__ void __launch_bounds__(kThreads)
zs_thin_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
               int h, int w, int max_iters, int prune) {
  extern __shared__ uint8_t s[];
  __shared__ int changed;
  const int hw = h * w;
  const size_t base = (size_t)blockIdx.x * hw;
  for (int p = threadIdx.x; p < hw; p += blockDim.x)
    s[p] = in[base + p] != 0 ? 1 : 0;
  __syncthreads();

  for (int it = 0; it < max_iters; ++it) {
    if (threadIdx.x == 0) changed = 0;
    __syncthreads();
    for (int sub = 0; sub < 2; ++sub) {
      for (int p = threadIdx.x; p < hw; p += blockDim.x) {
        if ((s[p] & 1) && removable(s, p / w, p % w, h, w, sub == 0)) {
          s[p] |= 2;  // bit 0 (the pixel) is untouched until the clear
          changed = 1;
        }
      }
      __syncthreads();
      for (int p = threadIdx.x; p < hw; p += blockDim.x)
        if (s[p] & 2) s[p] = 0;
      __syncthreads();
    }
    const bool done = (changed == 0);
    __syncthreads();  // everyone has read `changed` before it is reset
    if (done) break;
  }

  for (int p = threadIdx.x; p < hw; p += blockDim.x) {
    uint8_t v = s[p] & 1;
    if (v && prune) {
      const int y = p / w, x = p % w;
      const int n = px(s, y - 1, x, h, w) | px(s, y - 1, x + 1, h, w) |
                    px(s, y, x + 1, h, w) | px(s, y + 1, x + 1, h, w) |
                    px(s, y + 1, x, h, w) | px(s, y + 1, x - 1, h, w) |
                    px(s, y, x - 1, h, w) | px(s, y - 1, x - 1, h, w);
      v = (uint8_t)n;
    }
    out[base + p] = v;
  }
}

}  // namespace

// in, out: (nb, h, w) uint8 0/1. Needs h*w bytes of shared memory per block.
extern "C" int mbfp_zs_thin(const uint8_t* in, uint8_t* out, int nb, int h,
                            int w, int max_iters, int prune,
                            cudaStream_t stream) {
  const size_t smem = (size_t)h * w;
  cudaError_t err = cudaFuncSetAttribute(
      zs_thin_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  zs_thin_kernel<<<nb, kThreads, smem, stream>>>(in, out, h, w, max_iters,
                                                  prune);
  return (int)cudaGetLastError();
}
