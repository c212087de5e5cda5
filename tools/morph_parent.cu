// Kernel G: 3x3-cross opening -> 3x3-cross eroded marker -> reconstruction by
// dilation (8-connected), the tail of the binarize stage.
//
// Replaces the TPU kernel ops/pallas_bitpack.py:open_erode_reconstruct_packed
// (_open_erode_reconstruct_kernel with _cross_and / _cross_or /
// _reach_fixpoint), which ran the three stencils and the reachability
// fixpoint on 32 images per int32 plane, batch-wide, up to max_iters sweeps.
// Here one block owns one image, held in shared memory as one byte per pixel
// whose bits are the stage planes (80 KB at 320x256, above the 48 KB default,
// so the launch raises the block's dynamic shared-memory limit). Each stencil
// reads one bit of the neighbours and sets another bit of the thread's own
// byte, so no second plane is needed. Outside the frame every plane is 0.
// The reconstruction grows the marker inside `opened` in place until this
// image's own fixpoint (__syncthreads_or); growth is monotone, so reading a
// neighbour that another thread has just set only shortens the loop, and no
// sweep limit truncates it. The image is read and written once; the sweeps
// run out of shared memory, so the kernel is bound by shared-memory traffic
// and barriers. Plain twin: ops/cuda_morph.py:open_erode_reconstruct_plain.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kIn = 1, kEroded = 2, kOpened = 4, kReached = 8;

__device__ __forceinline__ int at(const uint8_t* s, int y, int x, int h, int w,
                                  int bit) {
  return (y >= 0 && y < h && x >= 0 && x < w) ? (s[y * w + x] & bit) : 0;
}

// dst bit <- AND (erode) or OR (dilate) of the src bit over the 3x3 cross.
__device__ void cross(uint8_t* s, int h, int w, int src, int dst, bool erode) {
  for (int p = threadIdx.x; p < h * w; p += blockDim.x) {
    const int y = p / w, x = p % w;
    const int c = s[p] & src, n = at(s, y - 1, x, h, w, src),
              d = at(s, y + 1, x, h, w, src), l = at(s, y, x - 1, h, w, src),
              e = at(s, y, x + 1, h, w, src);
    if (erode ? (c && n && d && l && e) : (c || n || d || l || e)) s[p] |= dst;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
open_erode_reconstruct_kernel(const uint8_t* __restrict__ in,
                              uint8_t* __restrict__ out, int h, int w) {
  extern __shared__ uint8_t s[];
  const int hw = h * w;
  const size_t base = (size_t)blockIdx.x * hw;
  for (int p = threadIdx.x; p < hw; p += blockDim.x)
    s[p] = in[base + p] != 0 ? kIn : 0;
  __syncthreads();
  cross(s, h, w, kIn, kEroded, true);
  cross(s, h, w, kEroded, kOpened, false);
  cross(s, h, w, kOpened, kReached, true);  // the marker, inside `opened`

  int grew;
  do {
    grew = 0;
    for (int p = threadIdx.x; p < hw; p += blockDim.x) {
      if ((s[p] & (kOpened | kReached)) != kOpened) continue;
      const int y = p / w, x = p % w;
      if (at(s, y - 1, x - 1, h, w, kReached) | at(s, y - 1, x, h, w, kReached) |
          at(s, y - 1, x + 1, h, w, kReached) | at(s, y, x - 1, h, w, kReached) |
          at(s, y, x + 1, h, w, kReached) | at(s, y + 1, x - 1, h, w, kReached) |
          at(s, y + 1, x, h, w, kReached) | at(s, y + 1, x + 1, h, w, kReached)) {
        s[p] |= kReached;
        grew = 1;
      }
    }
  } while (__syncthreads_or(grew));

  for (int p = threadIdx.x; p < hw; p += blockDim.x)
    out[base + p] = (s[p] & kReached) ? 1 : 0;
}

}  // namespace

// in, out: (nb, h, w) uint8 0/1. Needs h*w bytes of shared memory per block.
extern "C" int mbfp_open_erode_reconstruct(const uint8_t* in, uint8_t* out,
                                           int nb, int h, int w,
                                           cudaStream_t stream) {
  const size_t smem = (size_t)h * w;
  cudaError_t err = cudaFuncSetAttribute(
      open_erode_reconstruct_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  open_erode_reconstruct_kernel<<<nb, kThreads, smem, stream>>>(in, out, h, w);
  return (int)cudaGetLastError();
}
