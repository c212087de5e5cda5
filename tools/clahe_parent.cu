// Kernel A: CLAHE (contrast-limited adaptive histogram equalization).
//
// Replaces the TPU kernel ops/pallas_kernels.py:clahe_pallas
// (_clahe_kernel_v2 / _clahe_kernel). Plain twin: ops/cuda_kernels.py:
// clahe_plain. Bound on the card by memory traffic and launch latency: the
// image is read twice and written once; the LUTs are 1 KB per tile.
//
// Pass 1 (one block per (tile, image)): 256-bin histogram with shared-memory
// atomics, then one thread clips at `limit`, spreads the excess as
// excess/256 and takes the running CDF in bin order, rounding half to even
// (rintf) as torch.round does. Pass 2 (one thread per pixel): bilinear blend
// of the four neighbouring tile LUTs, every multiply and add rounded
// separately (__fmul_rn/__fadd_rn) so no FMA contraction changes the result
// against the plain version.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ int to_u8(float v) {
  float r = rintf(__fmul_rn(v, 255.0f));
  return (int)fminf(fmaxf(r, 0.0f), 255.0f);
}

__global__ void clahe_lut_kernel(const float* __restrict__ img,
                                 float* __restrict__ lut, int h, int w,
                                 int grid, float limit, float scale) {
  __shared__ unsigned int hist[256];
  const int tile = blockIdx.x;
  const int b = blockIdx.y;
  const int ty = tile / grid, tx = tile % grid;
  const int th = h / grid, tw = w / grid;
  for (int i = threadIdx.x; i < 256; i += blockDim.x) hist[i] = 0u;
  __syncthreads();
  const float* base =
      img + (size_t)b * h * w + (size_t)(ty * th) * w + (size_t)tx * tw;
  for (int p = threadIdx.x; p < th * tw; p += blockDim.x) {
    const int r = p / tw, c = p - r * tw;
    atomicAdd(&hist[to_u8(base[(size_t)r * w + c])], 1u);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float excess = 0.0f;
    for (int i = 0; i < 256; ++i)
      excess = __fadd_rn(excess, fmaxf(__fsub_rn((float)hist[i], limit), 0.0f));
    const float add = __fdiv_rn(excess, 256.0f);
    float* out = lut + ((size_t)b * grid * grid + tile) * 256;
    float cdf = 0.0f;
    for (int i = 0; i < 256; ++i) {
      cdf = __fadd_rn(cdf, __fadd_rn(fminf((float)hist[i], limit), add));
      out[i] = fminf(fmaxf(rintf(__fmul_rn(cdf, scale)), 0.0f), 255.0f);
    }
  }
}

// (lo tile, hi tile, weight of hi tile) for one coordinate, OpenCV's
// convention: tile coordinate = pixel / tile_size - 0.5.
__device__ __forceinline__ void blend_coord(int p, int tile, int grid, int* t0,
                                            int* t1, float* w1) {
  const float c = __fsub_rn(__fdiv_rn((float)p, (float)tile), 0.5f);
  const float fl = floorf(c);
  float wt = fminf(fmaxf(__fsub_rn(c, fl), 0.0f), 1.0f);
  if (c < 0.0f) wt = 0.0f;
  else if (c > (float)(grid - 1)) wt = 1.0f;
  *w1 = wt;
  *t0 = min(max((int)fl, 0), grid - 1);
  *t1 = min(max((int)fl + 1, 0), grid - 1);
}

__global__ void clahe_apply_kernel(const float* __restrict__ img,
                                   const float* __restrict__ lut,
                                   float* __restrict__ out, size_t total,
                                   int h, int w, int grid) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int x = (int)(i % w);
  const size_t t = i / w;
  const int y = (int)(t % h);
  const size_t b = t / h;
  int y0, y1, x0, x1;
  float wy1, wx1;
  blend_coord(y, h / grid, grid, &y0, &y1, &wy1);
  blend_coord(x, w / grid, grid, &x0, &x1, &wx1);
  const float wy0 = __fsub_rn(1.0f, wy1), wx0 = __fsub_rn(1.0f, wx1);
  const int v = to_u8(img[i]);
  const float* L = lut + b * grid * grid * 256;
  float acc = __fmul_rn(L[(y0 * grid + x0) * 256 + v], __fmul_rn(wy0, wx0));
  acc = __fadd_rn(acc, __fmul_rn(L[(y0 * grid + x1) * 256 + v],
                                 __fmul_rn(wy0, wx1)));
  acc = __fadd_rn(acc, __fmul_rn(L[(y1 * grid + x0) * 256 + v],
                                 __fmul_rn(wy1, wx0)));
  acc = __fadd_rn(acc, __fmul_rn(L[(y1 * grid + x1) * 256 + v],
                                 __fmul_rn(wy1, wx1)));
  out[i] = fminf(fmaxf(__fdiv_rn(acc, 255.0f), 0.0f), 1.0f);
}

}  // namespace

// img, out: (nb, h, w) float32; lut: (nb, grid, grid, 256) float32 scratch.
extern "C" int mbfp_clahe(const float* img, float* lut, float* out, int nb,
                          int h, int w, int grid, float limit, float scale,
                          cudaStream_t stream) {
  clahe_lut_kernel<<<dim3(grid * grid, nb), 256, 0, stream>>>(
      img, lut, h, w, grid, limit, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t total = (size_t)nb * h * w;
  const unsigned blocks = (unsigned)((total + 255) / 256);
  clahe_apply_kernel<<<blocks, 256, 0, stream>>>(img, lut, out, total, h, w,
                                                  grid);
  return (int)cudaGetLastError();
}
