// Kernel E: non-local means denoising (cv2.fastNlMeansDenoising semantics,
// h=10, 7x7 template, 21x21 search on the main path).
//
// Replaces the TPU kernels of ops/pallas_kernels.py: nlm_denoise_pallas_sym
// (_nlm_kernel_sym2) with its border-ring recompute _nlm_ring_pallas
// (_nlm_ring_kernel), the small-frame form _nlm_sym_planes_small
// (_nlm_kernel_sym) and the earlier nlm_denoise_pallas_blocked
// (_nlm_kernel_blocked). Those took the 7x7 template sums as banded MXU
// matmuls over whole images, and the symmetric forms reused each SSD for
// the mirrored offset, which forced a separate recompute of the 13-px
// border ring and another accumulation order. Here every output pixel visits
// all search offsets itself, in the plain twin's order (row offset outer,
// column offset inner), so weights, values and the float32 accumulation are
// the twin's bit for bit, and one body serves every entry point and shape.
// Plain twin: ops/denoise.py:nlm_denoise_plain.
//
// One block owns a 32x32 output tile and keeps, in shared memory, the tile
// of the (bf16-rounded) image with a halo of search/2 + template/2 pixels,
// filled by the numpy "reflect" rule outside the frame (the search shift
// reads a mirror-padded image). Per offset: (1) the rounded squared
// difference on the tile grown by template/2, where a position outside the
// frame takes the value of its numpy-"symmetric" fold INSIDE the frame (the
// template box pads the difference plane, not the image); (2) the vertical
// 7-sum, rounded to bf16; (3) the horizontal 7-sum in float32, the weight
// bf16(exp(d2 * inv)), the value bf16(w * shifted), and two float32 adds.
// Taps add in the twin's order. precision "f32" skips every bf16 rounding.
//
// Bound: operations. A batch of 128 320x256 images is 4.6e9 pixel-offsets of
// about 20 float operations and one expf each against 21 MB of traffic; the
// image crosses device memory once each way. Multiplies and adds are
// __fmul_rn/__fadd_rn so nvcc contracts nothing into an fma; expf is the
// accurate version (no --use_fast_math).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTile = 32;
constexpr int kThreads = kTile * kTile;
constexpr int kMaxSlots = 4;  // grown-tile positions one thread may own

// numpy "reflect" (OpenCV BORDER_REFLECT_101): -1 -> 1, n -> n - 2.
__device__ __forceinline__ int mirror(int j, int n) {
  while (j < 0 || j >= n) j = j < 0 ? -j : 2 * n - 2 - j;
  return j;
}

// numpy "symmetric": -1 -> 0, n -> n - 1.
__device__ __forceinline__ int fold(int j, int n) {
  while (j < 0 || j >= n) j = j < 0 ? -1 - j : 2 * n - 1 - j;
  return j;
}

template <bool kBf16>
__device__ __forceinline__ float rnd(float v) {
  return kBf16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
nlm_kernel(const float* __restrict__ img, float* __restrict__ out, int h,
           int w, int tpl, int srch, float inv) {
  extern __shared__ float smem[];
  const int t = tpl / 2, r = srch / 2, halo = r + t;
  const int sw = kTile + 2 * halo;  // side of the image tile with its halo
  const int gw = kTile + 2 * t;     // side of the grown tile
  float* sx = smem;                 // (sw, sw)  image, mirror rule
  float* sa = sx + sw * sw;         // (gw, gw)  squared differences
  float* sb = sa + gw * gw;         // (kTile, gw) vertical template sums

  const int ty0 = blockIdx.y * kTile, tx0 = blockIdx.x * kTile;
  const float* src = img + (size_t)blockIdx.z * h * w;
  for (int i = threadIdx.x; i < sw * sw; i += kThreads) {
    const int y = mirror(ty0 - halo + i / sw, h);
    const int x = mirror(tx0 - halo + i % sw, w);
    sx[i] = rnd<kBf16>(src[(size_t)y * w + x]);
  }

  // The grown-tile positions this thread fills in step 1, as the index in
  // sx of the in-frame pixel each one folds to. -1: the fold leaves the
  // grown tile, which only a position that no in-frame output of this tile
  // sums can do.
  int centre[kMaxSlots];
#pragma unroll
  for (int s = 0; s < kMaxSlots; ++s) {
    const int i = threadIdx.x + s * kThreads;
    centre[s] = -1;
    if (i < gw * gw) {
      const int ly = fold(ty0 - t + i / gw, h) - (ty0 - halo);
      const int lx = fold(tx0 - t + i % gw, w) - (tx0 - halo);
      if (ly >= r && ly < sw - r && lx >= r && lx < sw - r)
        centre[s] = ly * sw + lx;
    }
  }
  const int ly = threadIdx.x / kTile, lx = threadIdx.x % kTile;
  const int own = (ly + halo) * sw + lx + halo;
  float acc = 0.0f, wacc = 0.0f;
  __syncthreads();

  for (int oy = -r; oy <= r; ++oy) {
    for (int ox = -r; ox <= r; ++ox) {
      const int shift = oy * sw + ox;
#pragma unroll
      for (int s = 0; s < kMaxSlots; ++s) {
        const int i = threadIdx.x + s * kThreads;
        if (i < gw * gw) {
          float v = 0.0f;
          if (centre[s] >= 0) {
            const float d =
                rnd<kBf16>(__fsub_rn(sx[centre[s]], sx[centre[s] + shift]));
            v = rnd<kBf16>(__fmul_rn(d, d));
          }
          sa[i] = v;
        }
      }
      __syncthreads();
      for (int i = threadIdx.x; i < kTile * gw; i += kThreads) {
        const float* col = sa + i;  // output row y sums grown rows y..y+tpl-1
        float v = col[0];
        for (int k = 1; k < tpl; ++k) v = __fadd_rn(v, col[k * gw]);
        sb[i] = rnd<kBf16>(v);
      }
      __syncthreads();
      const float* row = sb + ly * gw + lx;
      float d2 = row[0];
      for (int k = 1; k < tpl; ++k) d2 = __fadd_rn(d2, row[k]);
      const float wgt = rnd<kBf16>(expf(__fmul_rn(d2, inv)));
      acc = __fadd_rn(acc, rnd<kBf16>(__fmul_rn(wgt, sx[own + shift])));
      wacc = __fadd_rn(wacc, wgt);
      // No barrier here: the next offset's step 1 writes sa, which every
      // thread finished reading before the barrier above, and its step 2
      // writes sb only after the next barrier, which this step 3 precedes.
    }
  }
  const int y = ty0 + ly, x = tx0 + lx;
  if (y < h && x < w)
    out[((size_t)blockIdx.z * h + y) * w + x] =
        __fdiv_rn(acc, fmaxf(wacc, 1e-8f));
}

template <bool kBf16>
int launch(const float* img, float* out, int nb, int h, int w, int tpl,
           int srch, float inv, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      nlm_kernel<kBf16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((w + kTile - 1) / kTile, (h + kTile - 1) / kTile, nb);
  nlm_kernel<kBf16><<<grid, kThreads, smem, stream>>>(img, out, h, w, tpl,
                                                      srch, inv);
  return (int)cudaGetLastError();
}

}  // namespace

// img, out: (nb, h, w) float32; tpl, srch odd; inv = -1 / (h/255)^2 / tpl^2;
// bf16 != 0 rounds at the twin's bf16 points. h, w >= 2; nb <= 65535.
extern "C" int mbfp_nlm(const float* img, float* out, int nb, int h, int w,
                        int tpl, int srch, float inv, int bf16,
                        cudaStream_t stream) {
  if (tpl < 1 || srch < 1 || !(tpl & 1) || !(srch & 1) || h < 2 || w < 2 ||
      nb < 1 || nb > 65535)
    return (int)cudaErrorInvalidValue;
  const int gw = kTile + 2 * (tpl / 2);
  const int sw = gw + 2 * (srch / 2);
  if (gw * gw > kMaxSlots * kThreads) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((size_t)sw * sw + gw * gw + kTile * gw);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  return bf16 ? launch<true>(img, out, nb, h, w, tpl, srch, inv, smem, stream)
              : launch<false>(img, out, nb, h, w, tpl, srch, inv, smem,
                              stream);
}
