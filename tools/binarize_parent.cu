// Kernel F: the front of the binarize stage, after CLAHE: adaptive Sauvola
// (window 25, k-map k*(1 - 0.5*std_n)) OR-ed with a per-32x32-patch Otsu
// threshold gated by the patch's standard deviation (>= 3/255).
//
// Replaces the TPU kernels of ops/pallas_kernels.py: the first phase of
// binarize_fused_split_pallas (_binarize_fg_kernel with _sauvola_front and
// _binarize_front), the same front inside binarize_fused_pallas
// (_binarize_fused_kernel), and sauvola_binarize_pallas (_sauvola_kernel,
// the Sauvola half alone). Those held one image in VMEM, took the box sums
// as log-tree shifted adds and the patch histograms as one-hot MXU matmuls.
// Plain twin: ops/cuda_binarize.py:binarize_foreground_plain.
//
// Sauvola needs each image's max(std) before any pixel can be thresholded,
// and an image does not fit one block's shared memory, so there are two
// launches over 32x32 tiles (one tile = one Otsu patch): the first takes
// each tile's box mean, box square-mean and std and folds the image's max
// into one word with atomicMax on the non-negative float's bits; the second
// takes them again (cheaper than 84 MB of scratch traffic at batch 128),
// thresholds, and, for the hybrid form, builds the tile's 256-bin histogram
// in shared memory, scans omega and mu, takes the first argmax of the
// between-class variance and the centred two-pass patch std, and ORs the
// refinement in.
//
// `x < sauv` and `p_std >= 3/255` are knife-edge float32 compares, so the
// arithmetic follows the twin operation by operation: the separable box
// filter sums win taps of weight float32(1/win) in tap order, vertical pass
// first, over the numpy-"symmetric" border; every multiply, add, divide and
// square root is an explicitly rounded intrinsic, so nvcc contracts nothing
// into an fma. The histogram's prefix sums are multiples of 1/1024 and exact
// in float32 in any order. Only the patch mean and variance (sums of 1,024
// floats) are taken in another order than the twin's.
//
// Bound: operations. A pixel costs 4*win multiply-adds for the two separable
// box means, twice, against 5 bytes of traffic.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;              // tile side = Otsu patch side
constexpr int kThreads = kTile * kTile;
constexpr int kMaxWin = 33;
constexpr int kSpan = kTile + kMaxWin - 1;

// numpy "symmetric": -1 -> 0, n -> n - 1.
__device__ __forceinline__ int fold(int j, int n) {
  while (j < 0 || j >= n) j = j < 0 ? -1 - j : 2 * n - 1 - j;
  return j;
}

struct Tile {
  float x[kSpan][kSpan];        // image tile with a halo of win/2
  float v[2][kTile][kSpan];     // vertical pass of x and of x*x
};

// This thread's pixel of the tile: box mean, std and the pixel itself.
__device__ void mean_std(Tile& s, const float* __restrict__ src, int h, int w,
                         int win, float tap, float* mean, float* std,
                         float* pixel) {
  const int c = win / 2, span = kTile + win - 1;
  const int ty0 = blockIdx.y * kTile, tx0 = blockIdx.x * kTile;
  for (int i = threadIdx.x; i < span * span; i += kThreads) {
    const int iy = i / span, ix = i % span;
    s.x[iy][ix] = src[(size_t)fold(ty0 - c + iy, h) * w + fold(tx0 - c + ix, w)];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kTile * span; i += kThreads) {
    const int ly = i / span, ix = i % span;
    float a = s.x[ly][ix];
    float m = __fmul_rn(tap, a), q = __fmul_rn(tap, __fmul_rn(a, a));
    for (int t = 1; t < win; ++t) {
      a = s.x[ly + t][ix];
      m = __fadd_rn(m, __fmul_rn(tap, a));
      q = __fadd_rn(q, __fmul_rn(tap, __fmul_rn(a, a)));
    }
    s.v[0][ly][ix] = m;
    s.v[1][ly][ix] = q;
  }
  __syncthreads();
  const int ly = threadIdx.x / kTile, lx = threadIdx.x % kTile;
  float m = __fmul_rn(tap, s.v[0][ly][lx]), q = __fmul_rn(tap, s.v[1][ly][lx]);
  for (int t = 1; t < win; ++t) {
    m = __fadd_rn(m, __fmul_rn(tap, s.v[0][ly][lx + t]));
    q = __fadd_rn(q, __fmul_rn(tap, s.v[1][ly][lx + t]));
  }
  *mean = m;
  *std = __fsqrt_rn(fmaxf(__fsub_rn(q, __fmul_rn(m, m)), 0.0f));
  *pixel = s.x[ly + c][lx + c];
}

// Sum of v over the block, returned to every thread. red: 32 floats.
__device__ float block_sum(float v, float* red) {
  for (int off = 16; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
  __syncthreads();  // red may still be read from an earlier call
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = red[threadIdx.x & 31];
  for (int off = 16; off > 0; off >>= 1)
    t = __fadd_rn(t, __shfl_xor_sync(0xffffffffu, t, off));
  return t;
}

__global__ void __launch_bounds__(kThreads)
std_max_kernel(const float* __restrict__ img, int* __restrict__ stdmax, int h,
               int w, int win, float tap) {
  __shared__ Tile s;
  __shared__ int best;
  if (threadIdx.x == 0) best = 0;
  float mean, std, pixel;
  mean_std(s, img + (size_t)blockIdx.z * h * w, h, w, win, tap, &mean, &std,
           &pixel);
  const int y = blockIdx.y * kTile + threadIdx.x / kTile;
  const int x = blockIdx.x * kTile + threadIdx.x % kTile;
  // std >= 0, so its bits order as the floats do
  if (y < h && x < w) atomicMax(&best, __float_as_int(std));
  __syncthreads();
  if (threadIdx.x == 0) atomicMax(&stdmax[blockIdx.z], best);
}

__global__ void __launch_bounds__(kThreads)
binarize_kernel(const float* __restrict__ img, const int* __restrict__ stdmax,
                uint8_t* __restrict__ out, int h, int w, int win, float tap,
                float k, int otsu) {
  __shared__ Tile s;
  __shared__ unsigned int hist[256];
  __shared__ float scan[2][2][256];   // [omega | mu][ping | pong][bin]
  __shared__ float red[32];
  __shared__ float best_v[8];
  __shared__ int best_i[8];
  float mean, std, pixel;
  mean_std(s, img + (size_t)blockIdx.z * h * w, h, w, win, tap, &mean, &std,
           &pixel);
  const int y = blockIdx.y * kTile + threadIdx.x / kTile;
  const int x = blockIdx.x * kTile + threadIdx.x % kTile;

  const float smax = __fadd_rn(__int_as_float(stdmax[blockIdx.z]), 1e-6f);
  const float std_n = __fdiv_rn(std, smax);
  const float k_map = __fmul_rn(k, __fsub_rn(1.0f, __fmul_rn(0.5f, std_n)));
  const float rel = __fsub_rn(1.0f, __fdiv_rn(std, __fadd_rn(mean, 1e-6f)));
  const float sauv = __fmul_rn(mean, __fsub_rn(1.0f, __fmul_rn(k_map, rel)));
  bool on = pixel < sauv;

  if (otsu) {  // the wrapper guarantees whole tiles here
    const int t = threadIdx.x;
    if (t < 256) hist[t] = 0u;
    __syncthreads();
    const float bin = fminf(fmaxf(rintf(__fmul_rn(pixel, 255.0f)), 0.0f), 255.0f);
    atomicAdd(&hist[(int)bin], 1u);
    __syncthreads();
    // omega = cumsum(p), mu = cumsum(p * bin), p = count / 1024: exact
    const float area = (float)kThreads;
    if (t < 256) {
      const float p = __fdiv_rn((float)hist[t], area);
      scan[0][0][t] = p;
      scan[1][0][t] = __fmul_rn(p, (float)t);
    }
    int cur = 0;
    for (int off = 1; off < 256; off <<= 1) {
      __syncthreads();
      if (t < 256) {
        float o = scan[0][cur][t], m = scan[1][cur][t];
        if (t >= off) {
          o = __fadd_rn(o, scan[0][cur][t - off]);
          m = __fadd_rn(m, scan[1][cur][t - off]);
        }
        scan[0][cur ^ 1][t] = o;
        scan[1][cur ^ 1][t] = m;
      }
      cur ^= 1;
    }
    __syncthreads();
    // first argmax of the between-class variance over the 256 bins
    if (t < 256) {
      const float omega = scan[0][cur][t], mu = scan[1][cur][t];
      const float mu_t = scan[1][cur][255];
      const float denom = __fmul_rn(omega, __fsub_rn(1.0f, omega));
      float sig = 0.0f;
      if (denom > 1e-8f) {
        const float d = __fsub_rn(__fmul_rn(mu_t, omega), mu);
        sig = __fdiv_rn(__fmul_rn(d, d), fmaxf(denom, 1e-8f));
      }
      int idx = t;
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, sig, off);
        const int oi = __shfl_xor_sync(0xffffffffu, idx, off);
        if (ov > sig || (ov == sig && oi < idx)) {
          sig = ov;
          idx = oi;
        }
      }
      if ((t & 31) == 0) {
        best_v[t >> 5] = sig;
        best_i[t >> 5] = idx;
      }
    }
    __syncthreads();
    int arg = best_i[0];
    float top = best_v[0];
    for (int g = 1; g < 8; ++g)
      if (best_v[g] > top) {  // strict: the earlier group keeps a tie
        top = best_v[g];
        arg = best_i[g];
      }
    const float thr = __fdiv_rn((float)arg, 255.0f);
    // centred two-pass standard deviation of the patch
    const float pm = __fdiv_rn(block_sum(pixel, red), area);
    const float cd = __fsub_rn(pixel, pm);
    const float pvar = __fdiv_rn(block_sum(__fmul_rn(cd, cd), red), area);
    const float p_std = __fsqrt_rn(pvar);
    on = on || (pixel < thr && p_std >= (float)(3.0 / 255.0));
  }
  if (y < h && x < w) out[((size_t)blockIdx.z * h + y) * w + x] = on ? 1 : 0;
}

}  // namespace

// img: (nb, h, w) float32 in [0, 1]; stdmax: (nb,) int32 scratch, zeroed by
// the caller; out: (nb, h, w) uint8 0/1. win odd <= 33; tap = float32(1/win).
// otsu != 0 adds the patch-Otsu refinement and needs h, w multiples of 32.
extern "C" int mbfp_binarize_front(const float* img, int* stdmax, uint8_t* out,
                                   int nb, int h, int w, int win, float tap,
                                   float k, int otsu, cudaStream_t stream) {
  if (win < 1 || win > kMaxWin || !(win & 1) || nb < 1 || nb > 65535 ||
      h < 1 || w < 1 || (otsu && (h % kTile || w % kTile)))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((w + kTile - 1) / kTile, (h + kTile - 1) / kTile, nb);
  std_max_kernel<<<grid, kThreads, 0, stream>>>(img, stdmax, h, w, win, tap);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  binarize_kernel<<<grid, kThreads, 0, stream>>>(img, stdmax, out, h, w, win,
                                                 tap, k, otsu);
  return (int)cudaGetLastError();
}
