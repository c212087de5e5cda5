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
// so there are two launches. The first takes the box mean and the std of
// every pixel once, writes both to scratch (8 bytes a pixel: written and
// read once, a small part of the time a second filtering pass would cost)
// and folds the image's max(std) into one word with atomicMax on the
// non-negative float's bits. The second reads pixel, mean and std,
// thresholds and, for the hybrid form, takes the Otsu half of each 32x32
// patch in one warp.
//
// Launch 1 is bound by the instruction rate, so its loops hold only what the
// twin's order of roundings forces. The twin's separable filter sums win
// products tap*element in tap order, vertical pass first, over the numpy-
// "symmetric" border. Every product is of one element with the constant
// tap, so fl(tap*a), fl(tap*fl(a*a)) and, after the vertical pass,
// fl(tap*v) are formed once for each element a thread loads, and the
// thread forms kR neighbouring outputs along the filtered axis from the
// kR + win - 1 elements it loads once, as kR independent add chains, each
// in tap order: one load for kR outputs and two adds a tap. A block owns
// kRegH x kRegW outputs. The vertical pass reads its columns straight from
// device memory (a warp reads 32 neighbouring columns of a row, and the
// rows a block reads again come from L1), so the shared memory holds only
// the plane of vertical sums, stored as float2 (tap*sum of x, tap*sum of
// x*x), and the block's outputs, and four blocks share an SM. The
// horizontal pass runs with the warp's lanes along the rows, on a row pitch
// that is 1 mod 16 float2, so its 64-bit loads meet no bank conflict; its
// outputs go through shared memory so that the stores to device memory run
// along the rows (stored from the registers, 32 rows a warp, they took more
// time than the adds). No sliding window and no tensor-core product: either
// would change the order or the rounding of the sums, and `x < sauv` is a
// knife-edge float32 compare. Every multiply, add, divide and square root
// is an explicitly rounded intrinsic, so nvcc contracts nothing into an
// fma. The order-preserving sum costs about 115 adds a pixel where the
// bound counts the function's 215 operations at the card's peak rate, so
// this form cannot reach half of it. A window other than 25 takes the same
// kernel with its loops not unrolled (slower).
//
// Launch 2, Sauvola alone: elementwise, four pixels a thread. Hybrid form:
// a block a patch, a warp eight of its rows, a lane a column. The 256-bin
// histogram is the block's, in shared memory; omega and mu are prefix sums
// of multiples of 1/1024 below 256, exact in float32 in any order, so
// eight bins a lane and a shuffle scan (taken by every warp) give the
// twin's bits; the argmax of the between-class variance keeps the first
// maximum. Only the patch mean and variance (sums of 1,024 floats) are
// taken in another order than the twin's: rows by a butterfly over the
// lanes, then the 32 row sums by a butterfly.
//
// Bound: operations. A pixel costs 4*win multiply-adds for the two separable
// box means against 5 bytes of traffic.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kPatch = 32;      // Otsu patch side
constexpr int kMaxWin = 33;
constexpr int kRegH = 32;       // rows of the region a block of launch 1 owns
constexpr int kRegW = 64;       // its columns
constexpr int kR = 8;           // outputs a thread forms along the filtered axis
constexpr int kThreads = 256;   // launch 1
constexpr int kWarps2 = 4;      // launch 2, hybrid form: warps a patch
constexpr int kRows2 = kPatch / kWarps2;    // rows of the patch a warp
constexpr unsigned kFull = 0xffffffffu;

static_assert(kRegH % kR == 0 && kRegW % kR == 0 && kRegH % 32 == 0,
              "a warp of the horizontal pass spans 32 rows");

// numpy "symmetric": -1 -> 0, n -> n - 1.
__device__ __forceinline__ int fold(int j, int n) {
  while (j < 0 || j >= n) j = j < 0 ? -1 - j : 2 * n - 1 - j;
  return j;
}

// Row pitch of the vertical sums in float2: the least p >= span, p % 16 == 1.
__host__ __device__ constexpr int pitch_of(int span) {
  return (span + 14) / 16 * 16 + 1;
}

constexpr int kOutPitch = kRegW + 1;   // odd: lanes along rows meet no conflict

__host__ __device__ constexpr size_t smem_bytes(int win) {
  return (size_t)kRegH * pitch_of(kRegW + win - 1) * sizeof(float2) +
         (size_t)2 * kRegH * kOutPitch * sizeof(float);
}

// Step j of kR box sums along one axis, each over win pre-multiplied
// elements in tap order: element j, loaded once, is added to every output
// i whose window [i, i + win) holds it.
__device__ __forceinline__ void add_element(int j, int win, float vx, float vy,
                                            float (&m)[kR], float (&q)[kR]) {
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    if (j == i) {
      m[i] = vx;
      q[i] = vy;
    } else if (j > i && j - i < win) {
      m[i] = __fadd_rn(m[i], vx);
      q[i] = __fadd_rn(q[i], vy);
    }
  }
}

// Vertical sums of rows top .. top + kR - 1 of image column col, read from
// device memory (a warp reads 32 neighbouring columns of a row). FOLD: the
// rows may leave the image.
template <int WIN, bool FOLD>
__device__ __forceinline__ void vertical_sums(const float* __restrict__ src,
                                              int col, int top, int h, int w,
                                              int win_rt, float tap,
                                              float (&m)[kR], float (&q)[kR]) {
  const int win = WIN ? WIN : win_rt;
#pragma unroll
  for (int j = 0; j < kR + win - 1; ++j) {
    const int y = FOLD ? fold(top + j, h) : top + j;
    const float a = src[y * w + col];
    add_element(j, win, __fmul_rn(tap, a), __fmul_rn(tap, __fmul_rn(a, a)), m,
                q);
  }
}

// Box mean and std of the rh x rw region at (y0, x0) of the image src, by
// all nthreads threads of the block, into out_mean and out_std (shared
// memory, [rh][out_pitch]; an odd pitch meets no bank conflict). sv: shared
// memory, [rh][pitch_of(rw + win - 1)]. rh: 16 or a multiple of 32, and of
// kR; rw: a multiple of kR. Holds one block barrier; the caller places
// another before it reads the outputs. Returns the bits of the largest std
// among the thread's outputs that lie inside the image (std >= 0, so the
// bits order as the floats do).
template <int WIN>
__device__ __forceinline__ int region_mean_std(
    const float* __restrict__ src, int h, int w, int y0, int x0, int rh,
    int rw, int win_rt, float tap, float2* sv, float* out_mean, float* out_std,
    int out_pitch, int nthreads) {
  const int win = WIN ? WIN : win_rt;
  const int c = win / 2;
  const int span_w = rw + win - 1;
  const int pitch = pitch_of(span_w);
  const int tid = threadIdx.x;

  // vertical pass: a thread takes kR rows of one column of the region and
  // its halo
  const bool inside = y0 - c >= 0 && y0 + rh + c <= h;
  for (int task = tid; task < span_w * (rh / kR); task += nthreads) {
    const int ix = task % span_w, r0 = task / span_w * kR;
    const int col = fold(x0 - c + ix, w);
    float m[kR], q[kR];
    if (inside)
      vertical_sums<WIN, false>(src, col, y0 - c + r0, h, w, win_rt, tap, m, q);
    else
      vertical_sums<WIN, true>(src, col, y0 - c + r0, h, w, win_rt, tap, m, q);
#pragma unroll
    for (int i = 0; i < kR; ++i)
      sv[(r0 + i) * pitch + ix] =
          make_float2(__fmul_rn(tap, m[i]), __fmul_rn(tap, q[i]));
  }
  __syncthreads();

  // horizontal pass: a thread takes kR columns of one row, lanes along rows
  int top = 0;
  for (int task = tid; task < rh * (rw / kR); task += nthreads) {
    const int row = task % rh, c0 = task / rh * kR;
    float m[kR], q[kR];
    const float2* p = sv + row * pitch + c0;
#pragma unroll
    for (int j = 0; j < kR + win - 1; ++j) add_element(j, win, p[j].x, p[j].y, m, q);
    const int y = y0 + row, x = x0 + c0;
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const float sd =
          __fsqrt_rn(fmaxf(__fsub_rn(q[i], __fmul_rn(m[i], m[i])), 0.0f));
      out_mean[row * out_pitch + c0 + i] = m[i];
      out_std[row * out_pitch + c0 + i] = sd;
      if (y < h && x + i < w) top = max(top, __float_as_int(sd));
    }
  }
  return top;
}

// Launch 1. WIN: the window at compile time (the add chains unroll fully),
// or 0 for any odd window up to kMaxWin.
template <int WIN>
__global__ void __launch_bounds__(kThreads, WIN ? 4 : 1)
mean_std_kernel(const float* __restrict__ img, float* __restrict__ mean,
                float* __restrict__ stdv, int* __restrict__ stdmax, int h,
                int w, int win_rt, float tap) {
  extern __shared__ float2 sv[];
  __shared__ int best;
  const int win = WIN ? WIN : win_rt;
  float* out_mean =
      reinterpret_cast<float*>(sv + kRegH * pitch_of(kRegW + win - 1));
  float* out_std = out_mean + kRegH * kOutPitch;
  const int tid = threadIdx.x;
  const int x0 = blockIdx.x * kRegW, y0 = blockIdx.y * kRegH;
  const size_t plane = (size_t)blockIdx.z * h * w;
  if (tid == 0) best = 0;
  int top = region_mean_std<WIN>(img + plane, h, w, y0, x0, kRegH, kRegW,
                                 win_rt, tap, sv, out_mean, out_std, kOutPitch,
                                 kThreads);
  __syncthreads();
  // out of shared memory, so that the stores run along the rows
  for (int i = tid; i < kRegH * kRegW; i += kThreads) {
    const int row = i / kRegW, col = i % kRegW;
    const int y = y0 + row, x = x0 + col;
    if (y < h && x < w) {
      const size_t at = plane + (size_t)y * w + x;
      mean[at] = out_mean[row * kOutPitch + col];
      stdv[at] = out_std[row * kOutPitch + col];
    }
  }
  top = __reduce_max_sync(kFull, top);
  if ((tid & 31) == 0) atomicMax(&best, top);
  __syncthreads();
  if (tid == 0) atomicMax(&stdmax[blockIdx.z], best);
}

// The Sauvola decision of one pixel, in the twin's rounded operations.
__device__ __forceinline__ bool sauvola_on(float pixel, float mean, float std,
                                           float smax, float k) {
  const float std_n = __fdiv_rn(std, smax);
  const float k_map = __fmul_rn(k, __fsub_rn(1.0f, __fmul_rn(0.5f, std_n)));
  const float rel = __fsub_rn(1.0f, __fdiv_rn(std, __fadd_rn(mean, 1e-6f)));
  const float sauv = __fmul_rn(mean, __fsub_rn(1.0f, __fmul_rn(k_map, rel)));
  return pixel < sauv;
}

// Launch 2, Sauvola alone: any frame; a thread takes four neighbouring
// pixels where the plane's size allows vector loads, else one.
template <int N>
__global__ void __launch_bounds__(256)
sauvola_kernel(const float* __restrict__ img, const float* __restrict__ mean,
               const float* __restrict__ stdv, const int* __restrict__ stdmax,
               uint8_t* __restrict__ out, int npix, float k) {
  const int i = (blockIdx.x * 256 + threadIdx.x) * N;
  if (i >= npix) return;
  const size_t at = (size_t)blockIdx.y * npix + i;
  const float smax = __fadd_rn(__int_as_float(stdmax[blockIdx.y]), 1e-6f);
  if (N == 4) {
    const float4 x = *reinterpret_cast<const float4*>(img + at);
    const float4 m = *reinterpret_cast<const float4*>(mean + at);
    const float4 s = *reinterpret_cast<const float4*>(stdv + at);
    *reinterpret_cast<uchar4*>(out + at) = make_uchar4(
        sauvola_on(x.x, m.x, s.x, smax, k), sauvola_on(x.y, m.y, s.y, smax, k),
        sauvola_on(x.z, m.z, s.z, smax, k), sauvola_on(x.w, m.w, s.w, smax, k));
  } else {
    out[at] = sauvola_on(img[at], mean[at], stdv[at], smax, k) ? 1 : 0;
  }
}

// Sums over the lanes of the kRows2 rows a warp holds (v[i]: this lane's
// column of the warp's row i; v is used up). The additions of a row are
// those of a butterfly over the lanes (offsets 16, 8, 4, 2, 1); while more
// than one row is left the rows are folded as the lanes are, so one shuffle
// serves a row at every step. Lane l ends with the sum of row
// l / (32 / kRows2).
__device__ __forceinline__ float row_sums(float (&v)[kRows2], int lane) {
  int off = 16;
#pragma unroll
  for (int half = kRows2 / 2; half > 0; half >>= 1, off >>= 1) {
    const bool upper = lane & off;
#pragma unroll
    for (int i = 0; i < half; ++i) {
      const float keep = upper ? v[i + half] : v[i];
      const float send = upper ? v[i] : v[i + half];
      v[i] = __fadd_rn(keep, __shfl_xor_sync(kFull, send, off));
    }
  }
  float sum = v[0];
#pragma unroll
  for (; off > 0; off >>= 1)
    sum = __fadd_rn(sum, __shfl_xor_sync(kFull, sum, off));
  return sum;
}

// Sum over the block's 32 x 32 patch, to every thread: the warps' row sums
// through `rows` (32 floats), then a butterfly over the 32 rows.
__device__ __forceinline__ float patch_sum(float (&v)[kRows2], float* rows,
                                           int lane, int warp) {
  const float mine = row_sums(v, lane);
  constexpr int kLanesRow = 32 / kRows2;
  if (lane % kLanesRow == 0) rows[warp * kRows2 + lane / kLanesRow] = mine;
  __syncthreads();
  float sum = rows[lane];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sum = __fadd_rn(sum, __shfl_xor_sync(kFull, sum, off));
  return sum;
}

// The gated Otsu threshold of a 32 x 32 patch, by the kWarps2 warps that
// hold it (pix[r]: this lane's column of the warp's row r; t: the thread's
// index among them; sub: its warp's): the patch's threshold where the patch
// std reaches 3/255, else -inf, which no pixel is below. hist: 256 words
// and rows: 2 x 32 floats of shared memory, the patch's own. Holds three
// block barriers.
__device__ __forceinline__ float patch_threshold(const float (&pix)[kRows2],
                                                 unsigned int* hist,
                                                 float* rows, int t, int lane,
                                                 int sub) {
  for (int i = t; i < 256; i += kWarps2 * 32) hist[i] = 0u;
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kRows2; ++r) {
    const int bin = (int)fminf(
        fmaxf(rintf(__fmul_rn(pix[r], 255.0f)), 0.0f), 255.0f);
    atomicAdd(&hist[bin], 1u);
  }

  // centred two-pass standard deviation of the patch; the first barrier in
  // patch_sum also completes the histogram
  const float area = (float)(kPatch * kPatch);
  float dev[kRows2];
#pragma unroll
  for (int r = 0; r < kRows2; ++r) dev[r] = pix[r];
  const float pm = __fdiv_rn(patch_sum(dev, rows, lane, sub), area);
#pragma unroll
  for (int r = 0; r < kRows2; ++r) {
    const float cd = __fsub_rn(pix[r], pm);
    dev[r] = __fmul_rn(cd, cd);
  }
  const float p_std =
      __fsqrt_rn(__fdiv_rn(patch_sum(dev, rows + kPatch, lane, sub), area));
  if (!(p_std >= (float)(3.0 / 255.0))) return -INFINITY;

  // omega = cumsum(p), mu = cumsum(p * bin), p = count / 1024: exact. Every
  // warp takes the whole scan, eight bins a lane.
  constexpr int kPer = 256 / 32;
  float om[kPer], mu[kPer], so = 0.0f, sm = 0.0f;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int bin = lane * kPer + j;
    const float p = __fdiv_rn((float)hist[bin], area);
    so = __fadd_rn(so, p);
    sm = __fadd_rn(sm, __fmul_rn(p, (float)bin));
    om[j] = so;
    mu[j] = sm;
  }
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(kFull, so, off);
    const float u = __shfl_up_sync(kFull, sm, off);
    if (lane >= off) {
      so = __fadd_rn(so, o);
      sm = __fadd_rn(sm, u);
    }
  }
  const float mu_t = __shfl_sync(kFull, sm, 31);
  float before_o = __shfl_up_sync(kFull, so, 1);
  float before_m = __shfl_up_sync(kFull, sm, 1);
  if (lane == 0) before_o = before_m = 0.0f;
  // first argmax of the between-class variance over the 256 bins
  float top = -1.0f;
  int arg = 0;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const float omega = __fadd_rn(before_o, om[j]);
    const float mu_j = __fadd_rn(before_m, mu[j]);
    const float denom = __fmul_rn(omega, __fsub_rn(1.0f, omega));
    float sig = 0.0f;
    if (denom > 1e-8f) {
      const float d = __fsub_rn(__fmul_rn(mu_t, omega), mu_j);
      sig = __fdiv_rn(__fmul_rn(d, d), fmaxf(denom, 1e-8f));
    }
    if (sig > top) {      // strict: the earlier bin keeps a tie
      top = sig;
      arg = lane * kPer + j;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(kFull, top, off);
    const int oi = __shfl_xor_sync(kFull, arg, off);
    if (ov > top || (ov == top && oi < arg)) {
      top = ov;
      arg = oi;
    }
  }
  return __fdiv_rn((float)arg, 255.0f);
}

// Launch 2, hybrid form: whole patches only; a block a patch, a warp
// kRows2 of its rows, a lane a column.
__global__ void __launch_bounds__(kWarps2 * 32)
sauvola_otsu_kernel(const float* __restrict__ img,
                    const float* __restrict__ mean,
                    const float* __restrict__ stdv,
                    const int* __restrict__ stdmax, uint8_t* __restrict__ out,
                    int h, int w, float k) {
  __shared__ unsigned int hist[256];
  __shared__ float rows[2 * kPatch];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int across = w / kPatch;
  const int py = blockIdx.x / across, px = blockIdx.x - py * across;
  const size_t at = (size_t)blockIdx.y * h * w +
                    (size_t)(py * kPatch + warp * kRows2) * w + px * kPatch +
                    lane;
  float pix[kRows2], m[kRows2], s[kRows2];
#pragma unroll
  for (int r = 0; r < kRows2; ++r) pix[r] = img[at + (size_t)r * w];
#pragma unroll
  for (int r = 0; r < kRows2; ++r) {
    m[r] = mean[at + (size_t)r * w];
    s[r] = stdv[at + (size_t)r * w];
  }
  const float thr = patch_threshold(pix, hist, rows, threadIdx.x, lane, warp);
  const float smax = __fadd_rn(__int_as_float(stdmax[blockIdx.y]), 1e-6f);
#pragma unroll
  for (int r = 0; r < kRows2; ++r)
    out[at + (size_t)r * w] =
        sauvola_on(pix[r], m[r], s[r], smax, k) || pix[r] < thr ? 1 : 0;
}

template <int WIN>
cudaError_t launch_mean_std(const float* img, float* mean, float* stdv,
                            int* stdmax, int nb, int h, int w, int win,
                            float tap, cudaStream_t stream) {
  const size_t bytes = smem_bytes(win);
  cudaError_t err = cudaFuncSetAttribute(
      mean_std_kernel<WIN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((w + kRegW - 1) / kRegW, (h + kRegH - 1) / kRegH, nb);
  mean_std_kernel<WIN><<<grid, kThreads, bytes, stream>>>(
      img, mean, stdv, stdmax, h, w, win, tap);
  return cudaGetLastError();
}

}  // namespace

// img: (nb, h, w) float32 in [0, 1]; mean, stdv: (nb, h, w) float32 scratch;
// stdmax: (nb,) int32 scratch, zeroed by the caller; out: (nb, h, w) uint8
// 0/1. win odd <= 33; tap = float32(1/win); h * w below 2^31. otsu != 0 adds
// the patch-Otsu refinement and needs h, w multiples of 32. Two device
// launches.
extern "C" int mbfp_binarize_front(const float* img, float* mean, float* stdv,
                                   int* stdmax, uint8_t* out, int nb, int h,
                                   int w, int win, float tap, float k,
                                   int otsu, cudaStream_t stream) {
  if (win < 1 || win > kMaxWin || !(win & 1) || nb < 1 || nb > 65535 ||
      h < 1 || w < 1 || (long long)h * w > 0x7fffffffLL ||
      (h + kRegH - 1) / kRegH > 65535 ||
      (otsu && (h % kPatch || w % kPatch)))
    return (int)cudaErrorInvalidValue;
  cudaError_t err =
      win == 25 ? launch_mean_std<25>(img, mean, stdv, stdmax, nb, h, w, win,
                                      tap, stream)
                : launch_mean_std<0>(img, mean, stdv, stdmax, nb, h, w, win,
                                     tap, stream);
  if (err != cudaSuccess) return (int)err;
  if (otsu) {
    const dim3 grid((h / kPatch) * (w / kPatch), nb);
    sauvola_otsu_kernel<<<grid, kWarps2 * 32, 0, stream>>>(
        img, mean, stdv, stdmax, out, h, w, k);
  } else {
    const int npix = h * w;
    if (npix % 4 == 0)
      sauvola_kernel<4><<<dim3((npix / 4 + 255) / 256, nb), 256, 0, stream>>>(
          img, mean, stdv, stdmax, out, npix, k);
    else
      sauvola_kernel<1><<<dim3((npix + 255) / 256, nb), 256, 0, stream>>>(
          img, mean, stdv, stdmax, out, npix, k);
  }
  return (int)cudaGetLastError();
}
