// Kernel I: the RANSAC matcher's per-pair statistics and hypothesis
// sampling, one launch a call.
//
// Replaces no TPU kernel. The JAX package leaves the statistics and the
// sampling (matching/ransac.py: the descriptor weights, the counts, the
// spatial-std reject, and the weight-proportional pick of an A and a
// same-type B minutia a hypothesis) to XLA. PyTorch runs the plain route
// (matching/ransac.py: _pair_stats, then sample_hypotheses, the twin of
// this kernel) op by op: about 170 device operations a call, among them a
// float cumsum over (P, H, K) candidate weights, a 311-MB temporary at
// P = 4,050, H = 300, K = 64, which the card scans with a 512-thread block
// a row.
//
// Bound: bytes. A call reads the pairs' seven (P, K) planes of A and of B
// and the (H, 2) uniforms, and writes the weights, the per-pair statistics
// and the (P, H) angles, translations and candidate flags: about 25 MB at
// the shape above, 8 us at 3.35 TB/s; the operations (two first-hit
// searches of at most K steps and a double cos and sin a hypothesis) take
// less. The plain route's temporaries are what cost: the candidate weights
// depend on a hypothesis only through A's sampled type, so a pair's H rows
// are in truth two. One block a pair: a thread an A and a B slot for the
// statistics, the pair's A scan and its two B scans in shared memory, then
// the threads over the H hypotheses, each searching the scans it needs.
//
// Every rounding is the plain route's on the card:
// - float32 products, sums and differences one at a time (__fmul_rn,
//   __fadd_rn, __fsub_rn, __fsqrt_rn) and __fmaf_rn exactly where the twin's
//   _fma stands, so nvcc contracts nothing the twin does not; a Python
//   number in a float32 tensor operation is its float32 rounding;
// - the counts' and coordinates' means as float64 sums over the count in
//   float64, rounded to float32 (the twin's _sum64); a float64 sum adds its
//   <= K terms in another order than PyTorch's reduction, the one departure;
// - cos and sin in double, rounded to float32; the sampled angle through
//   wrap_angle.cuh;
// - the cumulative weights in torch.cumsum's order on the card, which
//   depends on the scan's row count (scan_row below). The wrapper computes
//   it from P, H and K as PyTorch's launcher does, and passes the leaves a
//   block scans at once: P rows for A's scan, P H rows for B's.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "wrap_angle.cuh"

namespace {

constexpr int kMaxK = 128;
constexpr int kThreads = 128;             // one A and one B slot a thread
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// Sums N float64 values over the block; every thread gets the totals: a
// warp's xor tree, then the warps' partials in warp order.
template <int N>
__device__ __forceinline__ void block_sum(double (&v)[N],
                                          double (*scratch)[kWarps]) {
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int r = 0; r < N; ++r)
    for (int off = 16; off > 0; off >>= 1)
      v[r] = __dadd_rn(v[r], __shfl_xor_sync(kFull, v[r], off));
  __syncthreads();                          // scratch free
  if ((threadIdx.x & 31) == 0)
#pragma unroll
    for (int r = 0; r < N; ++r) scratch[r][warp] = v[r];
  __syncthreads();
#pragma unroll
  for (int r = 0; r < N; ++r) {
    double s = scratch[r][0];
    for (int w = 1; w < kWarps; ++w) s = __dadd_rn(s, scratch[r][w]);
    v[r] = s;
  }
}

// The twin's float32 mean of the terms where the mask holds: a float64
// sum over clamp(count, 1) in float64, rounded to float32.
__device__ __forceinline__ float mean32(double sum, int count) {
  return __double2float_rn(__ddiv_rn(sum, (double)max(count, 1)));
}

// compute_descriptor_weights for one slot: where(valid, clamp(bonus *
// ((0.5 q + 0.3 coh) + 0.2 angs), 0.05, 2), 0), bonus 1.25 for type 1;
// PyTorch's clamp passes a NaN through.
__device__ __forceinline__ float weight(int type, float q, float coh,
                                        float angs, bool valid) {
  const float base = __fadd_rn(
      __fadd_rn(__fmul_rn(0.5f, q), __fmul_rn(0.3f, coh)),
      __fmul_rn(0.2f, angs));
  const float w = __fmul_rn(type == 1 ? 1.25f : 1.0f, base);
  const float c = isnan(w) ? w : fminf(fmaxf(w, 0.05f), 2.0f);
  return valid ? c : 0.0f;
}

// A tensor of one row: PyTorch hands it to cub::DeviceScan::InclusiveScan.
// Its order, read from the card's results (1,200 rows of 32, 64 and 128
// leaves, every one bit-equal): 15 consecutive leaves a thread, each
// thread's leaves summed in order, the threads' sums scanned across the
// warp by shuffles at offsets 1, 2, 4, 8, then each thread's leaves added
// in order onto the scanned sum of the threads before it.
constexpr int kCubItems = 15;

__device__ void cub_scan_row(float* x, int k) {
  float inc[(kMaxK + kCubItems - 1) / kCubItems];
  const int n = (k + kCubItems - 1) / kCubItems;
  for (int t = 0; t < n; ++t) {
    const int hi = min((t + 1) * kCubItems, k);
    float s = x[t * kCubItems];
    for (int j = t * kCubItems + 1; j < hi; ++j) s = __fadd_rn(s, x[j]);
    inc[t] = s;
  }
  for (int off = 1; off < n; off <<= 1)     // downwards: last step's values
    for (int t = n - 1; t >= off; --t) inc[t] = __fadd_rn(inc[t - off], inc[t]);
  for (int t = 0; t < n; ++t) {
    const int lo = t * kCubItems, hi = min(lo + kCubItems, k);
    float r = t ? __fadd_rn(inc[t - 1], x[lo]) : x[lo];
    x[lo] = r;
    for (int j = lo + 1; j < hi; ++j) x[j] = r = __fadd_rn(r, x[j]);
  }
}

// torch.cumsum of one row of k leaves, in place, in the order the card's
// PyTorch adds them (ATen/native/cuda/ScanUtils.cuh,
// tensor_kernel_scan_innermost_dim; held to torch.cumsum on the card at
// 1 to 1,228,800 rows of 32, 64 and 128 leaves by tools/sample_check.py).
// A block scans 2 N leaves at once, N = 2^get_log_num_threads_x_inner_scan(
// rows, k), which the launcher computes in unsigned arithmetic: at K = 64,
// 2 N is 128 or 256 up to 8 rows, 64 up to 32, 32 from 33 to 32,768 rows
// (the subtraction wraps and the clamp takes the floor, 16 threads) and
// 1,024 beyond (it wraps past the clamp's ceiling, 512 threads). The row
// goes in chunks of min(2 N, k) leaves, the running total added into each
// chunk's first leaf, then a Sklansky tree over the chunk (at level s every
// leaf with bit s of its index set adds the last leaf of the half block
// before it). `chunk` is that 2 N; 0 for a tensor of one row (cub).
__device__ void scan_row(float* x, int k, int chunk) {
  if (chunk <= 0) {
    cub_scan_row(x, k);
    return;
  }
  const int c = min(chunk, k);
  for (int c0 = 0; c0 < k; c0 += c) {
    float* r = x + c0;
    if (c0) r[0] = __fadd_rn(r[0], r[-1]);
    for (int s = 1; s < c; s <<= 1)
      for (int base = 0; base < c; base += 2 * s) {
        const float left = r[base + s - 1];
        for (int j = 0; j < s; ++j)
          r[base + s + j] = __fadd_rn(r[base + s + j], left);
      }
  }
}

// The twin's _first_hit: the first index whose cumulative weight exceeds
// thr or reaches the total (u * total can round up to the total); 0 where
// neither holds anywhere (a NaN), as torch.argmax of an all-zero row.
__device__ __forceinline__ int first_hit(const float* cdf, int k, float thr,
                                         float total) {
  for (int l = 0; l < k; ++l)
    if (cdf[l] > thr || cdf[l] >= total) return l;
  return 0;
}

__global__ void __launch_bounds__(kThreads) sample_kernel(
    const float* __restrict__ a_xy, const int* __restrict__ a_type,
    const float* __restrict__ a_ori, const float* __restrict__ a_q,
    const float* __restrict__ a_coh, const float* __restrict__ a_angs,
    const uint8_t* __restrict__ a_valid, const float* __restrict__ b_xy,
    const int* __restrict__ b_type, const float* __restrict__ b_ori,
    const float* __restrict__ b_q, const float* __restrict__ b_coh,
    const float* __restrict__ b_angs, const uint8_t* __restrict__ b_valid,
    const float* __restrict__ u, float* __restrict__ wa,
    float* __restrict__ wb, int* __restrict__ na, int* __restrict__ nb,
    float* __restrict__ possible, uint8_t* __restrict__ reject,
    float* __restrict__ theta, float* __restrict__ t,
    float* __restrict__ has_cand, int h_total, int k, int chunk_a,
    int chunk_b) {
  __shared__ float sax[kMaxK], say[kMaxK], sao[kMaxK];
  __shared__ int sat[kMaxK];
  __shared__ float sbx[kMaxK], sby[kMaxK], sbo[kMaxK], sbw[kMaxK];
  __shared__ int sbt[kMaxK];
  // A's cumulative weights; B's over the candidates of type 0 and type 1
  __shared__ float scdf[3][kMaxK];
  __shared__ double sred[6][kWarps];

  const int pair = blockIdx.x, i = threadIdx.x;
  const bool live = i < k;

  // 1. one A and one B slot a thread: the weights, staged and written
  float ax = 0.0f, ay = 0.0f, bx = 0.0f, by = 0.0f, w_a = 0.0f, w_b = 0.0f;
  bool av = false, bv = false;
  if (live) {
    const size_t o = (size_t)pair * k + i;
    ax = a_xy[2 * o];
    ay = a_xy[2 * o + 1];
    av = a_valid[o] != 0;
    const int at = a_type[o];
    w_a = weight(at, a_q[o], a_coh[o], a_angs[o], av);
    sax[i] = ax;
    say[i] = ay;
    sao[i] = a_ori[o];
    sat[i] = at;
    scdf[0][i] = w_a;
    wa[o] = w_a;
    bx = b_xy[2 * o];
    by = b_xy[2 * o + 1];
    bv = b_valid[o] != 0;
    const int bt = b_type[o];
    w_b = weight(bt, b_q[o], b_coh[o], b_angs[o], bv);
    sbx[i] = bx;
    sby[i] = by;
    sbo[i] = b_ori[o];
    sbt[i] = bt;
    sbw[i] = w_b;
    scdf[1][i] = bt == 0 ? w_b : 0.0f;
    scdf[2][i] = bt == 1 ? w_b : 0.0f;
    wb[o] = w_b;
  }
  const int n_a = __syncthreads_count(live && av);   // also publishes
  const int n_b = __syncthreads_count(live && bv);

  // 2. the scans, one thread a row, in three warps
  if (i == 0) scan_row(scdf[0], k, chunk_a);
  else if (i == 32) scan_row(scdf[1], k, chunk_b);
  else if (i == 64) scan_row(scdf[2], k, chunk_b);

  // 3. the statistics: the weights' sums, the valid minutiae's centroids,
  // then their spreads (the twin's _spatial_std)
  double s[6] = {(double)w_a, (double)w_b, av ? (double)ax : 0.0,
                 av ? (double)ay : 0.0, bv ? (double)bx : 0.0,
                 bv ? (double)by : 0.0};
  block_sum(s, sred);                       // its barriers end the scans
  const float mxa = mean32(s[2], n_a), mya = mean32(s[3], n_a);
  const float mxb = mean32(s[4], n_b), myb = mean32(s[5], n_b);
  const float dxa = __fsub_rn(ax, mxa), dya = __fsub_rn(ay, mya);
  const float dxb = __fsub_rn(bx, mxb), dyb = __fsub_rn(by, myb);
  double v[4] = {av ? (double)__fmul_rn(dxa, dxa) : 0.0,
                 av ? (double)__fmul_rn(dya, dya) : 0.0,
                 bv ? (double)__fmul_rn(dxb, dxb) : 0.0,
                 bv ? (double)__fmul_rn(dyb, dyb) : 0.0};
  block_sum(v, sred);
  if (i == 0) {
    const float ex = __fsub_rn(__fsqrt_rn(mean32(v[0], n_a)),
                               __fsqrt_rn(mean32(v[2], n_b)));
    const float ey = __fsub_rn(__fsqrt_rn(mean32(v[1], n_a)),
                               __fsqrt_rn(mean32(v[3], n_b)));
    const float gap = __fsqrt_rn(__fadd_rn(__fmul_rn(ex, ex),
                                           __fmul_rn(ey, ey)));
    // torch.minimum of the float64 sums: a NaN wins
    const double lo = (s[0] < s[1] || isnan(s[0])) ? s[0] : s[1];
    na[pair] = n_a;
    nb[pair] = n_b;
    possible[pair] = __double2float_rn(lo);
    reject[pair] = n_a < 8 || n_b < 8 || gap > 35.0f;
  }

  // 4. a hypothesis a thread: A's slot, then B's among the candidates of
  // its type (a type other than 0 or 1 scans its own row), the angle
  // bori - aori wrapped and t = b - R(theta) a + 0
  const float total_a = scdf[0][k - 1];
  for (int h = i; h < h_total; h += kThreads) {
    const int ia = first_hit(scdf[0], k, __fmul_rn(u[2 * h], total_a),
                             total_a);
    const int at = sat[ia];
    const float* cdf_b;
    float own[kMaxK];
    if (at == 0 || at == 1) {
      cdf_b = scdf[1 + at];
    } else {
      for (int j = 0; j < k; ++j) own[j] = sbt[j] == at ? sbw[j] : 0.0f;
      scan_row(own, k, chunk_b);
      cdf_b = own;
    }
    const float total_b = cdf_b[k - 1];
    const int ib = first_hit(cdf_b, k, __fmul_rn(u[2 * h + 1], total_b),
                             total_b);
    const float th = wrap_angle(__fsub_rn(sbo[ib], sao[ia]));
    const float c = __double2float_rn(cos((double)th));
    const float sn = __double2float_rn(sin((double)th));
    const float rx = __fadd_rn(
        __fmaf_rn(c, sax[ia], -__fmul_rn(sn, say[ia])), 0.0f);
    const float ry = __fadd_rn(
        __fmaf_rn(sn, sax[ia], __fmul_rn(c, say[ia])), 0.0f);
    const size_t o = (size_t)pair * h_total + h;
    theta[o] = th;
    t[2 * o] = __fsub_rn(sbx[ib], rx);
    t[2 * o + 1] = __fsub_rn(sby[ib], ry);
    has_cand[o] = total_b > 0.0f ? 1.0f : 0.0f;
  }
}

}  // namespace

// The matcher's tensors as it holds them, all contiguous: a_*/b_* are the
// (P, K) fields of the A and B templates in MinutiaeSet's order (xy (P, K,
// 2) float32, type int32, orientation, quality, coherence and angular
// stability float32, valid bool); u the (H, 2) float32 uniforms. Writes wa,
// wb (P, K) float32; na, nb (P,) int32; possible (P,) float32; reject (P,)
// bool; theta (P, H) float32, t (P, H, 2) float32 and has_cand (P, H)
// float32. K <= 128, a power of two; P >= 1, H >= 0. chunk_a and chunk_b:
// the leaves a block of the card's torch.cumsum scans at once for A's scan
// (P rows) and B's (P H rows), 0 for a scan of one row.
extern "C" int mbfp_sample_hypotheses(
    const float* a_xy, const int* a_type, const float* a_ori,
    const float* a_q, const float* a_coh, const float* a_angs,
    const uint8_t* a_valid, const float* b_xy, const int* b_type,
    const float* b_ori, const float* b_q, const float* b_coh,
    const float* b_angs, const uint8_t* b_valid, const float* u, float* wa,
    float* wb, int* na, int* nb, float* possible, uint8_t* reject,
    float* theta, float* t, float* has_cand, int p, int h, int k,
    int chunk_a, int chunk_b, cudaStream_t stream) {
  if (k <= 0 || k > kMaxK || (k & (k - 1)) || p <= 0 || h < 0)
    return (int)cudaErrorInvalidValue;
  sample_kernel<<<p, kThreads, 0, stream>>>(
      a_xy, a_type, a_ori, a_q, a_coh, a_angs, a_valid, b_xy, b_type, b_ori,
      b_q, b_coh, b_angs, b_valid, u, wa, wb, na, nb, possible, reject, theta,
      t, has_cand, h, k, chunk_a, chunk_b);
  return (int)cudaGetLastError();
}

namespace {

// The scans alone, for holding their order to torch.cumsum: out (rows, k)
// float32 gets the cumulative sums of x (rows, k) along each row, in kernel
// I's order for the given chunk (a thread a row). Not on the matcher's path.
__global__ void scan_rows_kernel(const float* __restrict__ x,
                                 float* __restrict__ out, int rows, int k,
                                 int chunk) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  float* o = out + (size_t)r * k;
  for (int j = 0; j < k; ++j) o[j] = x[(size_t)r * k + j];
  scan_row(o, k, chunk);
}

}  // namespace

extern "C" int mbfp_scan_rows(const float* x, float* out, int rows, int k,
                              int chunk, cudaStream_t stream) {
  if (k <= 0 || k > kMaxK || rows <= 0) return (int)cudaErrorInvalidValue;
  scan_rows_kernel<<<(rows + 127) / 128, 128, 0, stream>>>(x, out, rows, k,
                                                          chunk);
  return (int)cudaGetLastError();
}
