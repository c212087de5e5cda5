// Kernel D as it was before its redesign (one warp per hypothesis, rintf in
// the distance loop, inputs staged as feature planes by the wrapper). Kept
// for tools/match_variants.py and chip_smoke.py, which hold the shipped
// kernel's counts to this one's bit for bit; nothing in the port builds it.
//
// Replaces the TPU kernels matching/pallas_match.py:
// hypothesis_scores_pallas_grouped (_grouped_kernel), which scored G=64
// hypotheses per grid step in a (K, K*G) VMEM layout with roll-min
// butterflies and one-hot MXU extraction of the nearest neighbour's
// attributes, and hypothesis_scores_pallas (_match_kernel), one hypothesis
// per step; both compute the same outputs. Here the grid is
// (P, ceil(H/8)) with 256 threads: each warp scores one hypothesis of one
// pair. The pair's B minutiae (x, y, orientation, type, weight; invalid
// slots pre-displaced to -1e6) are staged in shared memory and read as
// broadcasts; lane l owns A minutiae i = l, l+32, ..., scans j = 0..K-1 for
// the smallest quantized distance q = min(rint(d2*256), 2^18-1), keeping the
// first j on ties (the unique minimum of q*K + j), then gates and scores i
// and the warp sums score and inlier count with shuffles.
//
// Bound: compute. A pair costs H*K^2 distance evaluations (1.2 M at
// H=300, K=64; 0.63 G per 512-pair chunk) against P*(10K + 4H)*4 bytes of
// input (about 7.4 KB per pair), so FP32 instruction throughput bounds it, not
// memory. Arithmetic follows the plain twin (matching/cuda_match.py:
// hypothesis_scores_plain) operation by operation: the transform and d2 use
// __fmaf_rn exactly where XLA contracts the TPU kernel's expressions into
// fused multiply-adds on the CPU (the twin emulates them, ransac._fma), and
// __fmul_rn/__fadd_rn keep nvcc from contracting anything else; rintf
// rounds half to even like torch.round and
// jnp.round, the angle wrap is fmodf plus the sign fix of jnp.mod /
// torch.remainder, cos and sin are taken in double and rounded to float,
// and expf/logf are the accurate versions (no --use_fast_math).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 8;          // hypotheses per block
constexpr int kMaxK = 128;
constexpr float kNnQ = 256.0f;
constexpr float kNnSat = 262143.0f;  // 2^18 - 1
constexpr float kPi = 3.14159265358979323846f;
constexpr float kTwoPi = 6.28318530717958647692f;

__device__ __forceinline__ float wrap_abs(float x) {
  // |jnp.mod(x + pi, 2 pi) - pi|
  float r = fmodf(__fadd_rn(x, kPi), kTwoPi);
  if (r != 0.0f && (r < 0.0f) != (kTwoPi < 0.0f)) r = __fadd_rn(r, kTwoPi);
  return fabsf(__fsub_rn(r, kPi));
}

__global__ void __launch_bounds__(kWarps * 32)
hypothesis_scores_kernel(const float* __restrict__ fa,   // (P, 5, K)
                         const float* __restrict__ fb,   // (P, 5, K)
                         const float* __restrict__ hyp,  // (P, 4, H)
                         const float* __restrict__ possible,  // (P,)
                         float* __restrict__ scores,     // (P, H)
                         int* __restrict__ counts,       // (P, H)
                         int h_total, int k, float dist2, float orient,
                         float sigma_d2, float sigma_o2, int use_type,
                         int min_inliers) {
  __shared__ float sb[5][kMaxK];
  const int pair = blockIdx.x;
  const float* a = fa + (size_t)pair * 5 * k;
  const float* b = fb + (size_t)pair * 5 * k;
  for (int e = threadIdx.x; e < 5 * k; e += blockDim.x) sb[e / k][e % k] = b[e];
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int hh = blockIdx.y * kWarps + warp;
  if (hh >= h_total) return;
  const float* hp = hyp + (size_t)pair * 4 * h_total;
  const float th = hp[hh];
  const float tx = hp[h_total + hh];
  const float ty = hp[2 * h_total + hh];
  const bool has_cand = hp[3 * h_total + hh] > 0.5f;
  // float32 cos/sin rounded from double, as the plain twin's _cos_sin
  const float c = (float)cos((double)th), s = (float)sin((double)th);
  const float kf = (float)k;

  float sum = 0.0f;
  int n = 0;
  for (int i = lane; i < k; i += 32) {
    const float ax = a[i], ay = a[k + i];
    const float tax = __fadd_rn(__fmaf_rn(c, ax, -__fmul_rn(s, ay)), tx);
    const float tay = __fadd_rn(__fmaf_rn(s, ax, __fmul_rn(c, ay)), ty);
    float best_q = 3.0e38f;
    int best_j = 0;
    for (int j = 0; j < k; ++j) {
      const float dx = __fsub_rn(tax, sb[0][j]);
      const float dy = __fsub_rn(tay, sb[1][j]);
      const float d2 = __fmaf_rn(dx, dx, __fmul_rn(dy, dy));
      const float q = fminf(rintf(__fmul_rn(d2, kNnQ)), kNnSat);
      if (q < best_q) {  // strict: the first j of the minimum, as q*K + j
        best_q = q;
        best_j = j;
      }
    }
    // floor((q*K + j) / K) == q exactly in f32 (q*K + j < 2^24)
    const float d2_at = __fdiv_rn(floorf(__fdiv_rn(
        __fadd_rn(__fmul_rn(best_q, kf), (float)best_j), kf)), kNnQ);
    const float dang = wrap_abs(__fsub_rn(__fadd_rn(a[2 * k + i], th),
                                          sb[2][best_j]));
    bool inl = d2_at <= dist2 && dang <= orient;
    if (use_type) inl = inl && fabsf(__fsub_rn(a[3 * k + i], sb[3][best_j])) < 0.5f;
    if (inl) {
      const float ex = __fsub_rn(-__fdiv_rn(d2_at, sigma_d2),
                                 __fdiv_rn(__fmul_rn(dang, dang), sigma_o2));
      sum = __fadd_rn(sum, __fmul_rn(__fmul_rn(expf(ex), a[4 * k + i]),
                                     sb[4][best_j]));
      ++n;
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, off));
    n += __shfl_xor_sync(0xffffffffu, n, off);
  }
  if (lane == 0) {
    const float raw = __fdiv_rn(sum, __fadd_rn(possible[pair], 1e-6f));
    const float score =
        fminf(expf(__fmul_rn(0.75f, logf(fmaxf(raw, 1e-30f)))), 1.0f);
    const size_t o = (size_t)pair * h_total + hh;
    scores[o] = (has_cand && n >= min_inliers) ? score : 0.0f;
    counts[o] = has_cand ? n : 0;
  }
}

}  // namespace

// fa, fb: (P, 5, K) float32 planes x, y, orientation, type, weight, invalid
// slots displaced (A to +1e6, B to -1e6); hyp: (P, 4, H) theta, tx, ty,
// has_cand; possible: (P,); scores: (P, H) float32; counts: (P, H) int32.
// K must be a power of two <= 128.
extern "C" int mbfp_hypothesis_scores(const float* fa, const float* fb,
                                      const float* hyp, const float* possible,
                                      float* scores, int* counts, int p, int h,
                                      int k, float dist2, float orient,
                                      float sigma_d2, float sigma_o2,
                                      int use_type, int min_inliers,
                                      cudaStream_t stream) {
  if (k <= 0 || k > kMaxK) return (int)cudaErrorInvalidValue;
  const dim3 grid(p, (h + kWarps - 1) / kWarps);
  hypothesis_scores_kernel<<<grid, kWarps * 32, 0, stream>>>(
      fa, fb, hyp, possible, scores, counts, h, k, dist2, orient, sigma_d2,
      sigma_o2, use_type, min_inliers);
  return (int)cudaGetLastError();
}
