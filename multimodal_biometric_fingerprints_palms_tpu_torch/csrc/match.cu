// Kernel D: RANSAC hypothesis scoring for 1:1 minutiae matching.
//
// Replaces the TPU kernels matching/pallas_match.py:
// hypothesis_scores_pallas_grouped (_grouped_kernel), which scored G=64
// hypotheses per grid step in a (K, K*G) VMEM layout with roll-min
// butterflies and one-hot MXU extraction of the nearest neighbour's
// attributes, and hypothesis_scores_pallas (_match_kernel), one hypothesis
// per step; both compute the same outputs: for every pair and hypothesis,
// each transformed A minutia's nearest B minutia under the unique-min
// encoding q*K + j with q = min(rint(d2*256), 2^18-1), then the gates, the
// score and the inlier count.
//
// Bound: operations. A pair costs H*K^2 distance evaluations (1.2 M at
// H=300, K=64; 0.63 G per 512-pair chunk) against about 9 KB of input, so
// instruction rate bounds it, not memory. The function is a min-reduction
// over distances whose every rounding is fixed by the plain twin
// (matching/cuda_match.py:hypothesis_scores_plain): the difference, the
// product and the fused multiply-add each round once, and the quantization
// rounds their result again. A tensor-core product computes sum(a*b) with
// its own accumulation order and no rounding in between, and there is no
// product here to give it (|a-b|^2 expanded into a.b changes the
// roundings), so wgmma does not apply; the work is FP32 and integer
// instructions, and the design spends as few as the roundings allow, 7 a
// distance:
//
// - Grid (P, ceil(H/32)), 256 threads. A block stages its pair's A and B
//   minutiae once for 32 hypotheses, straight from the matcher's tensors
//   (valid, xy, orientation, type, weight; invalid A slots displaced to
//   +1e6 and invalid B slots to -1e6 on load), while two other warps take
//   the cosines and the sines of the 32 angles in double, rounded to float
//   as the twin's _cos_sin rounds them: trig once per hypothesis, not once
//   per lane.
// - A warp scores 4 hypotheses. A lane keeps the 4 transformed positions of
//   one A minutia in registers and walks j once, reading B as float4
//   broadcasts (two minutiae a load), so one shared-memory load serves 8
//   distances. j runs in unrolled steps of 8, so the index is an immediate.
// - No rounding instruction and no *256 in the loop. Positions are
//   pre-scaled by 2^-5 (exact), which makes fma(dx, dx, dy*dy) equal
//   d2*256 / 2^18 bit for bit, with the fused multiply-add exactly where
//   the twin has it; the .sat of that fma clamps at 1.0 = 2^18 for free;
//   adding 48.0f (ulp 2^-18 in [32, 64)) rounds half to even onto the
//   quantization grid, and leaves q in the low mantissa bits:
//   bits = 0x42400000 + q. (bits << 7) + j is the unique-min key as an
//   integer (any K <= 128), one integer minimum keeps the best.
//   Afterwards q >= 2^18-1 means every B minutia is saturated; the twin's
//   keys then tie at 2^18-1 and j = 0 wins, so the kernel sets q = 2^18-1,
//   j = 0: min(rint(x), S) == min(rint(min(x, S+1)), S) because rint is
//   monotone and fixes integers.
// - Invalid B slots are skipped, exactly. The twin gives every invalid B
//   slot the one displaced point (-1e6, -1e6), so they all share one q, and
//   among them the key q*K + j is least at the lowest invalid slot. The
//   staging compacts the valid slots to the front in their order (ballots;
//   the original index rides along), so the least key among them is found
//   with the compacted position in place of j: position and j order alike.
//   The loop walks the valid slots only; afterwards one more distance, to
//   the displaced point, stands for all invalid slots under the lowest
//   invalid index, and the smaller of the two (q, j) pairs is the twin's
//   minimum over all K slots. With no valid slot that candidate is slot 0,
//   saturated: j = 0, q = 2^18-1, as the twin returns. (Invalid A slots are
//   still scored: a lane per A minutia gains nothing from skipping some.)
// - The gates and the score follow the twin operation by operation
//   (__fmul_rn/__fadd_rn keep nvcc from contracting; the angle wrap is
//   torch.remainder's fmod and sign fix, the fmod by an exact subtraction
//   where its quotient is 0 or 1; expf/logf are the accurate versions, no
//   --use_fast_math). A lane adds its A minutiae's terms in index order
//   and the warp sums with an xor-shuffle tree.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kHypWarp = 4;                   // hypotheses a warp scores
constexpr int kHypBlock = kWarps * kHypWarp;  // hypotheses per block
constexpr int kMaxK = 128;
constexpr int kStep = 8;                      // B minutiae per unrolled step
constexpr float kScale = 0.03125f;            // 2^-5
constexpr float kBias = 48.0f;                // 1.5 * 2^5
constexpr unsigned kKeyBase = 0x20000000u;    // (bits of 48.0f) << 7, mod 2^32
constexpr int kJBits = 7;
constexpr int kNnSat = 262143;                // 2^18 - 1
constexpr float kFar = 1.0e6f;
constexpr float kPi = 3.14159265358979323846f;
constexpr float kTwoPi = 6.28318530717958647692f;

__device__ __forceinline__ float wrap_abs(float x) {
  // |torch.remainder(x + pi, 2 pi) - pi|. The remainder's fmod by hand
  // where its quotient is 0 or 1, which a sum of three angles in [-pi, pi]
  // always gives: v itself below 2 pi, v -+ 2 pi below 4 pi (exact: the
  // difference of two floats within a factor of two of each other is a
  // float); fmodf beyond.
  const float v = __fadd_rn(x, kPi);
  const float av = fabsf(v);
  float r;
  if (av < kTwoPi) r = v;
  else if (av < 2.0f * kTwoPi) r = copysignf(__fsub_rn(av, kTwoPi), v);
  else r = fmodf(v, kTwoPi);
  if (r < 0.0f) r = __fadd_rn(r, kTwoPi);   // the divisor's sign
  return fabsf(__fsub_rn(r, kPi));
}

// min(fma(a, b, c), 1), the clamp riding on the instruction
__device__ __forceinline__ float fma_sat(float a, float b, float c) {
  float d;
  asm("fma.rn.sat.f32 %0, %1, %2, %3;" : "=f"(d) : "f"(a), "f"(b), "f"(c));
  return d;
}

// The unique-min key of one distance: quantized d2 above the index bits.
__device__ __forceinline__ unsigned nn_key(float px, float py, float bx,
                                           float by, int j) {
  const float dx = __fsub_rn(px, bx);
  const float dy = __fsub_rn(py, by);
  const float v = __fadd_rn(fma_sat(dx, dx, __fmul_rn(dy, dy)), kBias);
  return (__float_as_uint(v) << kJBits) + j;
}

__global__ void __launch_bounds__(kWarps * 32)
hypothesis_scores_kernel(
    const float* __restrict__ a_xy, const float* __restrict__ a_ori,
    const int* __restrict__ a_type, const uint8_t* __restrict__ a_valid,
    const float* __restrict__ a_w, const float* __restrict__ b_xy,
    const float* __restrict__ b_ori, const int* __restrict__ b_type,
    const uint8_t* __restrict__ b_valid, const float* __restrict__ b_w,
    const float* __restrict__ theta,     // (P, H)
    const float* __restrict__ trans,     // (P, H, 2)
    const float* __restrict__ has_cand,  // (P, H)
    const float* __restrict__ possible,  // (P,)
    float* __restrict__ scores, int* __restrict__ counts,  // (P, H)
    int h_total, int k, float dist2, float orient, float sigma_d2,
    float sigma_o2, int use_type, int min_inliers) {
  __shared__ float sa[5][kMaxK];        // x, y, orientation, type, weight
  __shared__ float4 sbxy[kMaxK / 2];    // scaled (x, y) of two B minutiae
  __shared__ float sb[3][kMaxK];        // orientation, type, weight
  __shared__ float sh[5][kHypBlock];    // cos, sin, tx, ty, theta
  __shared__ int scand[kHypBlock];
  __shared__ int sidx[kMaxK];           // compacted position -> B slot
  __shared__ int snb[2];                // valid B slots, lowest invalid one

  const int pair = blockIdx.x;
  float* sbxy_f = reinterpret_cast<float*>(sbxy);
  if (threadIdx.x < kMaxK) {   // whole warps: thread e stages slot e
    const int e = threadIdx.x, lane = e & 31;
    const uint8_t* bv = b_valid + (size_t)pair * k;
    // every warp takes the ballots of all slots: the count before its own,
    // the total, and the lowest invalid slot, with no barrier in between
    int before = 0, total = 0, first_invalid = k;
    bool vb = false;
    for (int g = 0; 32 * g < k; ++g) {
      const int slot = 32 * g + lane;
      const bool v = slot < k && bv[slot] != 0;
      const unsigned valid = __ballot_sync(0xffffffffu, v);
      const unsigned invalid = __ballot_sync(0xffffffffu, slot < k && !v);
      if (invalid && first_invalid == k) first_invalid = 32 * g + __ffs(invalid) - 1;
      if (32 * g + 32 <= e) before += __popc(valid);
      if (32 * g <= e && e < 32 * g + 32) {
        before += __popc(valid & ((1u << lane) - 1u));
        vb = v;
      }
      total += __popc(valid);
    }
    if (e < k) {
      const size_t o = (size_t)pair * k + e;
      const bool va = a_valid[o] != 0;
      sa[0][e] = va ? a_xy[2 * o] : kFar;
      sa[1][e] = va ? a_xy[2 * o + 1] : kFar;
      sa[2][e] = a_ori[o];
      sa[3][e] = (float)a_type[o];
      sa[4][e] = a_w[o];
      sb[0][e] = b_ori[o];
      sb[1][e] = (float)b_type[o];
      sb[2][e] = b_w[o];
      if (vb) {
        sbxy_f[2 * before] = __fmul_rn(b_xy[2 * o], kScale);
        sbxy_f[2 * before + 1] = __fmul_rn(b_xy[2 * o + 1], kScale);
        sidx[before] = e;
      }
    }
    // padding up to a whole step: saturated, and behind every valid slot
    if (e >= total && e < (total + kStep - 1) / kStep * kStep) {
      sbxy_f[2 * e] = -1.0e8f;
      sbxy_f[2 * e + 1] = -1.0e8f;
      sidx[e] = 0;
    }
    if (e == 0) { snb[0] = total; snb[1] = first_invalid; }
  }
  // hypotheses: warps 2 and 3, so the trig runs beside the staging above;
  // one takes the cosines, the other the sines
  static_assert(4 * kHypBlock <= kWarps * 32, "two trig threads a hypothesis");
  const int ht = (int)threadIdx.x - 2 * kHypBlock;
  if (ht >= 0 && ht < 2 * kHypBlock) {
    const bool sine = ht >= kHypBlock;
    const int slot = sine ? ht - kHypBlock : ht;
    const int hh = blockIdx.y * kHypBlock + slot;
    const size_t o = (size_t)pair * h_total + hh;
    const float th = hh < h_total ? theta[o] : 0.0f;
    // float32 cos/sin rounded from double, as the plain twin's _cos_sin
    if (sine) {
      sh[1][slot] = (float)sin((double)th);
      sh[3][slot] = hh < h_total ? trans[2 * o + 1] : 0.0f;
      scand[slot] = hh < h_total && has_cand[o] > 0.5f;
    } else {
      sh[0][slot] = (float)cos((double)th);
      sh[2][slot] = hh < h_total ? trans[2 * o] : 0.0f;
      sh[4][slot] = th;
    }
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int slot0 = warp * kHypWarp;
  const int hh0 = blockIdx.y * kHypBlock + slot0;
  if (hh0 >= h_total) return;

  const int nb_pad = (snb[0] + kStep - 1) / kStep * kStep;
  const int j_invalid = snb[1];                    // k if every slot is valid
  const float b_invalid = __fmul_rn(-kFar, kScale);
  float sum[kHypWarp];
  int n[kHypWarp];
#pragma unroll
  for (int r = 0; r < kHypWarp; ++r) { sum[r] = 0.0f; n[r] = 0; }

  for (int i = lane; i < k; i += 32) {
    const float ax = sa[0][i], ay = sa[1][i];
    float px[kHypWarp], py[kHypWarp];
    unsigned best[kHypWarp];
#pragma unroll
    for (int r = 0; r < kHypWarp; ++r) {
      const float c = sh[0][slot0 + r], s = sh[1][slot0 + r];
      const float tax = __fadd_rn(__fmaf_rn(c, ax, -__fmul_rn(s, ay)),
                                  sh[2][slot0 + r]);
      const float tay = __fadd_rn(__fmaf_rn(s, ax, __fmul_rn(c, ay)),
                                  sh[3][slot0 + r]);
      px[r] = __fmul_rn(tax, kScale);
      py[r] = __fmul_rn(tay, kScale);
      best[r] = 0xFFFFFFFFu;
    }
    for (int jb = 0; jb < nb_pad; jb += kStep) {
      unsigned m[kHypWarp];
#pragma unroll
      for (int r = 0; r < kHypWarp; ++r) m[r] = 0xFFFFFFFFu;
#pragma unroll
      for (int jj = 0; jj < kStep; jj += 2) {
        const float4 b = sbxy[(jb + jj) >> 1];
#pragma unroll
        for (int r = 0; r < kHypWarp; ++r)
          m[r] = min(m[r], min(nn_key(px[r], py[r], b.x, b.y, jj),
                               nn_key(px[r], py[r], b.z, b.w, jj + 1)));
      }
#pragma unroll
      for (int r = 0; r < kHypWarp; ++r) best[r] = min(best[r], m[r] + jb);
    }

    const float a_o = sa[2][i], a_t = sa[3][i], a_wt = sa[4][i];
#pragma unroll
    for (int r = 0; r < kHypWarp; ++r) {
      int q = (int)((best[r] - kKeyBase) >> kJBits);
      int j = sidx[best[r] & ((1u << kJBits) - 1u)];
      if (j_invalid < k) {   // all invalid slots: one point, the lowest index
        const int qi = (int)((nn_key(px[r], py[r], b_invalid, b_invalid, 0)
                              - kKeyBase) >> kJBits);
        if (qi < q || (qi == q && j_invalid < j)) { q = qi; j = j_invalid; }
      }
      if (q >= kNnSat) { q = kNnSat; j = 0; }   // every B minutia saturated
      const float d2_at = __fmul_rn((float)q, 0.00390625f);   // q / 256
      const float dang = wrap_abs(__fsub_rn(
          __fadd_rn(a_o, sh[4][slot0 + r]), sb[0][j]));
      bool inl = d2_at <= dist2 && dang <= orient;
      if (use_type) inl = inl && fabsf(__fsub_rn(a_t, sb[1][j])) < 0.5f;
      if (inl) {
        const float ex = __fsub_rn(-__fdiv_rn(d2_at, sigma_d2),
                                   __fdiv_rn(__fmul_rn(dang, dang), sigma_o2));
        sum[r] = __fadd_rn(sum[r], __fmul_rn(__fmul_rn(expf(ex), a_wt),
                                             sb[2][j]));
        ++n[r];
      }
    }
  }

  float my_sum = 0.0f;
  int my_n = 0;
#pragma unroll
  for (int r = 0; r < kHypWarp; ++r) {
    float s = sum[r];
    int c = n[r];
    for (int off = 16; off > 0; off >>= 1) {
      s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, off));
      c += __shfl_xor_sync(0xffffffffu, c, off);
    }
    if (lane == r) { my_sum = s; my_n = c; }
  }
  if (lane < kHypWarp && hh0 + lane < h_total) {
    const float raw = __fdiv_rn(my_sum, __fadd_rn(possible[pair], 1e-6f));
    const float score =
        fminf(expf(__fmul_rn(0.75f, logf(fmaxf(raw, 1e-30f)))), 1.0f);
    const bool cand = scand[slot0 + lane] != 0;
    const size_t o = (size_t)pair * h_total + hh0 + lane;
    scores[o] = (cand && my_n >= min_inliers) ? score : 0.0f;
    counts[o] = cand ? my_n : 0;
  }
}

}  // namespace

// The matcher's tensors as it holds them, all contiguous: a_*/b_* are the
// (P, K) fields of the A and B templates (xy (P, K, 2) float32, orientation
// float32, type int32, valid bool, weight float32); theta (P, H), trans
// (P, H, 2), has_cand (P, H) float32, possible (P,); scores (P, H) float32;
// counts (P, H) int32. K <= 128.
extern "C" int mbfp_hypothesis_scores(
    const float* a_xy, const float* a_ori, const int* a_type,
    const uint8_t* a_valid, const float* a_w, const float* b_xy,
    const float* b_ori, const int* b_type, const uint8_t* b_valid,
    const float* b_w, const float* theta, const float* trans,
    const float* has_cand, const float* possible, float* scores, int* counts,
    int p, int h, int k, float dist2, float orient, float sigma_d2,
    float sigma_o2, int use_type, int min_inliers, cudaStream_t stream) {
  if (k <= 0 || k > kMaxK || p <= 0 || h <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid(p, (h + kHypBlock - 1) / kHypBlock);
  hypothesis_scores_kernel<<<grid, kWarps * 32, 0, stream>>>(
      a_xy, a_ori, a_type, a_valid, a_w, b_xy, b_ori, b_type, b_valid, b_w,
      theta, trans, has_cand, possible, scores, counts, h, k, dist2, orient,
      sigma_d2, sigma_o2, use_type, min_inliers);
  return (int)cudaGetLastError();
}
