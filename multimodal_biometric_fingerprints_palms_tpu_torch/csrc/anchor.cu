// Kernel J: the cascade screen's recall anchors, one launch a screen call.
//
// Replaces no TPU kernel. The JAX package's anchors
// (matching/ransac.py:anchor_promote) are plain jnp, vmapped over the
// pairs, which XLA fuses. The port's plain twin
// (matching/ransac.py:_anchor_promote, fed the statistics kernel I computed
// for the same pairs) runs them op by op over (P, 8, K, K) tensors with
// every fused multiply-add emulated in float64: about 19 ms of device time
// a 4,096-pair tile of the all-pairs screen, where the arithmetic is 134 M
// distances. The kernel was added so that the screen's anchors cost what
// their arithmetic costs.
//
// What it computes, for each pair: the top T = min(8, K) slots of A
// and of B by the key where(valid, w, -1), descending with ties to the
// lower index (torch.sort(stable=True)'s order, here a rank count; NaN
// first, as torch.sort orders it); the rigid transform that puts the t-th
// anchor of A onto the t-th of B; each valid A minutia's nearest B minutia
// under it; the screen's inlier gate; and the promote bit
// any_t(valid_a[t] & valid_b[t] & count_t >= min_inliers) & ~reject, with
// kernel I's early reject.
//
// Bound: operations. A pair reads about 3 KB (the xy, orientation, type
// and validity of 2 K slots and their weights) and evaluates up to T K^2
// distances: 32,768 at K = 64, 134 M a 4,096-pair tile against 12 MB read.
// So the design spends as few instructions a distance as the twin's
// roundings allow: one block a pair, one thread an A slot that keeps its T
// transformed points and their |a|^2 in registers and walks the pair's B
// slots once in shared memory, where one float4 broadcast (x, y, |b|^2)
// serves T distances. 8 instructions a distance:
//
// - The twin's matmul form (_sqdist), rounded as it rounds it:
//   ab = fma(y, by, x bx) with __fmaf_rn where _fma stands, then
//   aa - 2 ab as fma(-2, ab, aa) (2 ab is exact, so both forms round once,
//   alike), then + |b|^2. Every other product and sum is __fmul_rn or
//   __fadd_rn, so nvcc contracts nothing the twin does not.
// - The clamps at 0 and at 1024 px^2 and the quantization with no rounding
//   instruction: mul.rn.sat by 2^-10 (exact, then clamped to [0, 1]) and
//   + 48.0f (ulp 2^-18 in [32, 64)) round half to even onto
//   q = rint(d2 * 256) in the low mantissa bits: bits = 0x42400000 + q,
//   q <= 2^18. A d2 under 2^-116 px^2 scales inexactly into the subnormals
//   but stays far below the first half step (2^-9 px^2): q = 0, as the
//   twin's. (bits << 7) + position is kernel D's unique-min key as an
//   integer; one integer minimum keeps the best. Afterwards q >= 2^18 - 1
//   means every B slot is saturated: the twin's keys then tie at 2^18 - 1
//   and j = 0 wins, so the kernel sets q = 2^18 - 1, j = 0.
// - D's compaction of the B slots: the valid ones to the front in their
//   order (the original index rides along), so the compacted position
//   orders like j; every invalid slot is at the twin's 1e9 px^2, so they
//   all share q = 2^18 - 1, and one candidate at the lowest invalid index
//   stands for them after the loop.
// - D's pre-scaling of the positions by 2^-5 is left out. In D's difference
//   form it is exact; in the matmul form a product of two coordinates
//   scaled by 2^-10 can round into the subnormals where the twin's does
//   not, and no proof that such a rounding never reaches q was found. It
//   would save one instruction a distance (the .sat would ride on the last
//   add).
// - The twin's key q * K + j is a float32: at K = 128 it rounds once
//   q >= 2^17, so equal keys can arise and the twin's minimum may then fall
//   on another (q, j) than the exact integer key. That takes d2 >= 512 px^2;
//   only where the distance gate could pass there (dist_thresh >= 22.6 px)
//   does a thread rescan its slot with the twin's float keys and first-index
//   ties.
//
// Every other step is the twin's, on the card: cos and sin of the anchor
// angle in double, rounded to float32; the anchor's translation
// xy_b - (rigid(xy_a) + 0); the angle wrap of wrap_angle.cuh; the decoded
// distance sqrt(q / 256) against dist_thresh; the counts as ballots.
// Invalid A slots are skipped (the twin masks them out of every count).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "wrap_angle.cuh"

namespace {

constexpr int kMaxK = 128;
constexpr int kMaxWarps = kMaxK / 32;
constexpr int kAnchors = 8;                   // anchors a pair (fewer if K < 8)
constexpr float kQuant = 0.0009765625f;       // 2^-10 = 256 / 2^18
constexpr float kBias = 48.0f;                // 1.5 * 2^5
constexpr unsigned kKeyBase = 0x20000000u;    // (bits of 48.0f) << 7, mod 2^32
constexpr int kJBits = 7;
constexpr int kNnSat = 262143;                // 2^18 - 1
constexpr unsigned kFull = 0xffffffffu;

struct Gates {
  float dist, orient;
  int use_type, min_inliers;
};

// min(max(a * b, 0), 1), the clamps riding on the instruction
__device__ __forceinline__ float mul_sat(float a, float b) {
  float d;
  asm("mul.rn.sat.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

// The twin's squared distance aa - 2 ab + bb, not yet clamped
__device__ __forceinline__ float sqdist(float px, float py, float aa,
                                       float4 b) {
  const float ab = __fmaf_rn(py, b.y, __fmul_rn(px, b.x));
  return __fadd_rn(__fmaf_rn(-2.0f, ab, aa), b.z);
}

// min(rint(max(d2, 0) * 256), 2^18) in the low mantissa bits of 48 + q/2^18
__device__ __forceinline__ unsigned q_bits(float d2) {
  return __float_as_uint(__fadd_rn(mul_sat(d2, kQuant), kBias));
}

// torch.sort(descending=True, stable=True)'s order: is (x, ix) before (y, iy)?
__device__ __forceinline__ bool ahead(float x, int ix, float y, int iy) {
  if (isnan(x)) return !isnan(y) || ix < iy;
  if (isnan(y)) return false;
  return x > y || (x == y && ix < iy);
}

__global__ void __launch_bounds__(kMaxK)
anchor_kernel(const float* __restrict__ a_xy, const float* __restrict__ a_ori,
              const int* __restrict__ a_type,
              const uint8_t* __restrict__ a_valid,
              const float* __restrict__ b_xy, const float* __restrict__ b_ori,
              const int* __restrict__ b_type,
              const uint8_t* __restrict__ b_valid,
              const float* __restrict__ wa, const float* __restrict__ wb,
              const uint8_t* __restrict__ reject,
              uint8_t* __restrict__ promote, int k, Gates g) {
  __shared__ float skey_a[kMaxK], skey_b[kMaxK];
  __shared__ float4 sb[kMaxK];              // compacted valid B: x, y, |b|^2
  __shared__ int sidx[kMaxK];               // compacted position -> B slot
  __shared__ float sbo[kMaxK];              // B's orientation and type, by slot
  __shared__ int sbt[kMaxK];
  __shared__ int snvalid[kMaxWarps];        // valid B slots a warp
  __shared__ unsigned sinvalid[kMaxWarps];  // a warp's invalid B slots
  __shared__ int sa_slot[kAnchors], sb_slot[kAnchors];
  __shared__ float sc[kAnchors], ss[kAnchors], stx[kAnchors], sty[kAnchors],
      sth[kAnchors];
  __shared__ bool sok[kAnchors];
  __shared__ int scount[kAnchors];

  const int pair = blockIdx.x, i = threadIdx.x;
  const int lane = i & 31, warp = i >> 5, nw = blockDim.x >> 5;
  const bool live = i < k;
  const size_t row = (size_t)pair * k;
  const int n_anch = min(kAnchors, k);

  // 1. this thread's A slot; B's keys, orientations, types and validity
  float ax = 0.0f, ay = 0.0f, ao = 0.0f;
  int at = 0;
  bool av = false, bv = false;
  if (live) {
    const size_t o = row + i;
    ax = a_xy[2 * o];
    ay = a_xy[2 * o + 1];
    ao = a_ori[o];
    at = a_type[o];
    av = a_valid[o] != 0;
    bv = b_valid[o] != 0;
    skey_a[i] = av ? wa[o] : -1.0f;
    skey_b[i] = bv ? wb[o] : -1.0f;
    sbo[i] = b_ori[o];
    sbt[i] = b_type[o];
  }
  const unsigned valid_bits = __ballot_sync(kFull, bv);
  const unsigned invalid_bits = __ballot_sync(kFull, live && !bv);
  if (lane == 0) {
    snvalid[warp] = __popc(valid_bits);
    sinvalid[warp] = invalid_bits;
  }
  if (i < kAnchors) scount[i] = 0;
  __syncthreads();

  // 2. the compaction of the valid B slots, and the anchors' ranks
  int before = __popc(valid_bits & ((1u << lane) - 1u)), n_valid = 0;
  int first_invalid = k;
  for (int w = 0; w < nw; ++w) {
    if (w < warp) before += snvalid[w];
    n_valid += snvalid[w];
    if (first_invalid == k && sinvalid[w])
      first_invalid = 32 * w + __ffs(sinvalid[w]) - 1;
  }
  if (bv) {
    const float bx = b_xy[2 * (row + i)], by = b_xy[2 * (row + i) + 1];
    sb[before] = make_float4(bx, by, __fmaf_rn(by, by, __fmul_rn(bx, bx)),
                             0.0f);
    sidx[before] = i;
  }
  if (live) {
    const float ka = skey_a[i], kb = skey_b[i];
    int ra = 0, rb = 0;
    for (int j = 0; j < k; ++j) {
      ra += ahead(skey_a[j], j, ka, i);
      rb += ahead(skey_b[j], j, kb, i);
    }
    if (ra < n_anch) sa_slot[ra] = i;
    if (rb < n_anch) sb_slot[rb] = i;
  }
  __syncthreads();

  // 3. each anchor's transform: theta = wrap(ori_b - ori_a), cos and sin
  // in double rounded to float32, t = xy_b - (rigid(xy_a) + 0)
  if (i < kAnchors) {
    float c = 0.0f, s = 0.0f, tx = 0.0f, ty = 0.0f, th = 0.0f;
    bool ok = false;
    if (i < n_anch) {
      const size_t oa = row + sa_slot[i], ob = row + sb_slot[i];
      th = wrap_angle(__fsub_rn(b_ori[ob], a_ori[oa]));
      c = __double2float_rn(cos((double)th));
      s = __double2float_rn(sin((double)th));
      const float xa = a_xy[2 * oa], ya = a_xy[2 * oa + 1];
      const float rx = __fadd_rn(__fmaf_rn(c, xa, -__fmul_rn(s, ya)), 0.0f);
      const float ry = __fadd_rn(__fmaf_rn(s, xa, __fmul_rn(c, ya)), 0.0f);
      tx = __fsub_rn(b_xy[2 * ob], rx);
      ty = __fsub_rn(b_xy[2 * ob + 1], ry);
      ok = a_valid[oa] != 0 && b_valid[ob] != 0;
    }
    sc[i] = c;
    ss[i] = s;
    stx[i] = tx;
    sty[i] = ty;
    sth[i] = th;
    sok[i] = ok;
  }
  __syncthreads();

  // 4. this A slot under every anchor: nearest B slot, then the gates
  bool inl[kAnchors];
#pragma unroll
  for (int t = 0; t < kAnchors; ++t) inl[t] = false;
  if (av) {
    float px[kAnchors], py[kAnchors], aa[kAnchors];
    unsigned best[kAnchors];
#pragma unroll
    for (int t = 0; t < kAnchors; ++t) {
      const float c = sc[t], s = ss[t];
      px[t] = __fadd_rn(__fmaf_rn(c, ax, -__fmul_rn(s, ay)), stx[t]);
      py[t] = __fadd_rn(__fmaf_rn(s, ax, __fmul_rn(c, ay)), sty[t]);
      aa[t] = __fmaf_rn(py[t], py[t], __fmul_rn(px[t], px[t]));
      best[t] = 0xFFFFFFFFu;
    }
#pragma unroll 2
    for (int pos = 0; pos < n_valid; ++pos) {
      const float4 b = sb[pos];
#pragma unroll
      for (int t = 0; t < kAnchors; ++t)
        best[t] = min(best[t], (q_bits(sqdist(px[t], py[t], aa[t], b))
                                << kJBits) + pos);
    }
    const float kf = (float)k;
#pragma unroll
    for (int t = 0; t < kAnchors; ++t) {
      if (t >= n_anch) continue;
      int q = 0x7fffffff, j = k;
      if (best[t] != 0xFFFFFFFFu) {
        q = (int)((best[t] - kKeyBase) >> kJBits);
        j = sidx[best[t] & ((1u << kJBits) - 1u)];
      }
      // every invalid slot: q = 2^18 - 1 at the lowest invalid index
      if (first_invalid < k && (kNnSat < q || (kNnSat == q && first_invalid < j))) {
        q = kNnSat;
        j = first_invalid;
      }
      const int qc = min(q, kNnSat);
      if ((long long)qc * k + (k - 1) >= (1LL << 24)
          && __fsqrt_rn(__fmul_rn((float)qc, 0.00390625f)) <= g.dist) {
        // the twin's float keys, first index on ties (K = 128 only)
        float code = INFINITY;
        j = k;
        for (int pos = 0; pos < n_valid; ++pos) {
          const int jj = sidx[pos];
          const int qq = min((int)(q_bits(sqdist(px[t], py[t], aa[t], sb[pos]))
                                   - 0x42400000u), kNnSat);
          const float e = __fadd_rn(__fmul_rn((float)qq, kf), (float)jj);
          if (e < code || (e == code && jj < j)) { code = e; j = jj; }
        }
        if (first_invalid < k) {
          const float e = __fadd_rn(__fmul_rn((float)kNnSat, kf),
                                    (float)first_invalid);
          if (e < code || (e == code && first_invalid < j)) {
            code = e;
            j = first_invalid;
          }
        }
        q = (int)floorf(__fmul_rn(code, 1.0f / kf));
      } else if (q >= kNnSat) {   // every B slot saturated
        q = kNnSat;
        j = 0;
      }
      const float d = __fsqrt_rn(__fmul_rn((float)q, 0.00390625f));   // q / 256
      const float ang = wrap_abs(__fsub_rn(__fadd_rn(ao, sth[t]), sbo[j]));
      bool ok = d <= g.dist && ang <= g.orient;
      if (g.use_type) ok = ok && at == sbt[j];
      inl[t] = ok;
    }
  }

  // 5. the counts, and the promote bit
#pragma unroll
  for (int t = 0; t < kAnchors; ++t) {
    const unsigned m = __ballot_sync(kFull, inl[t]);
    if (lane == 0 && m) atomicAdd(&scount[t], __popc(m));
  }
  __syncthreads();
  if (i == 0) {
    bool any = false;
    for (int t = 0; t < n_anch; ++t)
      any = any || (sok[t] && scount[t] >= g.min_inliers);
    promote[pair] = any && reject[pair] == 0;
  }
}

}  // namespace

// The matcher's tensors as it holds them, all contiguous: a_*/b_* are the
// (P, K) fields of the A and B templates (xy (P, K, 2) float32,
// orientation float32, type int32, valid bool); wa, wb (P, K) float32 and
// reject (P,) bool, kernel I's statistics of the same pairs. Writes
// promote (P,) bool. K <= 128, a power of two.
extern "C" int mbfp_anchor_promote(
    const float* a_xy, const float* a_ori, const int* a_type,
    const uint8_t* a_valid, const float* b_xy, const float* b_ori,
    const int* b_type, const uint8_t* b_valid, const float* wa,
    const float* wb, const uint8_t* reject, uint8_t* promote, int p, int k,
    float dist, float orient, int use_type, int min_inliers,
    cudaStream_t stream) {
  if (k <= 0 || k > kMaxK || (k & (k - 1)) || p <= 0)
    return (int)cudaErrorInvalidValue;
  const Gates g{dist, orient, use_type, min_inliers};
  anchor_kernel<<<p, k < 32 ? 32 : k, 0, stream>>>(
      a_xy, a_ori, a_type, a_valid, b_xy, b_ori, b_type, b_valid, wa, wb,
      reject, promote, k, g);
  return (int)cudaGetLastError();
}
