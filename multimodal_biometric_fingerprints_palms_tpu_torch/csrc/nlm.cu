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
// column offset inner; template taps in tap order), so weights, values and
// the float32 accumulation are the twin's bit for bit.
// Plain twin: ops/denoise.py:nlm_denoise_plain.
//
// Per offset the function is: (1) the rounded squared difference of the
// (bf16-rounded) image and its shifted copy, where the shift reads a
// mirror-padded image (numpy "reflect") and a position outside the frame
// takes the value of its numpy-"symmetric" fold INSIDE the frame (the
// template box pads the difference plane, not the image); (2) the vertical
// 7-sum, rounded to bf16; (3) the horizontal 7-sum in float32, the weight
// bf16(exp(d2 * inv)), the value bf16(w * shifted), and two float32 adds.
// precision "f32" skips every bf16 rounding.
//
// Bound: operations (instruction issue). A batch of 128 320x256 images is
// 4.6e9 pixel-offsets of about 20 float operations and one expf each
// against 21 MB of traffic; the image crosses device memory once each way.
// Multiplies and adds are __fmul_rn/__fadd_rn so nvcc contracts nothing
// into an fma; expf is the accurate version (no --use_fast_math).
//
// Two bodies:
//
// nlm_strip_kernel, compiled for (template 7, search 21): 288 threads own a
// 64x64 tile whose image and 13-px halo sit in shared memory (odd row
// strides, so a warp reads down a column without bank conflicts). What
// costs is shared-memory traffic and barriers, so values live in registers:
//   step 1+2: a thread owns one column of 16 vertical sums. It keeps its 22
//     centre pixels in registers for all 441 offsets, loads 22 shifted
//     pixels, forms the 22 squared differences in registers and from them
//     the 16 seven-tap sums, each from its own seven values in tap order
//     (no running add-and-subtract: that would change the order). The
//     difference plane never touches shared memory. A column outside the
//     frame is its fold's column (chosen once), a row outside the frame is
//     a register copy of its fold's row;
//   step 3: a thread owns 16 neighbouring outputs of a row: 22 loads of
//     vertical sums give 16 seven-tap sums, and the 16 accumulator pairs
//     stay in registers;
//   values are rounded to bf16 two at a time through one packed conversion
//     (the conversion issues at a fraction of the float rate);
//   the vertical sums are double-buffered, so one barrier per offset.
// It serves every 64x64 tile that lies inside the frame and either ends on
// the frame's edge or keeps 3 pixels from it (all tiles of a frame whose
// sides are multiples of 64).
//
// nlm_kernel, the generic body (any odd template and search, any frame from
// 2x2): 1,024 threads own a 32x32 tile and pass the difference plane and
// the vertical sums through shared memory, two barriers per offset. It
// serves the tiles the strip body leaves out.

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

// --- the strip body: template 7, search 21 ---------------------------------

constexpr int kTpl = 7, kSrch = 21;
constexpr int kT = kTpl / 2, kR = kSrch / 2, kHalo = kT + kR;
constexpr int kTH = 64, kTW = 64;            // output tile
constexpr int kSeg = 16;                     // vertical sums one thread forms
constexpr int kSegs = kTH / kSeg;
constexpr int kD = kSeg + kTpl - 1;          // differences behind them
constexpr int kVW = kTW + kTpl - 1;          // columns of vertical sums
constexpr int kVS = kVW + 1;                 // their row stride, odd
constexpr int kSH = kTH + 2 * kHalo;         // rows of the image tile
constexpr int kSW = kTW + 2 * kHalo;
constexpr int kSS = kSW + 1;                 // its row stride, odd
constexpr int kC = 16;                       // outputs of one step-3 task
constexpr int kStripThreads = 288;
constexpr int kTasks1 = kSegs * kVW;         // 280 column segments
constexpr int kTasks3 = kTH * (kTW / kC);    // 256 row segments
constexpr int kRounds3 = (kTasks3 + kStripThreads - 1) / kStripThreads;
constexpr size_t kStripSmem = sizeof(float) * (kSH * kSS + 2 * kTH * kVS);
static_assert(kTasks1 <= kStripThreads, "one step-1 task a thread");
static_assert(kVS % 2 == 1 && kSS % 2 == 1, "odd strides");
static_assert(kD % 2 == 0 && kSeg % 2 == 0 && kC % 2 == 0,
              "values are rounded in pairs");
static_assert(kTH % 32 == 0 && kStripThreads % 32 == 0,
              "a warp's step-3 tasks are 32 rows of one segment");

// Whether the strip body serves the tile [t0, t0 + side) of an axis of
// length n: inside the frame, and its template margin either ends exactly
// one fold beyond the frame's edge or stays inside the frame.
__host__ __device__ inline bool strip_tile(int t0, int side, int n) {
  return t0 + side == n || t0 + side + kT <= n;
}

// Two values through one packed conversion: the float-to-bf16 conversion
// issues at a fraction of the float rate, and the packed form rounds two
// values for the price of one.
template <bool kBf16>
__device__ __forceinline__ void rnd2(float& a, float& b) {
  if (kBf16) {
    const __nv_bfloat162 p = __floats2bfloat162_rn(a, b);
    a = __low2float(p);
    b = __high2float(p);
  }
}

template <bool kBf16>
__global__ void __launch_bounds__(kStripThreads, 2)
nlm_strip_kernel(const float* __restrict__ img, float* __restrict__ out,
                 int h, int w, float inv) {
  extern __shared__ float smem[];
  const int ty0 = blockIdx.y * kTH, tx0 = blockIdx.x * kTW;
  if (!strip_tile(ty0, kTH, h) || !strip_tile(tx0, kTW, w)) return;
  float* sx = smem;                 // (kSH, kSS) image, mirror rule
  float* sv = sx + kSH * kSS;       // 2 x (kTH, kVS) vertical sums
  const int tid = threadIdx.x;

  const float* src = img + (size_t)blockIdx.z * h * w;
  for (int i = tid; i < kSH * kSW; i += kStripThreads) {
    const int ly = i / kSW, lx = i % kSW;
    const int y = mirror(ty0 - kHalo + ly, h);
    const int x = mirror(tx0 - kHalo + lx, w);
    sx[ly * kSS + lx] = rnd<kBf16>(src[(size_t)y * w + x]);
  }

  // Step 1+2 task: vertical sums of rows seg*kSeg .. +kSeg-1 at column j of
  // the grown tile (frame column tx0 - kT + j).
  const bool p1 = tid < kTasks1;
  const int seg = tid / kVW, j = tid % kVW;
  int jf = j;                                        // the fold of column j
  if (tx0 == 0 && j < kT) jf = 2 * kT - 1 - j;
  if (tx0 + kTW == w && j >= kTW + kT) jf = 2 * (kTW + kT) - 1 - j;
  const bool top = ty0 == 0 && seg == 0;             // rows 0..2 fold
  const bool bot = ty0 + kTH == h && seg == kSegs - 1;  // rows kD-3.. fold
  const int c0 = (kR + seg * kSeg) * kSS + kR + jf;
  const int v0 = seg * kSeg * kVS + j;

  // Step 3 tasks: kC outputs from column s*kC of row `row`; a warp's lanes
  // take 32 rows of one segment.
  int vrow[kRounds3], own[kRounds3];
#pragma unroll
  for (int q = 0; q < kRounds3; ++q) {
    const int task = tid + q * kStripThreads;
    const int row = task % kTH, s = task / kTH;
    vrow[q] = row * kVS + s * kC;
    own[q] = (row + kHalo) * kSS + s * kC + kHalo;
  }
  float acc[kRounds3][kC], wacc[kRounds3][kC];
#pragma unroll
  for (int q = 0; q < kRounds3; ++q)
#pragma unroll
    for (int c = 0; c < kC; ++c) acc[q][c] = wacc[q][c] = 0.0f;

  __syncthreads();
  float cen[kD];
#pragma unroll
  for (int i = 0; i < kD; ++i) cen[i] = p1 ? sx[c0 + i * kSS] : 0.0f;

  int buf = 0;
  for (int oy = -kR; oy <= kR; ++oy) {
    for (int ox = -kR; ox <= kR; ++ox) {
      const int shift = oy * kSS + ox;
      float* vb = sv + buf * (kTH * kVS);
      buf ^= 1;
      if (p1) {
        float d[kD];
        const float* sp = sx + c0 + shift;
#pragma unroll
        for (int i = 0; i < kD; i += 2) {
          float a = __fsub_rn(cen[i], sp[i * kSS]);
          float b = __fsub_rn(cen[i + 1], sp[(i + 1) * kSS]);
          rnd2<kBf16>(a, b);
          a = __fmul_rn(a, a);
          b = __fmul_rn(b, b);
          rnd2<kBf16>(a, b);
          d[i] = a;
          d[i + 1] = b;
        }
        if (top) {
#pragma unroll
          for (int i = 0; i < kT; ++i) d[i] = d[2 * kT - 1 - i];
        }
        if (bot) {
#pragma unroll
          for (int i = 0; i < kT; ++i) d[kD - kT + i] = d[kD - kT - 1 - i];
        }
#pragma unroll
        for (int r = 0; r < kSeg; r += 2) {
          float v = d[r], u = d[r + 1];
#pragma unroll
          for (int k = 1; k < kTpl; ++k) {
            v = __fadd_rn(v, d[r + k]);
            u = __fadd_rn(u, d[r + 1 + k]);
          }
          rnd2<kBf16>(v, u);
          vb[v0 + r * kVS] = v;
          vb[v0 + (r + 1) * kVS] = u;
        }
      }
      // The one barrier of this offset. The next offset writes the other
      // buffer, which every thread finished reading before this barrier.
      __syncthreads();
#pragma unroll
      for (int q = 0; q < kRounds3; ++q) {
        if (tid + q * kStripThreads < kTasks3) {
          float v[kC + kTpl - 1];
#pragma unroll
          for (int c = 0; c < kC + kTpl - 1; ++c) v[c] = vb[vrow[q] + c];
          const float* sp = sx + own[q] + shift;
#pragma unroll
          for (int c = 0; c < kC; c += 2) {
            float a = v[c], b = v[c + 1];
#pragma unroll
            for (int k = 1; k < kTpl; ++k) {
              a = __fadd_rn(a, v[c + k]);
              b = __fadd_rn(b, v[c + 1 + k]);
            }
            float wa = expf(__fmul_rn(a, inv)), wb = expf(__fmul_rn(b, inv));
            rnd2<kBf16>(wa, wb);
            float ta = __fmul_rn(wa, sp[c]), tb = __fmul_rn(wb, sp[c + 1]);
            rnd2<kBf16>(ta, tb);
            acc[q][c] = __fadd_rn(acc[q][c], ta);
            acc[q][c + 1] = __fadd_rn(acc[q][c + 1], tb);
            wacc[q][c] = __fadd_rn(wacc[q][c], wa);
            wacc[q][c + 1] = __fadd_rn(wacc[q][c + 1], wb);
          }
        }
      }
    }
  }
#pragma unroll
  for (int q = 0; q < kRounds3; ++q) {
    const int task = tid + q * kStripThreads;
    if (task < kTasks3) {
      const int row = task % kTH, s = task / kTH;
      float* dst =
          out + ((size_t)blockIdx.z * h + ty0 + row) * w + tx0 + s * kC;
#pragma unroll
      for (int c = 0; c < kC; ++c)
        dst[c] = __fdiv_rn(acc[q][c], fmaxf(wacc[q][c], 1e-8f));
    }
  }
}

// --- the generic body -------------------------------------------------------

template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
nlm_kernel(const float* __restrict__ img, float* __restrict__ out, int h,
           int w, int tpl, int srch, float inv, int skip_strip) {
  extern __shared__ float smem[];
  if (skip_strip && strip_tile(blockIdx.y * kTile / kTH * kTH, kTH, h) &&
      strip_tile(blockIdx.x * kTile / kTW * kTW, kTW, w))
    return;
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
           int srch, float inv, size_t smem, bool strip, bool generic,
           cudaStream_t stream) {
  cudaError_t err;
  if (strip) {
    err = cudaFuncSetAttribute(nlm_strip_kernel<kBf16>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kStripSmem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((w + kTW - 1) / kTW, (h + kTH - 1) / kTH, nb);
    nlm_strip_kernel<kBf16><<<grid, kStripThreads, kStripSmem, stream>>>(
        img, out, h, w, inv);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  if (generic) {
    err = cudaFuncSetAttribute(nlm_kernel<kBf16>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((w + kTile - 1) / kTile, (h + kTile - 1) / kTile, nb);
    nlm_kernel<kBf16><<<grid, kThreads, smem, stream>>>(img, out, h, w, tpl,
                                                        srch, inv, strip);
  }
  return (int)cudaGetLastError();
}

// Whether the strip body serves some / every tile of an axis of length n.
void strip_cover(int n, int side, bool* some, bool* every) {
  *some = false;
  *every = true;
  for (int t0 = 0; t0 < n; t0 += side) {
    const bool ok = strip_tile(t0, side, n);
    *some |= ok;
    *every &= ok;
  }
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
  bool ys = false, ye = false, xs = false, xe = false;
  if (tpl == kTpl && srch == kSrch) {
    strip_cover(h, kTH, &ys, &ye);
    strip_cover(w, kTW, &xs, &xe);
  }
  const bool strip = ys && xs, generic = !(ye && xe);
  return bf16 ? launch<true>(img, out, nb, h, w, tpl, srch, inv, smem, strip,
                             generic, stream)
              : launch<false>(img, out, nb, h, w, tpl, srch, inv, smem, strip,
                              generic, stream);
}
