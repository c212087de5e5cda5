// Kernel A: CLAHE (contrast-limited adaptive histogram equalization).
//
// Replaces the TPU kernel ops/pallas_kernels.py:clahe_pallas
// (_clahe_kernel_v2 / _clahe_kernel). Plain twin: ops/cuda_kernels.py:
// clahe_plain. Bound on the card by memory traffic: the image is read twice
// and written once (12 bytes a pixel against the function's 8), and the
// LUTs are 256 bytes a tile.
//
// Pass 1 (one block per (tile, image)): the warps count into kSubs
// histograms in shared memory (the first pixels are loaded before these are
// zeroed). Then a thread a bin: clip at `limit`, sum the excess over the
// block, spread it as excess/256 and take the CDF as a shuffle scan. The
// excess sums integer-valued floats and the CDF multiples of 2^-8 up to the
// tile's area, both exact in float32 in any order while the area is at
// most 65,536, so the LUT keeps the twin's bits; a larger tile keeps the
// twin's serial order. The LUT is rounded half to even (rintf, as torch.round) and
// stored as bytes.
//
// Pass 2 (one block per (tile, image), lanes along a row): stages the LUTs
// of the 3 x 3 neighbouring tiles in shared memory and one entry a row of
// the tile (the two LUT rows and the weight); a thread keeps its column's
// entry in registers, and loads its first kBatch pixels before the LUTs
// are staged. A pixel then costs one coalesced load, four byte loads from
// shared memory, the blend with every multiply and add rounded
// separately (__fmul_rn/__fadd_rn: no FMA contraction against the twin), a
// true division by 255 and one coalesced store.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSubs = 2;            // histograms a block of pass 1 counts into
constexpr int kBatch = 8;           // rows a thread of pass 2 loads at once
constexpr int kExactArea = 65536;   // largest tile whose sums are order-free
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int to_u8(float v) {
  float r = rintf(__fmul_rn(v, 255.0f));
  return (int)fminf(fmaxf(r, 0.0f), 255.0f);
}

__global__ void __launch_bounds__(kThreads)
clahe_lut_kernel(const float* __restrict__ img, uint8_t* __restrict__ lut,
                 int h, int w, int grid, float limit, float scale) {
  __shared__ unsigned int sub[kSubs][256];
  __shared__ float hist[256];
  __shared__ float part[2][kWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tile = blockIdx.x;
  const int ty = tile / grid, tx = tile - ty * grid;
  const int th = h / grid, tw = w / grid;
  const float* base = img + (size_t)blockIdx.y * h * w + (ty * th) * w + tx * tw;
  const bool vec = tw % 4 == 0 && w % 4 == 0;
  const int quads = tw / 4;
  // the thread's first pixels, on their way while the histograms are zeroed
  float4 first = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (vec && tid < th * quads)
    first = *reinterpret_cast<const float4*>(base + tid / quads * w +
                                             4 * (tid % quads));
  for (int i = tid; i < kSubs * 256; i += kThreads) (&sub[0][0])[i] = 0u;
  __syncthreads();
  unsigned int* mine = sub[warp % kSubs];
  if (vec) {
    for (int p = tid; p < th * quads; p += kThreads) {
      const int r = p / quads, c = p - r * quads;
      const float4 v = p == tid ? first : *reinterpret_cast<const float4*>(
                                              base + r * w + 4 * c);
      atomicAdd(&mine[to_u8(v.x)], 1u);
      atomicAdd(&mine[to_u8(v.y)], 1u);
      atomicAdd(&mine[to_u8(v.z)], 1u);
      atomicAdd(&mine[to_u8(v.w)], 1u);
    }
  } else {
    for (int p = tid; p < th * tw; p += kThreads) {
      const int r = p / tw, c = p - r * tw;
      atomicAdd(&mine[to_u8(base[r * w + c])], 1u);
    }
  }
  __syncthreads();
  unsigned int cnt = 0;
#pragma unroll
  for (int k = 0; k < kSubs; ++k) cnt += sub[k][tid];
  const float hf = (float)cnt;
  uint8_t* out = lut + ((size_t)blockIdx.y * grid * grid + tile) * 256;

  if (th * tw > kExactArea) {     // the twin's serial order
    hist[tid] = hf;
    __syncthreads();
    if (tid == 0) {
      float excess = 0.0f;
      for (int i = 0; i < 256; ++i)
        excess = __fadd_rn(excess, fmaxf(__fsub_rn(hist[i], limit), 0.0f));
      const float add = __fdiv_rn(excess, 256.0f);
      float cdf = 0.0f;
      for (int i = 0; i < 256; ++i) {
        cdf = __fadd_rn(cdf, __fadd_rn(fminf(hist[i], limit), add));
        out[i] = (uint8_t)fminf(
            fmaxf(rintf(__fmul_rn(cdf, scale)), 0.0f), 255.0f);
      }
    }
    return;
  }

  // a thread a bin: excess over the block, then the CDF as a scan
  float ex = fmaxf(__fsub_rn(hf, limit), 0.0f);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    ex = __fadd_rn(ex, __shfl_xor_sync(kFull, ex, off));
  float cdf = fminf(hf, limit);      // the spread excess is added below
  if (lane == 0) part[0][warp] = ex;
  __syncthreads();
  float excess = 0.0f;
#pragma unroll
  for (int k = 0; k < kWarps; ++k) excess = __fadd_rn(excess, part[0][k]);
  cdf = __fadd_rn(cdf, __fdiv_rn(excess, 256.0f));
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float up = __shfl_up_sync(kFull, cdf, off);
    if (lane >= off) cdf = __fadd_rn(cdf, up);
  }
  if (lane == 31) part[1][warp] = cdf;
  __syncthreads();
  float before = 0.0f;
  for (int k = 0; k < warp; ++k) before = __fadd_rn(before, part[1][k]);
  cdf = __fadd_rn(before, cdf);
  out[tid] = (uint8_t)fminf(fmaxf(rintf(__fmul_rn(cdf, scale)), 0.0f), 255.0f);
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

// A pixel of tile t blends tiles t - 1 .. t + 1 only: its slot among the
// three staged LUT rows or columns.
__device__ __forceinline__ int slot(int tile, int own) {
  return min(max(tile - own + 1, 0), 2);
}

__global__ void __launch_bounds__(kThreads)
clahe_apply_kernel(const float* __restrict__ img,
                   const uint8_t* __restrict__ lut, float* __restrict__ out,
                   int h, int w, int grid) {
  __shared__ uint32_t staged[9][64];   // LUTs of the 3 x 3 tiles, as bytes
  extern __shared__ int4 rows[];       // per row: slot*3 of lo, of hi; weights
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tile = blockIdx.x;
  const int ty = tile / grid, tx = tile - ty * grid;
  const int th = h / grid, tw = w / grid;
  const uint32_t* luts = reinterpret_cast<const uint32_t*>(
      lut + (size_t)blockIdx.y * grid * grid * 256);
  const size_t plane = (size_t)blockIdx.y * h * w;
  const int corner = (ty * th) * w + tx * tw;
  // the thread's first pixels, on their way while the LUTs are staged
  float px[kBatch];
#pragma unroll
  for (int i = 0; i < kBatch; ++i) {
    const int r = warp + i * kWarps;
    px[i] = lane < tw && r < th ? img[plane + corner + r * w + lane] : 0.0f;
  }
  for (int i = tid; i < 9 * 64; i += kThreads) {
    const int s = i >> 6;
    const int ny = min(max(ty - 1 + s / 3, 0), grid - 1);
    const int nx = min(max(tx - 1 + s % 3, 0), grid - 1);
    staged[s][i & 63] = luts[(ny * grid + nx) * 64 + (i & 63)];
  }
  for (int r = tid; r < th; r += kThreads) {
    int y0, y1;
    float wy1;
    blend_coord(ty * th + r, th, grid, &y0, &y1, &wy1);
    rows[r] = make_int4(3 * slot(y0, ty), 3 * slot(y1, ty),
                        __float_as_int(__fsub_rn(1.0f, wy1)),
                        __float_as_int(wy1));
  }
  __syncthreads();
  const uint8_t* bytes = reinterpret_cast<const uint8_t*>(&staged[0][0]);
  for (int c = lane; c < tw; c += 32) {
    int x0, x1;
    float wx1;
    blend_coord(tx * tw + c, tw, grid, &x0, &x1, &wx1);
    const float wx0 = __fsub_rn(1.0f, wx1);
    const int s0 = slot(x0, tx), s1 = slot(x1, tx);
    for (int r0 = warp; r0 < th; r0 += kWarps * kBatch) {
      if (c != lane || r0 != warp) {
#pragma unroll
        for (int i = 0; i < kBatch; ++i) {
          const int r = r0 + i * kWarps;
          px[i] = r < th ? img[plane + corner + r * w + c] : 0.0f;
        }
      }
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const int r = r0 + i * kWarps;
        if (r >= th) break;
        const int4 row = rows[r];
        const float wy0 = __int_as_float(row.z), wy1 = __int_as_float(row.w);
        const int v = to_u8(px[i]);
        const uint8_t* lo = bytes + row.x * 256 + v;
        const uint8_t* hi = bytes + row.y * 256 + v;
        float acc = __fmul_rn((float)lo[s0 * 256], __fmul_rn(wy0, wx0));
        acc = __fadd_rn(acc, __fmul_rn((float)lo[s1 * 256], __fmul_rn(wy0, wx1)));
        acc = __fadd_rn(acc, __fmul_rn((float)hi[s0 * 256], __fmul_rn(wy1, wx0)));
        acc = __fadd_rn(acc, __fmul_rn((float)hi[s1 * 256], __fmul_rn(wy1, wx1)));
        out[plane + corner + r * w + c] =
            fminf(fmaxf(__fdiv_rn(acc, 255.0f), 0.0f), 1.0f);
      }
    }
  }
}

}  // namespace

// img, out: (nb, h, w) float32; lut: (nb, grid, grid, 256) uint8 scratch, the
// tiles' LUTs when the call returns. h, w multiples of grid; h * w below
// 2^31. Two device launches.
extern "C" int mbfp_clahe(const float* img, uint8_t* lut, float* out, int nb,
                          int h, int w, int grid, float limit, float scale,
                          cudaStream_t stream) {
  const size_t row_bytes = (size_t)(grid > 0 ? h / grid : 0) * sizeof(int4);
  if (nb < 1 || nb > 65535 || grid < 1 || grid > 32768 || h < grid ||
      w < grid || h % grid || w % grid || (long long)h * w > 0x7fffffffLL ||
      row_bytes > 40 * 1024)
    return (int)cudaErrorInvalidValue;
  const dim3 blocks(grid * grid, nb);
  clahe_lut_kernel<<<blocks, kThreads, 0, stream>>>(img, lut, h, w, grid,
                                                    limit, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  clahe_apply_kernel<<<blocks, kThreads, row_bytes, stream>>>(img, lut, out, h,
                                                              w, grid);
  return (int)cudaGetLastError();
}
