// A variant of kernel F for frames of at most 16 patch rows: one launch,
// no scratch planes. A thread-block cluster takes an image, a block a band
// of 32 rows (one row of Otsu patches). Each block keeps its band's box
// mean and std in shared memory (taken 16 rows at a time over the whole
// width, so the vertical pass has a halo of win - 1 columns a band instead
// of a region), folds its largest std into the image's word, and after the
// cluster's barrier thresholds its band from shared memory: what launch 2
// of csrc/binarize.cu reads from device memory. Same device functions, so
// the same bits. tools/binarize_clahe_variants.py builds this file (with
// the port's csrc directory on the include path) and times it beside the
// shipped two-launch form.

#include "binarize.cu"

#include <cooperative_groups.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kClThreads = 512;
constexpr int kSliceH = 16;                  // rows filtered at a time
constexpr int kAtOnce = kClThreads / (kWarps2 * 32);   // patches at a time

__host__ __device__ inline int plane_pitch(int w) { return w | 1; }

size_t cluster_smem(int w, int win) {
  return (size_t)kSliceH * pitch_of(w + win - 1) * sizeof(float2) +
         (size_t)2 * kPatch * plane_pitch(w) * sizeof(float);
}

template <int WIN>
__global__ void __launch_bounds__(kClThreads, 2)
cluster_kernel(const float* __restrict__ img, int* __restrict__ stdmax,
               uint8_t* __restrict__ out, int h, int w, int win_rt, float tap,
               float k, int otsu) {
  extern __shared__ float2 sv[];
  __shared__ int best;
  __shared__ unsigned int hist[kAtOnce][256];
  __shared__ float rows[kAtOnce][2 * kPatch];
  const int win = WIN ? WIN : win_rt;
  const int pitch = plane_pitch(w);
  float* band_mean =
      reinterpret_cast<float*>(sv + kSliceH * pitch_of(w + win - 1));
  float* band_std = band_mean + kPatch * pitch;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int y0 = blockIdx.x * kPatch;
  const size_t plane = (size_t)blockIdx.y * h * w;
  if (tid == 0) best = 0;
  int top = 0;
  for (int r0 = 0; r0 < kPatch; r0 += kSliceH) {
    top = max(top, region_mean_std<WIN>(
                       img + plane, h, w, y0 + r0, 0, kSliceH, w, win_rt, tap,
                       sv, band_mean + r0 * pitch, band_std + r0 * pitch,
                       pitch, kClThreads));
    __syncthreads();      // the next slice takes sv over
  }
  top = __reduce_max_sync(kFull, top);
  if (lane == 0) atomicMax(&best, top);
  __syncthreads();
  if (tid == 0) {
    atomicMax(&stdmax[blockIdx.y], best);
    __threadfence();
  }
  cg::this_cluster().sync();
  const float smax =
      __fadd_rn(__int_as_float(__ldcg(&stdmax[blockIdx.y])), 1e-6f);

  if (!otsu) {
    for (int i = tid; i < kPatch * w; i += kClThreads) {
      const int row = i / w, col = i - row * w;
      const size_t at = plane + (size_t)(y0 + row) * w + col;
      out[at] = sauvola_on(img[at], band_mean[row * pitch + col],
                           band_std[row * pitch + col], smax, k) ? 1 : 0;
    }
    return;
  }
  const int group = warp / kWarps2, sub = warp % kWarps2;
  for (int p0 = 0; p0 < w / kPatch; p0 += kAtOnce) {
    const int px = p0 + group;
    const bool live = px < w / kPatch;
    const int in_band = (sub * kRows2) * pitch + px * kPatch + lane;
    const size_t at =
        plane + (size_t)(y0 + sub * kRows2) * w + px * kPatch + lane;
    float pix[kRows2];
#pragma unroll
    for (int r = 0; r < kRows2; ++r)
      pix[r] = live ? img[at + (size_t)r * w] : 0.0f;
    const float thr = patch_threshold(pix, hist[group], rows[group],
                                      tid % (kWarps2 * 32), lane, sub);
    if (live) {
#pragma unroll
      for (int r = 0; r < kRows2; ++r)
        out[at + (size_t)r * w] =
            sauvola_on(pix[r], band_mean[in_band + r * pitch],
                       band_std[in_band + r * pitch], smax, k) ||
                    pix[r] < thr
                ? 1
                : 0;
    }
    __syncthreads();      // the next patches take hist and rows over
  }
}

template <int WIN>
cudaError_t launch_cluster(const float* img, int* stdmax, uint8_t* out, int nb,
                           int h, int w, int win, float tap, float k, int otsu,
                           cudaStream_t stream) {
  const size_t bytes = cluster_smem(w, win);
  cudaError_t err = cudaFuncSetAttribute(
      cluster_kernel<WIN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(cluster_kernel<WIN>,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(h / kPatch, nb);
  config.blockDim = dim3(kClThreads);
  config.dynamicSmemBytes = bytes;
  config.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = h / kPatch;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  config.attrs = &attr;
  config.numAttrs = 1;
  return cudaLaunchKernelEx(&config, cluster_kernel<WIN>, img, stdmax, out, h,
                            w, win, tap, k, otsu);
}

}  // namespace

// img: (nb, h, w) float32; stdmax: (nb,) int32 scratch, zeroed by the
// caller; out: (nb, h, w) uint8 0/1. h, w multiples of 32, h at most 512, and
// a band's planes within a block's shared memory. One device launch.
extern "C" int mbfp_binarize_front_cluster(const float* img, int* stdmax,
                                           uint8_t* out, int nb, int h, int w,
                                           int win, float tap, float k,
                                           int otsu, cudaStream_t stream) {
  if (win < 1 || win > kMaxWin || !(win & 1) || nb < 1 || nb > 65535 ||
      h < kPatch || w < kPatch || h % kPatch || w % kPatch ||
      h / kPatch > 16 || cluster_smem(w, win) > 220 * 1024)
    return (int)cudaErrorInvalidValue;
  return (int)(win == 25 ? launch_cluster<25>(img, stdmax, out, nb, h, w, win,
                                              tap, k, otsu, stream)
                         : launch_cluster<0>(img, stdmax, out, nb, h, w, win,
                                             tap, k, otsu, stream));
}
