// Kernel B: connected-component labelling + per-component filter.
//
// Replaces the TPU kernels ops/pallas_cc.py:cc_filter_pallas (K4),
// _split2_pallas / clean_mask_split (K7), binary_reconstruct_pallas (K14),
// connected_components_pallas's labelling (K13), and
// ops/pallas_bitpack.py:reach_packed (K3) / border_reach_packed (K8). The TPU
// relaxed min-labels with whole-image scans to a fixpoint (and split off the
// slow canonical components onto bit-packed planes); on the card every one
// of those uses is "label the components, then keep or drop pixels by a
// per-component property", computed here without a host-side loop.
// Plain twin: ops/cuda_cc.py:cc_filter_plain / cc_label_plain.
//
// Labelling is lock-free union-find over global memory (one thread per
// pixel), union by minimum index with atomicMin on roots: every parent
// pointer only decreases and stays inside its component, so the final root
// of a component is its minimum linear index (K13's convention; background
// is 2^30). Sizes are atomicAdd counts into a (B, H*W) int32 table indexed
// by root. The work is a few passes over the image and the table, so the
// kernel is bound by memory traffic and atomics, not arithmetic.
//
// Filter modes (epilogue):
//   0 remove_small: keep fg pixels whose component has >= min_size pixels
//   1 fill_holes:   also set bg pixels whose bg component has < max_size
//   2 clean:        remove_small(min_size) then fill_holes(max_size)
//   3 largest:      keep the largest component; atomicMax on
//                   (size << 32) | (0xFFFFFFFF - root), so ties go to the
//                   smallest root
//   4 reach:        keep components that hold a marker pixel

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBackground = 1 << 30;
constexpr int kThreads = 256;

__device__ __forceinline__ bool is_fg(const uint8_t* m, size_t i, int invert) {
  return (m[i] != 0) != (invert != 0);
}

__device__ __forceinline__ int find_root(const int* L, int x) {
  const volatile int* V = L;
  int p = V[x];
  while (p != x) {
    x = p;
    p = V[x];
  }
  return x;
}

// Merge the trees of a and b, hooking the larger root under the smaller.
__device__ void unite(int* L, int a, int b) {
  bool done;
  do {
    a = find_root(L, a);
    b = find_root(L, b);
    if (a < b) {
      const int old = atomicMin(&L[b], a);
      done = (old == b);
      b = old;
    } else if (b < a) {
      const int old = atomicMin(&L[a], b);
      done = (old == a);
      a = old;
    } else {
      done = true;
    }
  } while (!done);
}

__global__ void cc_init(const uint8_t* __restrict__ mask, int invert,
                        int* __restrict__ label, int* __restrict__ table,
                        unsigned long long* __restrict__ key, size_t total,
                        int hw, int nb) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < (size_t)nb && key != nullptr) key[i] = 0ull;
  if (i >= total) return;
  label[i] = is_fg(mask, i, invert) ? (int)(i % hw) : kBackground;
  if (table != nullptr) table[i] = 0;
}

__global__ void cc_merge(const uint8_t* __restrict__ mask, int invert,
                         int* label, size_t total, int h, int w, int conn) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total || !is_fg(mask, i, invert)) return;
  const size_t hw = (size_t)h * w;
  const size_t base = (i / hw) * hw;
  const int p = (int)(i - base);
  const int y = p / w, x = p - y * w;
  int* L = label + base;
  const uint8_t* M = mask + base;
  if (x > 0 && is_fg(M, p - 1, invert)) unite(L, p, p - 1);
  if (y > 0) {
    if (is_fg(M, p - w, invert)) unite(L, p, p - w);
    if (conn == 2) {
      if (x > 0 && is_fg(M, p - w - 1, invert)) unite(L, p, p - w - 1);
      if (x < w - 1 && is_fg(M, p - w + 1, invert)) unite(L, p, p - w + 1);
    }
  }
}

// label[p] <- root of p. In place: a concurrent find that passes through p
// sees either p's old parent or its root, both ancestors of p.
__global__ void cc_compress(const uint8_t* __restrict__ mask, int invert,
                            int* label, size_t total, int hw) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total || !is_fg(mask, i, invert)) return;
  const size_t base = (i / hw) * hw;
  label[i] = find_root(label + base, (int)(i - base));
}

// Per-root size (mode 0) or marker flag (mode 4).
__global__ void cc_tally(const uint8_t* mask, int invert,
                         const uint8_t* __restrict__ marker,
                         const int* __restrict__ label, int* table,
                         size_t total, int hw, int mode) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total || !is_fg(mask, i, invert)) return;
  const size_t b = i / hw;
  const int root = label[i];
  if (mode == 4) {
    if (marker[i] != 0) table[b * hw + root] = 1;
  } else {
    atomicAdd(&table[b * hw + root], 1);
  }
}

__global__ void cc_largest_key(const uint8_t* __restrict__ mask,
                               const int* __restrict__ label,
                               const int* __restrict__ table,
                               unsigned long long* key, size_t total, int hw) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total || mask[i] == 0) return;
  const size_t b = i / hw;
  const int p = (int)(i - b * hw);
  if (label[i] != p) return;  // one candidate per component: its root
  const unsigned long long k =
      ((unsigned long long)(unsigned)table[i] << 32) |
      (unsigned long long)(0xFFFFFFFFu - (unsigned)p);
  atomicMax(&key[b], k);
}

// out = f(mask, per-root value). In the second phase of mode 2, mask and
// out are the same buffer: each thread reads its own pixel, then writes it.
__global__ void cc_epilogue(const uint8_t* mask,
                            const int* __restrict__ label,
                            const int* __restrict__ table,
                            const unsigned long long* __restrict__ key,
                            uint8_t* out, size_t total, int hw, int mode,
                            int min_size, int max_size) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const size_t b = i / hw;
  const bool fg = mask[i] != 0;
  bool keep;
  if (mode == 0) {
    keep = fg && table[b * hw + label[i]] >= min_size;
  } else if (mode == 1) {
    keep = fg || table[b * hw + label[i]] < max_size;
  } else if (mode == 3) {
    const unsigned winner = 0xFFFFFFFFu - (unsigned)(key[b] & 0xFFFFFFFFull);
    keep = fg && key[b] != 0ull && (unsigned)label[i] == winner;
  } else {  // mode 4
    keep = fg && table[b * hw + label[i]] != 0;
  }
  out[i] = keep ? 1 : 0;
}

inline unsigned blocks_for(size_t total) {
  return (unsigned)((total + kThreads - 1) / kThreads);
}

int label_pass(const uint8_t* mask, int invert, int* label, int* table,
               unsigned long long* key, int nb, int h, int w, int conn,
               cudaStream_t s) {
  const size_t total = (size_t)nb * h * w;
  const unsigned g = blocks_for(total);
  cc_init<<<g, kThreads, 0, s>>>(mask, invert, label, table, key, total, h * w,
                                  nb);
  cc_merge<<<g, kThreads, 0, s>>>(mask, invert, label, total, h, w, conn);
  cc_compress<<<g, kThreads, 0, s>>>(mask, invert, label, total, h * w);
  return (int)cudaGetLastError();
}

}  // namespace

// label: (nb, h*w) int32 out; root (min linear index) or 2^30 for background.
extern "C" int mbfp_cc_label(const uint8_t* mask, int invert, int* label,
                             int nb, int h, int w, int conn,
                             cudaStream_t stream) {
  return label_pass(mask, invert, label, nullptr, nullptr, nb, h, w, conn,
                    stream);
}

// mask, marker, out: (nb, h, w) uint8 0/1 (marker only read in mode 4);
// label, table: (nb, h*w) int32 scratch; key: (nb,) uint64 scratch.
extern "C" int mbfp_cc_filter(const uint8_t* mask, const uint8_t* marker,
                              uint8_t* out, int* label, int* table,
                              unsigned long long* key, int nb, int h, int w,
                              int conn, int mode, int min_size, int max_size,
                              cudaStream_t stream) {
  const size_t total = (size_t)nb * h * w;
  const int hw = h * w;
  const unsigned g = blocks_for(total);
  int err;
  if (mode == 0 || mode == 2 || mode == 3 || mode == 4) {
    if ((err = label_pass(mask, 0, label, table, key, nb, h, w, conn, stream)))
      return err;
    cc_tally<<<g, kThreads, 0, stream>>>(mask, 0, marker, label, table,
                                          total, hw, mode == 4 ? 4 : 0);
    if (mode == 3)
      cc_largest_key<<<g, kThreads, 0, stream>>>(mask, label, table, key,
                                                  total, hw);
    cc_epilogue<<<g, kThreads, 0, stream>>>(mask, label, table, key, out,
                                             total, hw, mode == 2 ? 0 : mode,
                                             min_size, max_size);
    if ((err = (int)cudaGetLastError())) return err;
    if (mode != 2) return 0;
  }
  // fill_holes on `mask` (mode 1) or on the objects kept above (mode 2)
  const uint8_t* src = (mode == 2) ? out : mask;
  if ((err = label_pass(src, 1, label, table, key, nb, h, w, conn, stream)))
    return err;
  cc_tally<<<g, kThreads, 0, stream>>>(src, 1, marker, label, table, total,
                                        hw, 0);
  cc_epilogue<<<g, kThreads, 0, stream>>>(src, label, table, key, out, total,
                                           hw, 1, min_size, max_size);
  return (int)cudaGetLastError();
}
