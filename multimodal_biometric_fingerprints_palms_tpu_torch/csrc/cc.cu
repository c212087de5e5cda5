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
// Bound: bytes (a mask in, a mask or a label plane out); what costs is
// atomics and dependent loads through L2. So a label pass works in shared
// memory and goes to device memory only where tiles meet:
//
//   cc_local    one block per 32x32 tile. A warp turns each mask row into a
//               32-bit word (__ballot_sync); a pixel finds the start of its
//               horizontal run with __clz, so the pixels of a run need no
//               union. Runs of neighbouring rows unite in shared memory
//               (lock-free union-find, atomicMin on roots; once per pair of
//               touching runs, and for 8-connectivity also against the
//               upper row's diagonal neighbours). Per local root the tile
//               counts its pixels (one shared atomicAdd per run) or notes a
//               marker pixel. It writes every pixel's label as the global
//               index of its local root, and the root's count or flag into
//               the table (-1 at every other pixel).
//   cc_seams    one thread per pixel on a tile's first row or first column
//               unites it with its neighbours across the seam, in device
//               memory, with the same union-find.
//   cc_roots    every local root finds its global root, points at it and
//               adds its count to the global root's: one global atomic per
//               tile and component, not per pixel.
//   cc_epilogue a pixel reaches its global root in two loads (its local
//               root, then that root's parent) and keeps or drops itself.
//
// Every parent pointer only decreases and stays inside its component, and
// row-major order inside a tile is the global order restricted to it, so the
// final root of a component is its minimum linear index (K13's convention;
// background is 2^30). mbfp_cc_label ends with cc_compress instead (every
// pixel's label becomes its global root).
//
// Filter modes (epilogue):
//   0 remove_small: keep fg pixels whose component has >= min_size pixels
//   1 fill_holes:   also set bg pixels whose bg component has < max_size
//   2 clean:        remove_small(min_size) then fill_holes(max_size); the
//                   second pass labels the inverse of the first's output
//   3 largest:      keep the largest component; atomicMax on
//                   (size << 32) | (0xFFFFFFFF - root), so ties go to the
//                   smallest root
//   4 reach:        keep components that hold a marker pixel

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBackground = 1 << 30;
constexpr int kThreads = 256;
constexpr int kTile = 32;                    // a tile row is one ballot word
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = kTile / kWarps;
constexpr unsigned kFull = 0xFFFFFFFFu;

// What cc_local leaves in the table for a local root.
enum Tally { kNone = 0, kSize = 1, kMarker = 2 };

__device__ __forceinline__ bool is_fg(const uint8_t* m, size_t i, int invert) {
  return (m[i] != 0) != (invert != 0);
}

// Works on device and on shared memory alike.
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

__device__ __forceinline__ bool bit(unsigned word, int x) {
  return x >= 0 && x < 32 && ((word >> x) & 1u);
}

// First pixel of the run of set bits that holds bit x (which is set).
__device__ __forceinline__ int run_start(unsigned word, int x) {
  const unsigned zeros_below = ~word & ((1u << x) - 1u);
  return zeros_below ? 32 - __clz(zeros_below) : 0;
}

// One past the last pixel of that run.
__device__ __forceinline__ int run_end(unsigned word, int x) {
  const unsigned zeros_above = ~word & ~((2u << x) - 1u);
  return zeros_above ? __ffs(zeros_above) - 1 : 32;
}

// Tile t of an image: its origin, from the linear block index.
struct TileAt {
  int b, ty0, tx0;
};
__device__ __forceinline__ TileAt tile_at(unsigned blk, int tiles_x,
                                          int tiles_y) {
  const int per = tiles_x * tiles_y;
  const int t = (int)(blk % per);
  return {(int)(blk / per), t / tiles_x * kTile, t % tiles_x * kTile};
}

__global__ void __launch_bounds__(kThreads)
cc_local(const uint8_t* __restrict__ mask, int invert,
         const uint8_t* __restrict__ marker, int* __restrict__ label,
         int* __restrict__ table, unsigned long long* __restrict__ key,
         int h, int w, int tiles_x, int tiles_y, int conn, int tally) {
  __shared__ unsigned rows[kTile];
  __shared__ int lab[kTile * kTile];
  __shared__ int val[kTile * kTile];
  const TileAt t = tile_at(blockIdx.x, tiles_x, tiles_y);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t base = (size_t)t.b * h * w;
  const int x = t.tx0 + lane;
  if (key != nullptr && t.ty0 == 0 && t.tx0 == 0 && threadIdx.x == 0)
    key[t.b] = 0ull;

  // 1. row words; every pixel of a run starts as a child of the run's start
  bool fg[kRowsPerWarp];
  int node[kRowsPerWarp];       // this pixel's run start, then its local root
#pragma unroll
  for (int k = 0; k < kRowsPerWarp; ++k) {
    const int r = warp + k * kWarps, y = t.ty0 + r;
    fg[k] = y < h && x < w && is_fg(mask, base + (size_t)y * w + x, invert);
    const unsigned word = __ballot_sync(kFull, fg[k]);
    if (lane == 0) rows[r] = word;
    node[k] = r * kTile + (fg[k] ? run_start(word, lane) : lane);
    lab[r * kTile + lane] = node[k];
    val[r * kTile + lane] = 0;
  }
  __syncthreads();

  // 2. unite each run with the runs it touches in the row above; of the
  // pixels that see the same pair of runs only the first does it
#pragma unroll
  for (int k = 0; k < kRowsPerWarp; ++k) {
    const int r = warp + k * kWarps;
    if (r == 0 || !fg[k]) continue;
    const unsigned cur = rows[r], up = rows[r - 1];
    const int above = (r - 1) * kTile;
    if (bit(up, lane)) {
      if (!(bit(cur, lane - 1) && bit(up, lane - 1)))
        unite(lab, node[k], above + run_start(up, lane));
    } else if (conn == 2) {
      if (bit(up, lane - 1) && !bit(cur, lane - 1))
        unite(lab, node[k], above + run_start(up, lane - 1));
      if (bit(up, lane + 1) && !bit(cur, lane + 1))
        unite(lab, node[k], above + run_start(up, lane + 1));
    }
  }
  __syncthreads();

  // 3. local roots; a run's first pixel tallies the run
#pragma unroll
  for (int k = 0; k < kRowsPerWarp; ++k) {
    if (!fg[k]) continue;
    const int r = warp + k * kWarps;
    const bool first = node[k] == r * kTile + lane;
    node[k] = find_root(lab, node[k]);
    if (tally == kSize) {
      if (first)
        atomicAdd(&val[node[k]], run_end(rows[r], lane) - lane);
    } else if (tally == kMarker) {
      if (marker[base + (size_t)(t.ty0 + r) * w + x] != 0) val[node[k]] = 1;
    }
  }
  __syncthreads();

  // 4. labels as global indices; the table holds a local root's tally
#pragma unroll
  for (int k = 0; k < kRowsPerWarp; ++k) {
    const int r = warp + k * kWarps, y = t.ty0 + r;
    if (y >= h || x >= w) continue;
    const size_t i = base + (size_t)y * w + x;
    const int root = node[k];
    label[i] = fg[k] ? (t.ty0 + root / kTile) * w + t.tx0 + root % kTile
                     : kBackground;
    if (table != nullptr)
      table[i] = (fg[k] && root == r * kTile + lane) ? val[root] : -1;
  }
}

// Unite p with q if q is inside the frame and labelled.
__device__ __forceinline__ void seam(int* L, int p, int qy, int qx, int h,
                                     int w) {
  if (qy < 0 || qy >= h || qx < 0 || qx >= w) return;
  const int q = qy * w + qx;
  if (L[q] != kBackground) unite(L, p, q);
}

// Pixels on a tile's first row meet the tile above (and its neighbours'
// corners); pixels on a tile's first column meet the tile to the left. Every
// adjacency across a seam is seen from one of the two.
__global__ void cc_seams(int* label, size_t total, int h, int w, int seam_rows,
                         int seam_cols, int conn) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int per = seam_rows * w + seam_cols * h;
  int* L = label + (i / per) * ((size_t)h * w);
  int r = (int)(i % per);
  if (r < seam_rows * w) {
    const int y = (r / w + 1) * kTile, x = r % w, p = y * w + x;
    if (L[p] == kBackground) return;
    seam(L, p, y - 1, x, h, w);
    if (conn == 2) {
      seam(L, p, y - 1, x - 1, h, w);
      seam(L, p, y - 1, x + 1, h, w);
    }
  } else {
    r -= seam_rows * w;
    const int x = (r / h + 1) * kTile, y = r % h, p = y * w + x;
    if (L[p] == kBackground) return;
    seam(L, p, y, x - 1, h, w);
    if (conn == 2) {
      seam(L, p, y - 1, x - 1, h, w);
      seam(L, p, y + 1, x - 1, h, w);
    }
  }
}

// A local root that is not its component's global root points at it and
// hands it its tally. Nothing adds to a table entry that is read here: only
// global roots receive.
__global__ void cc_roots(int* label, int* table, size_t total, int hw) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int v = table[i];
  if (v < 0) return;
  const size_t base = (i / hw) * hw;
  const int p = (int)(i - base);
  const int g = find_root(label + base, p);
  if (g == p) return;
  label[i] = g;
  if (v > 0) atomicAdd(&table[base + g], v);
}

// label[p] <- root of p. In place: a concurrent find that passes through p
// sees either p's old parent or its root, both ancestors of p.
__global__ void cc_compress(int* label, size_t total, int hw) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total || label[i] == kBackground) return;
  const size_t base = (i / hw) * hw;
  label[i] = find_root(label + base, (int)(i - base));
}

// One candidate per component: its global root, after cc_roots.
__global__ void cc_largest_key(const int* __restrict__ label,
                               const int* __restrict__ table,
                               unsigned long long* key, size_t total, int hw) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total || table[i] < 0) return;
  const size_t b = i / hw;
  const int p = (int)(i - b * hw);
  if (label[i] != p) return;
  const unsigned long long k =
      ((unsigned long long)(unsigned)table[i] << 32) |
      (unsigned long long)(0xFFFFFFFFu - (unsigned)p);
  atomicMax(&key[b], k);
}

// out = f(mask, per-root value), after cc_roots: a labelled pixel's label is
// its local root, whose label is the global root. In the second phase of
// mode 2, mask and out are the same buffer: each thread reads its own pixel,
// then writes it.
__global__ void cc_epilogue(const uint8_t* mask,
                            const int* __restrict__ label,
                            const int* __restrict__ table,
                            const unsigned long long* __restrict__ key,
                            uint8_t* out, size_t total, int hw, int mode,
                            int min_size, int max_size) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const size_t base = (i / hw) * hw;
  const bool fg = mask[i] != 0;
  bool keep;
  if (mode == 1) {
    keep = fg || table[base + label[base + label[i]]] < max_size;
  } else if (!fg) {
    keep = false;
  } else {
    const int root = label[base + label[i]];
    if (mode == 0) {
      keep = table[base + root] >= min_size;
    } else if (mode == 3) {
      const unsigned long long k = key[i / hw];
      keep = k != 0ull &&
             (unsigned)root == 0xFFFFFFFFu - (unsigned)(k & 0xFFFFFFFFull);
    } else {  // mode 4
      keep = table[base + root] != 0;
    }
  }
  out[i] = keep ? 1 : 0;
}

inline unsigned blocks_for(size_t total) {
  return (unsigned)((total + kThreads - 1) / kThreads);
}

// Labels the components of mask (of its inverse if invert): after it every
// labelled pixel is in its component's tree, at most two steps below a
// local root; `table` (may be null) holds the local roots' tallies.
int label_pass(const uint8_t* mask, int invert, const uint8_t* marker,
               int* label, int* table, unsigned long long* key, int nb, int h,
               int w, int conn, int tally, cudaStream_t s) {
  const int tiles_x = (w + kTile - 1) / kTile;
  const int tiles_y = (h + kTile - 1) / kTile;
  cc_local<<<(unsigned)nb * tiles_x * tiles_y, kThreads, 0, s>>>(
      mask, invert, marker, label, table, key, h, w, tiles_x, tiles_y, conn,
      tally);
  const int seam_rows = tiles_y - 1, seam_cols = tiles_x - 1;
  const size_t seams = (size_t)nb * ((size_t)seam_rows * w + seam_cols * h);
  if (seams)
    cc_seams<<<blocks_for(seams), kThreads, 0, s>>>(label, seams, h, w,
                                                     seam_rows, seam_cols,
                                                     conn);
  return (int)cudaGetLastError();
}

}  // namespace

// label: (nb, h*w) int32 out; root (min linear index) or 2^30 for background.
extern "C" int mbfp_cc_label(const uint8_t* mask, int invert, int* label,
                             int nb, int h, int w, int conn,
                             cudaStream_t stream) {
  const int err = label_pass(mask, invert, nullptr, label, nullptr, nullptr,
                             nb, h, w, conn, kNone, stream);
  if (err) return err;
  const size_t total = (size_t)nb * h * w;
  cc_compress<<<blocks_for(total), kThreads, 0, stream>>>(label, total, h * w);
  return (int)cudaGetLastError();
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
    if ((err = label_pass(mask, 0, marker, label, table, key, nb, h, w, conn,
                          mode == 4 ? kMarker : kSize, stream)))
      return err;
    cc_roots<<<g, kThreads, 0, stream>>>(label, table, total, hw);
    if (mode == 3)
      cc_largest_key<<<g, kThreads, 0, stream>>>(label, table, key, total, hw);
    cc_epilogue<<<g, kThreads, 0, stream>>>(mask, label, table, key, out,
                                             total, hw, mode == 2 ? 0 : mode,
                                             min_size, max_size);
    if ((err = (int)cudaGetLastError())) return err;
    if (mode != 2) return 0;
  }
  // fill_holes on `mask` (mode 1) or on the objects kept above (mode 2)
  const uint8_t* src = (mode == 2) ? out : mask;
  if ((err = label_pass(src, 1, marker, label, table, key, nb, h, w, conn,
                        kSize, stream)))
    return err;
  cc_roots<<<g, kThreads, 0, stream>>>(label, table, total, hw);
  cc_epilogue<<<g, kThreads, 0, stream>>>(src, label, table, key, out, total,
                                           hw, 1, min_size, max_size);
  return (int)cudaGetLastError();
}
