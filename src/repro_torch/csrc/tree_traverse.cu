// Integer-only tree-ensemble traversal for Hopper (sm_90a): kernels K1, K2
// and K3.
//
// All three kernels compute, for every row r and class c,
//
//     out[r, c] = sum over trees t of leaf_fixed[t, leaf(t, r), c]   (mod 2^32)
//
// where leaf(t, r) is the leaf row r reaches in tree t under the compare
// `x_keys[r, feature] <= threshold_key` (signed int32, paper Listing 2).  The
// tables are the dense (T, N) node tables of the ForestIR `leaf_major` (K1) or
// `padded`/`leaf_major` (K2, K3) layout; leaves self-loop and carry feature -1.
// K3 differs from K2 only on malformed tables: every read outside its table
// (a node outside [0, N), a feature index outside [0, F)) reads 0.
//
// Design (`walk_tile`, one body for all three; the walk mode picks the
// kernel).  A CTA holds `rows_per_cta` rows, one per thread, and one chunk of
// `trees_per_cta` trees (grid.y); grid.z carries class chunks of up to
// kClassChunk classes, summed in registers.  Four things answer what bounded
// the first version, where each level of a walk read four node tables, one
// row value and, at the end, C single leaf words:
//   (a) node quads: {feature, key, left, right} of a node are one int4 of a
//       (T, N, 4) table, so a level reads one 16-byte line through the
//       read-only path (one sector, not four);
//   (b) a staged row tile: the CTA copies its rows of x into shared memory
//       once (cp.async, coalesced), before its tree loop, with a row stride
//       of F rounded up to odd, so 32 rows reading one feature hit 32 banks.
//       Where even a 32-row tile does not fit in a CTA's 227 KB, the wrapper
//       launches the variant that reads x from global memory: it picks by
//       shape, before the launch;
//   (c) several trees in flight: each thread advances `walks` independent
//       walks (trees t, t+1, ...) in one loop, so `walks` dependent chains
//       of loads are in flight per thread; left-over trees of a chunk walk
//       one at a time;
//   (d) leaf rows as 16-byte loads where C % 4 == 0 and the table is 16-byte
//       aligned, single words otherwise.
// No read leaves a buffer on any table: every index is clamped into its
// buffer first (a node into [0, N), a feature into [0, F), a prefix length
// into [0, N]).  K1 and K2 read what the clamped index holds, so their
// function on a malformed table is undefined, as their plain versions' is;
// K3 (masked) selects each such read to 0, branch-free.
//
// Shared by all three: the TPU kernels carried the output block through a
// sequential grid; CTAs run in no order here, so the wrapper zeroes the
// output and each CTA adds its chunk's sums with a 32-bit unsigned
// atomicAdd.  Integer addition commutes, so the order of the atomics cannot
// change a bit.  Ragged edges (rows past B, trees past T, classes past C)
// are masked, not padded.
//
// What bounds them.  Per (row, tree) a walk is a chain of dependent loads,
// about ten levels deep for a depth-10 tree.  The bytes that must move are
// small (the full-width tables are ~12.6 MB and stay in the 50 MB L2), so
// the kernels are bound by L1/L2 sector traffic and load latency, not by
// HBM bandwidth or arithmetic: (a) and (d) cut the sectors per walk, (b)
// takes x off the L1/L2 path, and (c) keeps more of the chain's loads in
// flight where (b) lowers the rows resident on an SM.  K3's masks add a
// compare and a select per read and no load.
//
// Each host entry launches on the caller's stream and returns
// cudaGetLastError(), which the Python wrapper turns into an exception.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kClassChunk = 8;
// the most rows a CTA takes (registers: 65,536 / 512 = 128 a thread)
constexpr int kMaxTileRows = 512;
// shared memory a CTA may take on sm_90 (227 KB), and what needs opting in
constexpr size_t kMaxSmemPerCta = 232448;
constexpr size_t kDefaultSmem = 48 * 1024;

// The walk of each kernel: K1's prefix-bounded walk, K2's `depth` gather
// levels, and K3's `depth` levels with every read outside its table read as 0.
enum class Walk { kBounded, kGather, kMasked };

struct TileArgs {
  const int* x;                 // (B, F) keys
  const int4* quads;            // (T, N) nodes {feature, key, left, right}
  const int* internal_counts;   // (T,), K1 only
  const unsigned* leaf;         // (T, N, C)
  unsigned* out;                // (B, C), zeroed by the caller
  int B, F, T, N, C, depth, trees_per_cta;
};

__device__ __forceinline__ void flush_row(unsigned* __restrict__ out_row,
                                          const unsigned (&acc)[kClassChunk],
                                          int classes_left) {
#pragma unroll
  for (int c = 0; c < kClassChunk; ++c) {
    if (c < classes_left) atomicAdd(out_row + c, acc[c]);
  }
}

// (d): one leaf row's classes [c0, c0 + classes_left) into acc; `vec` reads
// them as uint4 (C % 4 == 0 and a 16-byte aligned table, so every row and
// class chunk starts on 16 bytes and classes_left is a multiple of 4).  `ok`
// false adds a zero row (K3's final node outside the table); the row pointer
// must then still point into the table.
__device__ __forceinline__ void add_leaf(unsigned (&acc)[kClassChunk],
                                         const unsigned* __restrict__ leaf_row,
                                         int classes_left, bool vec, bool ok) {
  const unsigned keep = ok ? ~0u : 0u;
  if (vec) {
#pragma unroll
    for (int j = 0; j < kClassChunk / 4; ++j) {
      if (4 * j < classes_left) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(leaf_row) + j);
        acc[4 * j] += v.x & keep;
        acc[4 * j + 1] += v.y & keep;
        acc[4 * j + 2] += v.z & keep;
        acc[4 * j + 3] += v.w & keep;
      }
    }
  } else {
#pragma unroll
    for (int c = 0; c < kClassChunk; ++c) {
      if (c < classes_left) acc[c] += __ldg(leaf_row + c) & keep;
    }
  }
}

__device__ __forceinline__ int clamp_index(int i, int n) {
  return static_cast<int>(min(static_cast<unsigned>(i), static_cast<unsigned>(n - 1)));
}

__device__ __forceinline__ bool in_table(int i, int n) {
  return static_cast<unsigned>(i) < static_cast<unsigned>(n);
}

// One level: x[row, max(f, 0)] <= key ? left : right.  `xr` is the row in
// the shared tile (kStaged) or in global memory; the feature index is
// clamped into [0, F) for the read, and kMasked selects the value to 0 where
// max(f, 0) >= F.
template <bool kMasked, bool kStaged>
__device__ __forceinline__ int next_node(const int4 q, const int* __restrict__ xr,
                                         int F) {
  const int f = max(q.x, 0);
  const int fc = min(f, F - 1);
  const int v = kStaged ? xr[fc] : __ldg(xr + fc);
  const int xv = kMasked && f >= F ? 0 : v;
  return xv <= q.y ? q.z : q.w;
}

// K walks at once: trees t .. t+K-1 for one row, their leaves added to acc.
// Every walk reads its node unconditionally (a finished K1 walk re-reads its
// root), so the K loads of a level issue together.  Node offsets within the
// group are 32-bit (K * N < 2^31: the wrapper caps N), which keeps the walks'
// addresses out of 64-bit registers.  K is 1, 2 or 4: 8 walks measured no
// faster than 4 (PERF.md, PR 13).
template <int K, Walk kWalk, bool kStaged>
__device__ __forceinline__ void walk_group(const TileArgs& a, const int* __restrict__ xr,
                                           int t, int c0, int classes_left,
                                           bool vec_leaf,
                                           unsigned (&acc)[kClassChunk]) {
  constexpr bool kMasked = kWalk == Walk::kMasked;
  const int4* __restrict__ tree = a.quads + static_cast<size_t>(t) * a.N;
  int node[K];
  int limit[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    node[k] = 0;
    // K1: the internal prefix, clamped into [0, N] so its nodes are in range
    limit[k] = kWalk == Walk::kBounded
                   ? max(min(__ldg(a.internal_counts + t + k), a.N), 0)
                   : 0;
  }
  if (kWalk == Walk::kBounded) {
    // each walk runs while it is inside its prefix, at most `limit` steps
    for (int step = 0;; ++step) {
      unsigned live = 0;  // bit k: walk k is still inside its prefix
#pragma unroll
      for (int k = 0; k < K; ++k)
        live |= static_cast<unsigned>(step < limit[k] && in_table(node[k], limit[k]))
                << k;
      if (live == 0) break;
      int4 q[K];
#pragma unroll
      for (int k = 0; k < K; ++k)
        q[k] = __ldg(tree + (k * a.N + ((live >> k) & 1u ? node[k] : 0)));
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int nxt = next_node<false, kStaged>(q[k], xr, a.F);
        node[k] = (live >> k) & 1u ? nxt : node[k];
      }
    }
  } else {
    for (int level = 0; level < a.depth; ++level) {
      int4 q[K];
#pragma unroll
      for (int k = 0; k < K; ++k)
        q[k] = __ldg(tree + (k * a.N + clamp_index(node[k], a.N)));
      if (kMasked) {
        // a node outside the table reads {0, 0, 0, 0}: the walk compares
        // x[row, 0] <= 0 and goes to node 0 either way
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const bool in = in_table(node[k], a.N);
          q[k] = make_int4(in ? q[k].x : 0, in ? q[k].y : 0, in ? q[k].z : 0,
                           in ? q[k].w : 0);
        }
      }
#pragma unroll
      for (int k = 0; k < K; ++k) node[k] = next_node<kMasked, kStaged>(q[k], xr, a.F);
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const size_t leaf_node =
        static_cast<size_t>(t + k) * a.N + clamp_index(node[k], a.N);
    add_leaf(acc, a.leaf + leaf_node * a.C + c0, classes_left, vec_leaf,
             !kMasked || in_table(node[k], a.N));
  }
}

// K1 (Walk::kBounded) replaces `_kernel_leaf_major` in
// src/repro/kernels/tree_traverse.py, the linear scan over each tree's
// internal-node prefix.  The contract is the function, not the TPU's scan
// order: the scan existed to avoid per-row gathers on the TPU's vector
// unit, and a per-row gather is cheap here.  So each walk starts at node 0
// and runs while `node < internal_counts[t]`: leaf_major puts internal nodes
// first, and every child sits after its parent, so the walk leaves the
// prefix (at its leaf) within internal_counts[t] steps and never reads a
// leaf's feature -1.  The step bound also keeps a malformed table from
// looping.  Trees with no internal node (stumps, inert padding) do no walk.
//
// K2 (Walk::kGather) replaces `_kernel` with impl="gather" there, the
// per-level gather walk: exactly `depth` levels per tree; leaves self-loop,
// so rows that arrive early stay.  The feature index is clamped at 0 as the
// TPU kernel does: without the clamp a row parked on a leaf would read
// x[row, -1].
//
// K3 (Walk::kMasked) replaces `_kernel` with impl="onehot" there, whose
// `_gather_1d`, `_gather_rows` and `_gather_feature` are compare-iota masked
// sums: an index that matches no lane sums to 0.  On a TPU that form trades
// O(N) work per read for using only elementwise ops; here a read is one
// load, so K3 is K2's walk with each read's index checked against its table
// and the value selected to 0 outside it: the node's quad, x[row, f], and
// the final leaf row.
template <int K, Walk kWalk, bool kStaged>
__global__ void __launch_bounds__(kMaxTileRows) walk_tile(const TileArgs a) {
  extern __shared__ int tile[];
  const int row0 = blockIdx.x * blockDim.x;
  const int row = row0 + threadIdx.x;
  const int* __restrict__ xr;
  if (kStaged) {
    // (b): warp w copies rows w, w + warps, ... of the tile, lane by lane;
    // 4-byte cp.async, so every copy of a thread is in flight at once
    const int stride = a.F | 1;
    const int rows = min(static_cast<int>(blockDim.x), a.B - row0);
    const int warps = blockDim.x / 32;
    for (int r = threadIdx.x / 32; r < rows; r += warps) {
      const int* src = a.x + static_cast<size_t>(row0 + r) * a.F;
      for (int c = threadIdx.x % 32; c < a.F; c += 32) {
        const unsigned dst =
            static_cast<unsigned>(__cvta_generic_to_shared(tile + r * stride + c));
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
                     "l"(src + c)
                     : "memory");
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    xr = tile + threadIdx.x * stride;
  } else {
    xr = a.x + static_cast<size_t>(row) * a.F;
  }
  if (row >= a.B) return;
  const int t_begin = blockIdx.y * a.trees_per_cta;
  const int t_end = min(a.T, t_begin + a.trees_per_cta);
  const int c0 = blockIdx.z * kClassChunk;
  const int classes_left = a.C - c0;
  const bool vec_leaf =
      a.C % 4 == 0 && (reinterpret_cast<uintptr_t>(a.leaf) & 15) == 0;
  unsigned acc[kClassChunk] = {0u};
  int t = t_begin;
  for (; t + K <= t_end; t += K)
    walk_group<K, kWalk, kStaged>(a, xr, t, c0, classes_left, vec_leaf, acc);
  for (; t < t_end; ++t)
    walk_group<1, kWalk, kStaged>(a, xr, t, c0, classes_left, vec_leaf, acc);
  flush_row(a.out + static_cast<size_t>(row) * a.C + c0, acc, classes_left);
}

dim3 grid_for(int B, int T, int C, int rows_per_cta, int trees_per_cta) {
  return dim3((B + rows_per_cta - 1) / rows_per_cta,
              (T + trees_per_cta - 1) / trees_per_cta,
              (C + kClassChunk - 1) / kClassChunk);
}

template <int K, Walk kWalk, bool kStaged>
int launch_tile_as(const TileArgs& a, dim3 grid, int threads, size_t smem,
                   cudaStream_t stream) {
  auto kernel = walk_tile<K, kWalk, kStaged>;
  if (smem > kDefaultSmem) {
    const cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  kernel<<<grid, threads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <Walk kWalk, bool kStaged>
int launch_tile_k(const TileArgs& a, dim3 grid, int threads, size_t smem,
                  int walks, cudaStream_t stream) {
  switch (walks) {
    case 1: return launch_tile_as<1, kWalk, kStaged>(a, grid, threads, smem, stream);
    case 2: return launch_tile_as<2, kWalk, kStaged>(a, grid, threads, smem, stream);
    case 4: return launch_tile_as<4, kWalk, kStaged>(a, grid, threads, smem, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <Walk kWalk>
int launch_tile(const TileArgs& a, int rows_per_cta, int trees_per_cta,
                int walks, int stage_x, void* stream) {
  if (a.B == 0 || a.T == 0 || a.C == 0) return static_cast<int>(cudaSuccess);
  if (rows_per_cta < 32 || rows_per_cta > kMaxTileRows || rows_per_cta % 32 != 0 ||
      trees_per_cta < 1 || a.N < 1 || a.F < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      stage_x ? static_cast<size_t>(rows_per_cta) * (a.F | 1) * sizeof(int) : 0;
  if (smem > kMaxSmemPerCta) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid = grid_for(a.B, a.T, a.C, rows_per_cta, trees_per_cta);
  const auto s = static_cast<cudaStream_t>(stream);
  return stage_x
             ? launch_tile_k<kWalk, true>(a, grid, rows_per_cta, smem, walks, s)
             : launch_tile_k<kWalk, false>(a, grid, rows_per_cta, smem, walks, s);
}

TileArgs tile_args(const void* x, const void* quads, const void* internal_counts,
                   const void* leaf, void* out, int B, int F, int T, int N,
                   int C, int depth, int trees_per_cta) {
  return TileArgs{static_cast<const int*>(x), static_cast<const int4*>(quads),
                  static_cast<const int*>(internal_counts),
                  static_cast<const unsigned*>(leaf), static_cast<unsigned*>(out),
                  B, F, T, N, C, depth, trees_per_cta};
}

}  // namespace

extern "C" {

// `out` must hold B*C zeros; the kernel adds into it.  `quads` is the
// (T, N, 4) int32 node table, 16-byte aligned; `stage_x` stages the row
// tile in shared memory (rows_per_cta * (F | 1) * 4 bytes).
int intreeger_leaf_major(const void* x, const void* quads,
                         const void* internal_counts, const void* leaf,
                         void* out, int B, int F, int T, int N, int C,
                         int rows_per_cta, int trees_per_cta, int walks,
                         int stage_x, void* stream) {
  return launch_tile<Walk::kBounded>(
      tile_args(x, quads, internal_counts, leaf, out, B, F, T, N, C, 0,
                trees_per_cta),
      rows_per_cta, trees_per_cta, walks, stage_x, stream);
}

// As intreeger_leaf_major, with `depth` levels per tree and no prefix.
int intreeger_gather(const void* x, const void* quads, const void* leaf,
                     void* out, int B, int F, int T, int N, int C, int depth,
                     int rows_per_cta, int trees_per_cta, int walks,
                     int stage_x, void* stream) {
  return launch_tile<Walk::kGather>(
      tile_args(x, quads, nullptr, leaf, out, B, F, T, N, C, depth,
                trees_per_cta),
      rows_per_cta, trees_per_cta, walks, stage_x, stream);
}

// As intreeger_gather, with every read outside its table reading 0.
int intreeger_onehot(const void* x, const void* quads, const void* leaf,
                     void* out, int B, int F, int T, int N, int C, int depth,
                     int rows_per_cta, int trees_per_cta, int walks,
                     int stage_x, void* stream) {
  return launch_tile<Walk::kMasked>(
      tile_args(x, quads, nullptr, leaf, out, B, F, T, N, C, depth,
                trees_per_cta),
      rows_per_cta, trees_per_cta, walks, stage_x, stream);
}

}  // extern "C"
