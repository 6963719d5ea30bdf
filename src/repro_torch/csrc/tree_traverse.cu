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
// Design, shared by all three kernels.  One thread per row; a CTA holds
// `rows_per_cta` rows and one chunk of `trees_per_cta` trees (grid.y), and
// loops over its trees with a register accumulator of up to kClassChunk
// classes (grid.z carries further class chunks).  The TPU kernels carried the
// output block through a sequential grid; CTAs run in no order here, so the
// wrapper zeroes the output and each CTA adds its chunk's sums with a 32-bit
// unsigned atomicAdd.  Integer addition commutes, so the order of the atomics
// cannot change a bit.  Ragged edges (rows past B, trees past T, classes past
// C) are masked, not padded.
//
// What bounds them.  Per (row, tree) the walk is a chain of dependent loads:
// feature and key of the current node, then the row's feature value, then the
// chosen child, about ten steps for a depth-10 tree, followed by C adds.  The
// bytes that must move are small (the full-width node tables are ~12.6 MB and
// stay in the 50 MB L2); the kernels wait on load latency, not on bandwidth
// or arithmetic.  This first version reads the tables through the read-only
// path with no shared-memory staging; staging node quads and the row tile of
// x, vectorised leaf loads and CTA sizing are later work.
//
// Each host entry launches on the caller's stream and returns
// cudaGetLastError(), which the Python wrapper turns into an exception.

#include <cuda_runtime.h>

namespace {

constexpr int kClassChunk = 8;

// `ok` false adds a zero row (K3's final node outside the table); the row
// pointer must then still point into the table.
__device__ __forceinline__ void add_leaf_row(unsigned (&acc)[kClassChunk],
                                             const unsigned* __restrict__ leaf_row,
                                             int classes_left, bool ok = true) {
#pragma unroll
  for (int c = 0; c < kClassChunk; ++c) {
    if (c < classes_left) {
      const unsigned v = __ldg(leaf_row + c);
      acc[c] += ok ? v : 0u;
    }
  }
}

__device__ __forceinline__ void flush_row(unsigned* __restrict__ out_row,
                                          const unsigned (&acc)[kClassChunk],
                                          int classes_left) {
#pragma unroll
  for (int c = 0; c < kClassChunk; ++c) {
    if (c < classes_left) atomicAdd(out_row + c, acc[c]);
  }
}

// K1: replaces `_kernel_leaf_major` in src/repro/kernels/tree_traverse.py (the
// linear scan over each tree's internal-node prefix).  The contract is the
// function, not the TPU's scan order: the scan existed to avoid per-row
// gathers on the TPU's vector unit, and a per-row gather is cheap here.  So
// each row walks from node 0 while `node < internal_counts[t]`: leaf_major
// puts internal nodes first, and every child sits after its parent, so the
// walk leaves the prefix (at its leaf) within internal_counts[t] steps and
// never reads a leaf's feature -1.  The step bound also keeps a malformed
// table from looping.  Trees with no internal node (stumps, inert padding)
// do no walk.
__global__ void leaf_major_kernel(const int* __restrict__ x,
                                  const int* __restrict__ feature,
                                  const int* __restrict__ key,
                                  const int* __restrict__ left,
                                  const int* __restrict__ right,
                                  const int* __restrict__ internal_counts,
                                  const unsigned* __restrict__ leaf,
                                  unsigned* __restrict__ out,
                                  int B, int F, int T, int N, int C,
                                  int trees_per_cta) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= B) return;
  const int t_begin = blockIdx.y * trees_per_cta;
  const int t_end = min(T, t_begin + trees_per_cta);
  const int c0 = blockIdx.z * kClassChunk;
  const int classes_left = C - c0;
  const int* __restrict__ xr = x + static_cast<size_t>(row) * F;
  unsigned acc[kClassChunk] = {0u};
  for (int t = t_begin; t < t_end; ++t) {
    const size_t base = static_cast<size_t>(t) * N;
    const int n_internal = __ldg(internal_counts + t);
    int node = 0;
    for (int step = 0; node < n_internal && step < n_internal; ++step) {
      const int f = __ldg(feature + base + node);
      const int k = __ldg(key + base + node);
      const int v = __ldg(xr + f);
      node = (v <= k) ? __ldg(left + base + node) : __ldg(right + base + node);
    }
    add_leaf_row(acc, leaf + (base + node) * C + c0, classes_left);
  }
  flush_row(out + static_cast<size_t>(row) * C + c0, acc, classes_left);
}

// One table read of K2 or K3.  K3 (kMasked) reads 0 outside [0, limit): the
// address is clamped into the table and the loaded value selected away, so
// the read is branch-free and never leaves the buffer.
template <bool kMasked>
__device__ __forceinline__ int table_read(const int* __restrict__ p, int i,
                                          int limit) {
  if (!kMasked) return __ldg(p + i);
  const bool ok = static_cast<unsigned>(i) < static_cast<unsigned>(limit);
  const int v = __ldg(p + (ok ? i : 0));
  return ok ? v : 0;
}

// The body of K2 and K3: exactly `depth` levels per tree; leaves self-loop,
// so rows that arrive early stay.  The feature index is clamped at 0 as the
// TPU kernel does: without the clamp a row parked on a leaf would read
// x[row, -1].
template <bool kMasked>
__device__ __forceinline__ void walk_rows(const int* __restrict__ x,
                                          const int* __restrict__ feature,
                                          const int* __restrict__ key,
                                          const int* __restrict__ left,
                                          const int* __restrict__ right,
                                          const unsigned* __restrict__ leaf,
                                          unsigned* __restrict__ out, int B,
                                          int F, int T, int N, int C,
                                          int depth, int trees_per_cta) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= B) return;
  const int t_begin = blockIdx.y * trees_per_cta;
  const int t_end = min(T, t_begin + trees_per_cta);
  const int c0 = blockIdx.z * kClassChunk;
  const int classes_left = C - c0;
  const int* __restrict__ xr = x + static_cast<size_t>(row) * F;
  unsigned acc[kClassChunk] = {0u};
  for (int t = t_begin; t < t_end; ++t) {
    const size_t base = static_cast<size_t>(t) * N;
    int node = 0;
    for (int level = 0; level < depth; ++level) {
      const int f = max(table_read<kMasked>(feature + base, node, N), 0);
      const int k = table_read<kMasked>(key + base, node, N);
      const int v = table_read<kMasked>(xr, f, F);
      node = (v <= k) ? table_read<kMasked>(left + base, node, N)
                      : table_read<kMasked>(right + base, node, N);
    }
    const bool ok =
        !kMasked || static_cast<unsigned>(node) < static_cast<unsigned>(N);
    add_leaf_row(acc, leaf + (base + (ok ? node : 0)) * C + c0, classes_left,
                 ok);
  }
  flush_row(out + static_cast<size_t>(row) * C + c0, acc, classes_left);
}

// K2: replaces `_kernel` with impl="gather" in
// src/repro/kernels/tree_traverse.py (the per-level gather walk).
__global__ void gather_kernel(const int* __restrict__ x,
                              const int* __restrict__ feature,
                              const int* __restrict__ key,
                              const int* __restrict__ left,
                              const int* __restrict__ right,
                              const unsigned* __restrict__ leaf,
                              unsigned* __restrict__ out,
                              int B, int F, int T, int N, int C, int depth,
                              int trees_per_cta) {
  walk_rows<false>(x, feature, key, left, right, leaf, out, B, F, T, N, C,
                   depth, trees_per_cta);
}

// K3: replaces `_kernel` with impl="onehot" in
// src/repro/kernels/tree_traverse.py, whose `_gather_1d`, `_gather_rows` and
// `_gather_feature` are compare-iota masked sums: an index that matches no
// lane sums to 0.  On a TPU that form trades O(N) work per read for using
// only elementwise ops; here a read is one load, so K3 keeps K2's geometry
// and cost and only predicates each read on its index being in range.  What
// bounds it is what bounds K2: the chain of dependent loads per walk.
__global__ void onehot_kernel(const int* __restrict__ x,
                              const int* __restrict__ feature,
                              const int* __restrict__ key,
                              const int* __restrict__ left,
                              const int* __restrict__ right,
                              const unsigned* __restrict__ leaf,
                              unsigned* __restrict__ out,
                              int B, int F, int T, int N, int C, int depth,
                              int trees_per_cta) {
  walk_rows<true>(x, feature, key, left, right, leaf, out, B, F, T, N, C,
                  depth, trees_per_cta);
}

dim3 grid_for(int B, int T, int C, int rows_per_cta, int trees_per_cta) {
  return dim3((B + rows_per_cta - 1) / rows_per_cta,
              (T + trees_per_cta - 1) / trees_per_cta,
              (C + kClassChunk - 1) / kClassChunk);
}

using WalkKernel = void (*)(const int*, const int*, const int*, const int*,
                            const int*, const unsigned*, unsigned*, int, int,
                            int, int, int, int, int);

int launch_walk(WalkKernel kernel, const void* x, const void* feature,
                const void* key, const void* left, const void* right,
                const void* leaf, void* out, int B, int F, int T, int N, int C,
                int depth, int rows_per_cta, int trees_per_cta, void* stream) {
  if (B == 0 || T == 0 || C == 0) return static_cast<int>(cudaSuccess);
  kernel<<<grid_for(B, T, C, rows_per_cta, trees_per_cta), rows_per_cta, 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(x), static_cast<const int*>(feature),
      static_cast<const int*>(key), static_cast<const int*>(left),
      static_cast<const int*>(right), static_cast<const unsigned*>(leaf),
      static_cast<unsigned*>(out), B, F, T, N, C, depth, trees_per_cta);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// `out` must hold B*C zeros; the kernel adds into it.
int intreeger_leaf_major(const void* x, const void* feature, const void* key,
                         const void* left, const void* right,
                         const void* internal_counts, const void* leaf,
                         void* out, int B, int F, int T, int N, int C,
                         int rows_per_cta, int trees_per_cta, void* stream) {
  if (B == 0 || T == 0 || C == 0) return static_cast<int>(cudaSuccess);
  leaf_major_kernel<<<grid_for(B, T, C, rows_per_cta, trees_per_cta),
                      rows_per_cta, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(x), static_cast<const int*>(feature),
      static_cast<const int*>(key), static_cast<const int*>(left),
      static_cast<const int*>(right), static_cast<const int*>(internal_counts),
      static_cast<const unsigned*>(leaf), static_cast<unsigned*>(out), B, F, T,
      N, C, trees_per_cta);
  return static_cast<int>(cudaGetLastError());
}

// `out` must hold B*C zeros; the kernel adds into it.
int intreeger_gather(const void* x, const void* feature, const void* key,
                     const void* left, const void* right, const void* leaf,
                     void* out, int B, int F, int T, int N, int C, int depth,
                     int rows_per_cta, int trees_per_cta, void* stream) {
  return launch_walk(gather_kernel, x, feature, key, left, right, leaf, out, B,
                     F, T, N, C, depth, rows_per_cta, trees_per_cta, stream);
}

// `out` must hold B*C zeros; the kernel adds into it.
int intreeger_onehot(const void* x, const void* feature, const void* key,
                     const void* left, const void* right, const void* leaf,
                     void* out, int B, int F, int T, int N, int C, int depth,
                     int rows_per_cta, int trees_per_cta, void* stream) {
  return launch_walk(onehot_kernel, x, feature, key, left, right, leaf, out, B,
                     F, T, N, C, depth, rows_per_cta, trees_per_cta, stream);
}

}  // extern "C"
