// Integer-only tree-ensemble traversal for Hopper (sm_90a): kernels K1 and K2.
//
// Both kernels compute, for every row r and class c,
//
//     out[r, c] = sum over trees t of leaf_fixed[t, leaf(t, r), c]   (mod 2^32)
//
// where leaf(t, r) is the leaf row r reaches in tree t under the compare
// `x_keys[r, feature] <= threshold_key` (signed int32, paper Listing 2).  The
// tables are the dense (T, N) node tables of the ForestIR `leaf_major` (K1) or
// `padded` (K2) layout; leaves self-loop and carry feature -1.
//
// Design, shared by both kernels.  One thread per row; a CTA holds
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

__device__ __forceinline__ void add_leaf_row(unsigned (&acc)[kClassChunk],
                                             const unsigned* __restrict__ leaf_row,
                                             int classes_left) {
#pragma unroll
  for (int c = 0; c < kClassChunk; ++c) {
    if (c < classes_left) acc[c] += __ldg(leaf_row + c);
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

// K2: replaces `_kernel` with impl="gather" in
// src/repro/kernels/tree_traverse.py (the per-level gather walk).  Exactly
// `depth` levels per tree; leaves self-loop, so rows that arrive early stay.
// The feature index is clamped at 0 as the TPU kernel does: without the clamp
// a row parked on a leaf would read x[row, -1].
__global__ void gather_kernel(const int* __restrict__ x,
                              const int* __restrict__ feature,
                              const int* __restrict__ key,
                              const int* __restrict__ left,
                              const int* __restrict__ right,
                              const unsigned* __restrict__ leaf,
                              unsigned* __restrict__ out,
                              int B, int F, int T, int N, int C, int depth,
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
    int node = 0;
    for (int level = 0; level < depth; ++level) {
      const int f = max(__ldg(feature + base + node), 0);
      const int k = __ldg(key + base + node);
      const int v = __ldg(xr + f);
      node = (v <= k) ? __ldg(left + base + node) : __ldg(right + base + node);
    }
    add_leaf_row(acc, leaf + (base + node) * C + c0, classes_left);
  }
  flush_row(out + static_cast<size_t>(row) * C + c0, acc, classes_left);
}

dim3 grid_for(int B, int T, int C, int rows_per_cta, int trees_per_cta) {
  return dim3((B + rows_per_cta - 1) / rows_per_cta,
              (T + trees_per_cta - 1) / trees_per_cta,
              (C + kClassChunk - 1) / kClassChunk);
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
  if (B == 0 || T == 0 || C == 0) return static_cast<int>(cudaSuccess);
  gather_kernel<<<grid_for(B, T, C, rows_per_cta, trees_per_cta), rows_per_cta,
                  0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(x), static_cast<const int*>(feature),
      static_cast<const int*>(key), static_cast<const int*>(left),
      static_cast<const int*>(right), static_cast<const unsigned*>(leaf),
      static_cast<unsigned*>(out), B, F, T, N, C, depth, trees_per_cta);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
