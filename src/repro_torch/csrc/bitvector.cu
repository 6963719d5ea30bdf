// Integer-only QuickScorer scoring for Hopper (sm_90a): kernel K5.
//
// For every row r and class c,
//
//     out[r, c] = sum over trees t of leaf[leaf_off[t] + leaf(t, r), c]   (mod 2^32)
//
// where leaf(t, r) is the lowest set bit of
//
//     init_mask[t] & ~OR{ inv_mask[t, m] : x_keys[r, entry_feat[t, m]] > entry_key[t, m] }
//
// over the tree's M entry slots: the entries whose test `x <= key` is false
// each clear the leaves of their left subtree, and the exit leaf is the
// lowest leaf that no false node cleared (the QuickScorer theorem, see
// src/repro_torch/ir/bitvector.py).  Padding slots hold key INT32_MAX and an
// empty clear set, so they apply nothing.  Bitvectors are W32 uint32 words,
// W32 even (the layout's uint64 words, low word first).
//
// K5 replaces src/repro/kernels/bitvector.py::_bitvector_partials, which is
// jnp, not Pallas: XLA runs one fori_loop step per entry slot over a
// (B, T, W32) cleared-bit tensor in device memory (1.07 GB at 65,536 rows of
// the full-width model) and rewrites it at every one of the M = 1,023 steps.
//
// Design (`bitvector_tile<kStaged>`).  One thread per (row, tree chunk):
// a CTA holds `rows_per_cta` rows, one per thread, and one chunk of
// `trees_per_cta` trees (grid.y); grid.z carries class chunks of up to
// kClassChunk classes, summed in registers.
//   (a) the cleared-bit set lives in registers: kW = 32 words, fully
//       unrolled, each word guarded by the width, so every W32 runs on the
//       one body; a bitvector wider than 32 words is scored in chunks of 32
//       words, lowest first, each chunk re-reading the tree's entries, until
//       a chunk holds a surviving bit (no width is refused);
//   (b) every thread of a CTA scores the same tree at the same slot, so the
//       entry's feature, key and mask words are warp-uniform loads: one
//       broadcast per warp, 16-byte loads where W32 % 4 == 0;
//   (c) the row's keys are staged in shared memory once per CTA, as the
//       walks stage them (cp.async, row stride F | 1 so the warp's 32 rows
//       hit 32 banks), and read at the entry's feature; rows too wide to
//       stage read from global memory;
//   (d) each mask is applied branch-free: `cleared |= mask & (x > key ? ~0 : 0)`;
//   (e) the exit leaf is the lowest set bit of the first nonzero word
//       (`__ffs`), and its leaf row adds into the C sums in registers
//       (16-byte loads where C % 4 == 0); the chunks' sums meet in `out`
//       through 32-bit unsigned atomicAdd, which is exact in any order.
// Every index is clamped into its buffer: an entry's feature into [0, F), the
// leaf row into [0, L).  Where no bit survives (never on a layout of real
// trees) the leaf is 32, as _bitvector_partials computes it.
//
// What bounds it.  Per (row, tree) the function needs a compare at every one
// of the tree's entries and, for each false one, an OR of the nonzero words
// of its clear set.  A clear set is one contiguous leaf range, so in a
// complete tree of depth 10 (W32 = 32) all but the 15 nodes of the top four
// levels clear 32 leaves or fewer: about one nonzero word per mask, not 32.
// At 65,536 rows of the full-width model that is about 8.6e9 compares and
// 4.5e9 ORs, about 1.3e10 operations (about 0.2 ms at the H100's 67 TOP/s;
// chip_smoke.py counts it from each run's data) against about 47 MB that
// must move (keys 22.8 MB, masks 16.8 MB, leaves 4.2 MB, partials 2.1 MB:
// 0.014 ms at 3.35 TB/s), so the bound is set by operations.  This body ORs
// all 32 words of every applied mask and loads them as warp-uniform reads,
// about 30 times the ORs the data needs; QuickScorer's per-feature early
// exit, and range masks (a first word and a word count) in place of 128-byte
// masks, are the levers for a later version.
//
// The host entry launches on the caller's stream and returns
// cudaGetLastError(), which the Python wrapper turns into an exception.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kClassChunk = 8;
// the words of the cleared-bit set kept in registers
constexpr int kW = 32;
constexpr int kMaxTileRows = 512;
constexpr size_t kMaxSmemPerCta = 232448;
constexpr size_t kDefaultSmem = 48 * 1024;
// leaf(t, r) where no bit survives, as _bitvector_partials computes it
constexpr int kNoSurvivor = 32;

struct BvArgs {
  const int* x;               // (B, F) keys
  const int* entry_feat;      // (T, M)
  const int* entry_key;       // (T, M)
  const unsigned* inv_mask;   // (T, M, W32) bits each false node clears
  const unsigned* init_mask;  // (T, W32)
  const int* leaf_off;        // (T,)
  const unsigned* leaf;       // (L, C)
  unsigned* out;              // (B, C), zeroed by the caller
  int B, F, T, M, W32, L, C, trees_per_cta;
};

// (d): cleared[w] |= mw[w] & sel for the words [0, words_left) of this chunk;
// mw points at word w0 of an entry's clear set.  W32 is even and w0 a
// multiple of kW, so the uint2 reads are 8-byte aligned, and with vec4
// (W32 % 4 == 0, a 16-byte aligned table) the uint4 reads 16-byte aligned.
__device__ __forceinline__ void or_mask(unsigned (&cleared)[kW],
                                        const unsigned* __restrict__ mw,
                                        int words_left, unsigned sel, bool vec4) {
  if (vec4) {
#pragma unroll
    for (int j = 0; j < kW / 4; ++j) {
      if (4 * j < words_left) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(mw) + j);
        cleared[4 * j] |= v.x & sel;
        cleared[4 * j + 1] |= v.y & sel;
        cleared[4 * j + 2] |= v.z & sel;
        cleared[4 * j + 3] |= v.w & sel;
      }
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < kW / 2; ++j) {
    if (2 * j < words_left) {
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(mw) + j);
      cleared[2 * j] |= v.x & sel;
      cleared[2 * j + 1] |= v.y & sel;
    }
  }
}

// (a), (b), (e): tree t's exit leaf for the row whose keys `xr` points at.
template <bool kStaged>
__device__ __forceinline__ int exit_leaf(const BvArgs& a, const int* __restrict__ xr,
                                         int t, bool vec4) {
  const size_t slot0 = static_cast<size_t>(t) * a.M;
  const int* __restrict__ feat = a.entry_feat + slot0;
  const int* __restrict__ key = a.entry_key + slot0;
  const unsigned* __restrict__ inv = a.inv_mask + slot0 * a.W32;
  const unsigned* __restrict__ init = a.init_mask + static_cast<size_t>(t) * a.W32;
  for (int w0 = 0; w0 < a.W32; w0 += kW) {
    const int words_left = a.W32 - w0;
    unsigned cleared[kW];
#pragma unroll
    for (int w = 0; w < kW; ++w) cleared[w] = 0u;
#pragma unroll 2
    for (int m = 0; m < a.M; ++m) {
      const int f = min(max(__ldg(feat + m), 0), a.F - 1);
      const int xv = kStaged ? xr[f] : __ldg(xr + f);
      const unsigned sel = xv > __ldg(key + m) ? ~0u : 0u;
      or_mask(cleared, inv + static_cast<size_t>(m) * a.W32 + w0, words_left, sel,
                  vec4);
    }
    // the lowest surviving bit of the chunk: scan its words high to low and
    // keep the last nonzero one
    int leaf = -1;
#pragma unroll
    for (int w = kW - 1; w >= 0; --w) {
      if (w < words_left) {
        const unsigned v = __ldg(init + w0 + w) & ~cleared[w];
        leaf = v ? (w0 + w) * 32 + __ffs(v) - 1 : leaf;
      }
    }
    if (leaf >= 0) return leaf;
  }
  return kNoSurvivor;
}

// one leaf row's classes [c0, c0 + classes_left) into acc; `vec` reads them
// as uint4 (C % 4 == 0 and a 16-byte aligned table)
__device__ __forceinline__ void add_leaf(unsigned (&acc)[kClassChunk],
                                         const unsigned* __restrict__ leaf_row,
                                         int classes_left, bool vec) {
  if (vec) {
#pragma unroll
    for (int j = 0; j < kClassChunk / 4; ++j) {
      if (4 * j < classes_left) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(leaf_row) + j);
        acc[4 * j] += v.x;
        acc[4 * j + 1] += v.y;
        acc[4 * j + 2] += v.z;
        acc[4 * j + 3] += v.w;
      }
    }
  } else {
#pragma unroll
    for (int c = 0; c < kClassChunk; ++c) {
      if (c < classes_left) acc[c] += __ldg(leaf_row + c);
    }
  }
}

template <bool kStaged>
__global__ void __launch_bounds__(kMaxTileRows) bitvector_tile(const BvArgs a) {
  extern __shared__ int tile[];
  const int row0 = blockIdx.x * blockDim.x;
  const int row = row0 + threadIdx.x;
  const int* __restrict__ xr;
  if (kStaged) {
    // (c): warp w copies rows w, w + warps, ... of the tile, lane by lane
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
  const bool vec_mask =
      a.W32 % 4 == 0 && (reinterpret_cast<uintptr_t>(a.inv_mask) & 15) == 0;
  unsigned acc[kClassChunk] = {0u};
  for (int t = t_begin; t < t_end; ++t) {
    const int leaf = exit_leaf<kStaged>(a, xr, t, vec_mask);
    const long long at = static_cast<long long>(__ldg(a.leaf_off + t)) + leaf;
    const long long idx = at < 0 ? 0 : (at >= a.L ? a.L - 1 : at);
    add_leaf(acc, a.leaf + static_cast<size_t>(idx) * a.C + c0, classes_left, vec_leaf);
  }
  unsigned* out_row = a.out + static_cast<size_t>(row) * a.C + c0;
#pragma unroll
  for (int c = 0; c < kClassChunk; ++c) {
    if (c < classes_left) atomicAdd(out_row + c, acc[c]);
  }
}

}  // namespace

extern "C" {

// `out` must hold B*C zeros; the kernel adds into it.  `stage_x` stages the
// row tile in shared memory (rows_per_cta * (F | 1) * 4 bytes).
int intreeger_bitvector(const void* x, const void* entry_feat, const void* entry_key,
                        const void* inv_mask, const void* init_mask,
                        const void* leaf_off, const void* leaf, void* out, int B,
                        int F, int T, int M, int W32, int L, int C, int rows_per_cta,
                        int trees_per_cta, int stage_x, void* stream) {
  if (B == 0 || T == 0 || C == 0) return static_cast<int>(cudaSuccess);
  if (rows_per_cta < 32 || rows_per_cta > kMaxTileRows || rows_per_cta % 32 != 0 ||
      trees_per_cta < 1 || F < 1 || L < 1 || M < 0 || W32 < 2 || W32 % 2 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      stage_x ? static_cast<size_t>(rows_per_cta) * (F | 1) * sizeof(int) : 0;
  if (smem > kMaxSmemPerCta) return static_cast<int>(cudaErrorInvalidValue);
  const BvArgs a{static_cast<const int*>(x),
                 static_cast<const int*>(entry_feat),
                 static_cast<const int*>(entry_key),
                 static_cast<const unsigned*>(inv_mask),
                 static_cast<const unsigned*>(init_mask),
                 static_cast<const int*>(leaf_off),
                 static_cast<const unsigned*>(leaf),
                 static_cast<unsigned*>(out),
                 B, F, T, M, W32, L, C, trees_per_cta};
  const dim3 grid((B + rows_per_cta - 1) / rows_per_cta,
                  (T + trees_per_cta - 1) / trees_per_cta,
                  (C + kClassChunk - 1) / kClassChunk);
  auto kernel = stage_x ? bitvector_tile<true> : bitvector_tile<false>;
  if (smem > kDefaultSmem) {
    const cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  kernel<<<grid, rows_per_cta, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
