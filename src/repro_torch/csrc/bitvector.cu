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
// over the tree's entry slots m: the entries whose test `x <= key` is false
// each clear the leaves of their left subtree, and the exit leaf is the
// lowest leaf that no false node cleared (the QuickScorer theorem, see
// src/repro_torch/ir/bitvector.py).  Bitvectors are W32 uint32 words (the
// layout's uint64 words, low word first).  Where no bit survives (never on a
// layout of real trees) the leaf is 32, as _bitvector_partials computes it.
//
// K5 replaces src/repro/kernels/bitvector.py::_bitvector_partials, which is
// jnp, not Pallas: XLA runs one fori_loop step per entry slot over a
// (B, T, W32) cleared-bit tensor in device memory (1.07 GB at 65,536 rows of
// the full-width model) and rewrites it at every one of the M = 1,023 steps.
//
// The tables.  K5 does not read the dense (T, M, W32) slot grid.  The host
// packs it once (kernels/bitvector.py::pack_bitvector_tables) into one
// 16-byte record {feature, key, word, bits} per nonzero word of each slot's
// clear set, grouped by tree and, within a tree, by word, lowest first;
// word_start[t, w] is the first record of word w of tree t.  Zero words and
// empty clear sets (padding slots) get no record, so any mask packs exactly,
// whatever its shape.  A clear set is one leaf range, so on the full-width
// model (128 trees of depth 10, W32 = 32) that is 1,072 records per tree for
// 1,023 slots: 2.2 MB in place of 16.8 MB of masks.
//
// Design (`bitvector_tile<kRows, kStaged, kStagedRecords>`).  A CTA holds
// `rows_per_cta` rows and one chunk of `trees_per_cta` trees (grid.y); grid.z
// carries class chunks of up to kClassChunk classes, summed in registers.
//   (a) Word by word.  Because the records of a word are contiguous, the
//       cleared bits of word w are one register, ORed from that word's
//       records alone; once the word is done, `init & ~cleared` says whether
//       a leaf survives in it.  Words are taken lowest first, so the first
//       word with a surviving bit holds the exit leaf (`__ffs`), and a row
//       stops there: no cleared-set array, no register indexed at run time,
//       and no limit on W32.
//   (b) One record load, one compare and one OR per record and row: every
//       thread of a warp scores the same tree at the same record, so the
//       record is a warp-uniform 16-byte load (a broadcast), the compare
//       reads the row's key at the record's feature, and a false compare ORs
//       the record's word.  So K5 does the ORs the data needs, one per
//       nonzero word of each false entry's clear set, not one per word of
//       the width.
//   (c) The rows' keys are staged in shared memory once per CTA, as the
//       walks stage them (cp.async, row stride F | 1 so a warp's 32 rows hit
//       32 banks), and read at the record's feature; rows too wide to stage
//       read from global memory.  Each thread scores kRows rows (2, or 1 for
//       a batch of one warp of rows), so one record load serves kRows
//       compares.
//   (d) Splits.  `splits` warps share a tree's rows: split s scans words
//       [s * W32 / splits, (s + 1) * W32 / splits) for its lowest surviving
//       bit, and the lowest split that found one holds the exit leaf.  Each
//       split stops at its own first surviving word, so the splits scan
//       fewer words in all than one warp scanning up to its rows' exit
//       words, and at small batches they put more warps on the card.  The
//       splits meet in shared memory, one __syncthreads a tree.
//   (e) The exit leaf's row adds into the C sums in registers (16-byte
//       loads where C % 4 == 0); the chunks' sums meet in `out` through
//       32-bit unsigned atomicAdd, which is exact in any order.
//   (f) Staged records (kStagedRecords): a tree's records are copied into
//       one of two shared-memory buffers (16-byte cp.async by every thread)
//       while the CTA scores the tree before it, so record loads are
//       shared-memory broadcasts; trees whose records do not fit (the
//       wrapper's rule, kernels/bitvector.py::record_cap) read them from the
//       table through the read-only cache.
// Indices follow jnp's gathers in _bitvector_partials: a negative index
// wraps once (i + n), then clamps into [0, n).  A record's feature is
// clamped into [0, F) by one unsigned min; where a table holds a feature
// outside [0, F) the wrapper passes records whose features it has already
// wrapped and clamped so, which keeps the per-record work at one
// instruction.  The leaf row wraps and clamps here, once per (row, tree).
// Each word's record range is clamped into its tree's, the tree's into
// [0, R) and the staged buffer.
//
// What bounds it.  Per (row, tree) the function needs, scanning words lowest
// first, the records of the words up to its exit word: a compare at each and
// an OR at each false one (higher words cannot change the result).  At
// 65,536 rows of the full-width model that is about 4.6e9 compares and 2.3e9
// ORs, about 7.0e9 operations (0.104 ms at the H100's 67 TOP/s;
// chip_smoke.py::bitvector_exit_work counts it from each run's data),
// against about 31 MB that must move (0.009 ms at 3.35 TB/s), so operations
// bound it.  This body issues per warp and record one shared-memory
// broadcast, one shared-memory read a row and a few integer instructions,
// and runs at about 32 times that bound; PERF.md has its times, and the
// sweep of CTA shapes behind kernels/bitvector.py::pick_blocks.
//
// The host entry launches on the caller's stream and returns
// cudaGetLastError(), which the Python wrapper turns into an exception.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kClassChunk = 8;
// the most threads of a CTA, which caps a thread at 64 registers
constexpr int kMaxThreads = 1024;
constexpr int kMaxTileRows = 512;
constexpr size_t kMaxSmemPerCta = 232448;
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr int kMaxGridY = 65535;
// leaf(t, r) where no bit survives, as _bitvector_partials computes it
constexpr int kNoSurvivor = 32;
// records loaded together in the scan of a word
constexpr int kUnroll = 4;

struct BvArgs {
  const int* x;               // (B, F) keys
  const int4* records;        // (R,) {feature, key, word, bits}
  const int* word_start;      // (T, W32 + 1) first record of each (tree, word)
  const unsigned* init_mask;  // (T, W32)
  const int* leaf_off;        // (T,)
  const unsigned* leaf;       // (L, C)
  unsigned* out;              // (B, C), zeroed by the caller
  int B, F, T, W32, R, L, C, rows_per_cta, trees_per_cta, splits;
  int rec_cap;                // records a shared-memory buffer holds (kStagedRecords)
};

__device__ __forceinline__ void copy4_async(int* dst, const int* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src)
               : "memory");
}

__device__ __forceinline__ void copy16_async(int4* dst, const int4* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src)
               : "memory");
}

__device__ __forceinline__ void wait_async_copies() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// tree t's records: [first, first + count), clamped into [0, R)
__device__ __forceinline__ void tree_records(const BvArgs& a, int t, int& first, int& count) {
  const int* __restrict__ ws = a.word_start + static_cast<size_t>(t) * (a.W32 + 1);
  first = min(max(__ldg(ws), 0), a.R);
  count = min(max(__ldg(ws + a.W32), first), a.R) - first;
}

// (b): one record on the thread's rows.  The wrapper has wrapped and
// clamped the features of a malformed table, so one unsigned min clamps a
// feature into [0, F) as jnp does (and keeps any read inside the row).
template <int kRows, bool kStaged>
__device__ __forceinline__ void apply_record(const int4 r, const int* const (&xr)[kRows],
                                             int F, unsigned (&cleared)[kRows]) {
  const int f = static_cast<int>(min(static_cast<unsigned>(r.x), static_cast<unsigned>(F - 1)));
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    const int xv = kStaged ? xr[j][f] : __ldg(xr[j] + f);
    cleared[j] |= xv > r.y ? static_cast<unsigned>(r.w) : 0u;
  }
}

// (a): the lowest surviving leaf of tree t among words [w_lo, w_hi) for each
// of the thread's rows, left at -1 where no bit of those words survives.  A
// row whose leaf[j] is already >= 0 has nothing to find.  The tree's records
// are [first, first + count), each word's range clamped into them; record i
// is recs[i - first] where they are staged in shared memory
// (kStagedRecords), else recs[i] of the table.
template <int kRows, bool kStaged, bool kStagedRecords>
__device__ __forceinline__ void scan_words(const BvArgs& a, const int* const (&xr)[kRows],
                                           int t, int w_lo, int w_hi, int (&leaf)[kRows],
                                           const int4* __restrict__ recs, int first,
                                           int count) {
  bool done = true;
#pragma unroll
  for (int j = 0; j < kRows; ++j) done = done && leaf[j] >= 0;
  if (done || w_lo >= w_hi) return;
  const int* __restrict__ ws = a.word_start + static_cast<size_t>(t) * (a.W32 + 1);
  const unsigned* __restrict__ init = a.init_mask + static_cast<size_t>(t) * a.W32;
  const int last = first + count;
  int i = min(max(__ldg(ws + w_lo), first), last);
  for (int w = w_lo; w < w_hi; ++w) {
    const int end = min(max(__ldg(ws + w + 1), i), last);
    unsigned cleared[kRows];
#pragma unroll
    for (int j = 0; j < kRows; ++j) cleared[j] = 0u;
    for (; i + kUnroll <= end; i += kUnroll) {
      int4 r[kUnroll];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k)
        r[k] = kStagedRecords ? recs[i + k - first] : __ldg(recs + i + k);
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) apply_record<kRows, kStaged>(r[k], xr, a.F, cleared);
    }
    for (; i < end; ++i)
      apply_record<kRows, kStaged>(kStagedRecords ? recs[i - first] : __ldg(recs + i), xr,
                                   a.F, cleared);
    const unsigned live_bits = __ldg(init + w);
    done = true;
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const unsigned live = live_bits & ~cleared[j];
      if (leaf[j] < 0 && live != 0u) leaf[j] = w * 32 + __ffs(live) - 1;
      done = done && leaf[j] >= 0;
    }
    if (done) break;
  }
}

// (e): one leaf row's classes [c0, c0 + classes_left) into acc; `vec` reads
// them as uint4 (C % 4 == 0 and a 16-byte aligned table)
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

// Threads: rows_per_cta / kRows rows a split, times `splits`.  Warp w scores
// split w / row_warps and, lane by lane, local rows
// (w % row_warps) * 32 * kRows + lane + 32 * j for j < kRows.  Shared memory:
// the row tile (kStaged), the splits' leaves (splits > 1), and two buffers of
// rec_cap records (kStagedRecords).
template <int kRows, bool kStaged, bool kStagedRecords>
__global__ void __launch_bounds__(kMaxThreads) bitvector_tile(const BvArgs a) {
  extern __shared__ int smem[];
  const int row0 = blockIdx.x * a.rows_per_cta;
  const int rows = min(a.rows_per_cta, a.B - row0);
  const int stride = a.F | 1;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row_warps = a.rows_per_cta / (32 * kRows);
  const int split = warp / row_warps;
  const int first_row = (warp % row_warps) * 32 * kRows + lane;
  int* found = smem + (kStaged ? a.rows_per_cta * stride : 0);  // [splits][rows_per_cta]
  int4* rec_buf =
      reinterpret_cast<int4*>(found + (a.splits > 1 ? a.splits * a.rows_per_cta : 0));
  const int t_begin = blockIdx.y * a.trees_per_cta;
  const int t_end = min(a.T, t_begin + a.trees_per_cta);
  // (f): tree t's records into buffer (t - t_begin) & 1, 16 bytes a copy
  auto stage_records = [&](int t) {
    int first, count;
    tree_records(a, t, first, count);
    count = min(count, a.rec_cap);
    int4* dst = rec_buf + ((t - t_begin) & 1) * a.rec_cap;
    for (int k = threadIdx.x; k < count; k += blockDim.x)
      copy16_async(dst + k, a.records + first + k);
  };
  if (kStaged) {
    // (c): warp w copies rows w, w + warps, ... of the tile, lane by lane
    const int warps = blockDim.x / 32;
    for (int r = warp; r < rows; r += warps) {
      const int* src = a.x + static_cast<size_t>(row0 + r) * a.F;
      for (int c = lane; c < a.F; c += 32) copy4_async(smem + r * stride + c, src + c);
    }
  }
  if (kStagedRecords) stage_records(t_begin);
  // a row past the batch reads the tile's first row and starts as found
  const int* xr[kRows];
  int preset[kRows];
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    const int lr = first_row + 32 * j;
    const bool ok = lr < rows;
    preset[j] = ok ? -1 : 0;
    const int use = ok ? lr : 0;
    xr[j] = kStaged ? smem + use * stride : a.x + static_cast<size_t>(row0 + use) * a.F;
  }
  const int w_lo = static_cast<int>(static_cast<long long>(split) * a.W32 / a.splits);
  const int w_hi = static_cast<int>(static_cast<long long>(split + 1) * a.W32 / a.splits);
  const int c0 = blockIdx.z * kClassChunk;
  const int classes_left = a.C - c0;
  const bool vec_leaf =
      a.C % 4 == 0 && (reinterpret_cast<uintptr_t>(a.leaf) & 15) == 0;
  unsigned acc[kRows][kClassChunk];
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
#pragma unroll
    for (int c = 0; c < kClassChunk; ++c) acc[j][c] = 0u;
  }
  for (int t = t_begin; t < t_end; ++t) {
    // the tile and tree t's records have landed, and every thread is done
    // with tree t - 1: its record buffer and the splits' leaves are free
    if (kStaged || kStagedRecords) wait_async_copies();
    __syncthreads();
    if (kStagedRecords && t + 1 < t_end) stage_records(t + 1);
    int first, count;
    tree_records(a, t, first, count);
    if (kStagedRecords) count = min(count, a.rec_cap);  // the wrapper makes it fit
    const int4* recs = kStagedRecords ? rec_buf + ((t - t_begin) & 1) * a.rec_cap : a.records;
    int leaf[kRows];
#pragma unroll
    for (int j = 0; j < kRows; ++j) leaf[j] = preset[j];
    scan_words<kRows, kStaged, kStagedRecords>(a, xr, t, w_lo, w_hi, leaf, recs, first,
                                               count);
    if (a.splits > 1) {
      // (d): the lowest split with a surviving bit holds the exit leaf
#pragma unroll
      for (int j = 0; j < kRows; ++j)
        found[split * a.rows_per_cta + first_row + 32 * j] = leaf[j];
      __syncthreads();
      if (split != 0) continue;
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        int l = -1;
        for (int s = 0; s < a.splits; ++s) {
          const int v = found[s * a.rows_per_cta + first_row + 32 * j];
          l = l >= 0 ? l : v;
        }
        leaf[j] = l;
      }
    }
    const long long off = __ldg(a.leaf_off + t);
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      long long at = off + (leaf[j] >= 0 ? leaf[j] : kNoSurvivor);
      at = at < 0 ? at + a.L : at;  // jnp wraps a negative row once
      const long long idx = at < 0 ? 0 : (at >= a.L ? a.L - 1 : at);
      add_leaf(acc[j], a.leaf + static_cast<size_t>(idx) * a.C + c0, classes_left,
               vec_leaf);
    }
  }
  if (split != 0) return;
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    const int lr = first_row + 32 * j;
    if (lr >= rows) continue;
    unsigned* out_row = a.out + static_cast<size_t>(row0 + lr) * a.C + c0;
#pragma unroll
    for (int c = 0; c < kClassChunk; ++c) {
      if (c < classes_left) atomicAdd(out_row + c, acc[j][c]);
    }
  }
}

template <int kRows, bool kStaged, bool kStagedRecords>
int launch_as(const BvArgs& a, dim3 grid, int threads, size_t smem, cudaStream_t stream) {
  auto kernel = bitvector_tile<kRows, kStaged, kStagedRecords>;
  if (smem > kDefaultSmem) {
    const cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  kernel<<<grid, threads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// `out` must hold B*C zeros; the kernel adds into it.  `records` holds R
// 16-byte records, 16-byte aligned.  Shared memory: the row tile when
// `stage_x` (rows_per_cta * (F | 1) * 4 bytes), the splits' leaves where
// splits > 1 (splits * rows_per_cta * 4 bytes), and where rec_cap > 0 two
// buffers of rec_cap records (2 * rec_cap * 16 bytes), which must hold every
// tree's records.
int intreeger_bitvector(const void* x, const void* records, const void* word_start,
                        const void* init_mask, const void* leaf_off, const void* leaf,
                        void* out, int B, int F, int T, int W32, int R, int L, int C,
                        int rows_per_cta, int trees_per_cta, int splits,
                        int rows_per_thread, int rec_cap, int stage_x, void* stream) {
  if (B == 0 || T == 0 || C == 0) return static_cast<int>(cudaSuccess);
  if ((rows_per_thread != 1 && rows_per_thread != 2) ||
      rows_per_cta < 32 * rows_per_thread || rows_per_cta > kMaxTileRows ||
      rows_per_cta % (32 * rows_per_thread) != 0 || trees_per_cta < 1 || splits < 1 ||
      F < 1 || L < 1 || R < 0 || rec_cap < 0 || W32 < 1 || W32 > (1 << 25))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long threads = static_cast<long long>(rows_per_cta) / rows_per_thread * splits;
  const long long chunks = (static_cast<long long>(T) + trees_per_cta - 1) / trees_per_cta;
  if (threads > kMaxThreads || chunks > kMaxGridY)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      (stage_x ? static_cast<size_t>(rows_per_cta) * (F | 1) * sizeof(int) : 0) +
      (splits > 1 ? static_cast<size_t>(splits) * rows_per_cta * sizeof(int) : 0) +
      static_cast<size_t>(2) * rec_cap * sizeof(int4);
  if (smem > kMaxSmemPerCta) return static_cast<int>(cudaErrorInvalidValue);
  const BvArgs a{static_cast<const int*>(x),
                 static_cast<const int4*>(records),
                 static_cast<const int*>(word_start),
                 static_cast<const unsigned*>(init_mask),
                 static_cast<const int*>(leaf_off),
                 static_cast<const unsigned*>(leaf),
                 static_cast<unsigned*>(out),
                 B, F, T, W32, R, L, C, rows_per_cta, trees_per_cta, splits, rec_cap};
  const dim3 grid((B + rows_per_cta - 1) / rows_per_cta, static_cast<unsigned>(chunks),
                  (C + kClassChunk - 1) / kClassChunk);
  const auto s = static_cast<cudaStream_t>(stream);
  const int n = static_cast<int>(threads);
  const int variant = (rows_per_thread == 2) * 4 + (stage_x != 0) * 2 + (rec_cap > 0);
  switch (variant) {
    case 0: return launch_as<1, false, false>(a, grid, n, smem, s);
    case 1: return launch_as<1, false, true>(a, grid, n, smem, s);
    case 2: return launch_as<1, true, false>(a, grid, n, smem, s);
    case 3: return launch_as<1, true, true>(a, grid, n, smem, s);
    case 4: return launch_as<2, false, false>(a, grid, n, smem, s);
    case 5: return launch_as<2, false, true>(a, grid, n, smem, s);
    case 6: return launch_as<2, true, false>(a, grid, n, smem, s);
    default: return launch_as<2, true, true>(a, grid, n, smem, s);
  }
}

}  // extern "C"
