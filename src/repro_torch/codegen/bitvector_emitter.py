"""QuickScorer bitvector C: sorted threshold streams compiled as static data.

The emitted scorer is the sequential form the bitvector layout is built for
(the ``bitvector`` backend's K5 evaluates the same tables data-parallel instead):

    for each feature f:
      for each entry e in f's ASCENDING threshold list:
        if (x[f] <= key[e]) break;        /* every later test is true too */
        v[tree[e]] &= mask[e];            /* clear the false node's left leaves */
    for each tree: exit leaf = lowest set bit of v[tree]

No per-row pointer chasing: the hot loop is a linear stream over sorted keys
with one well-predicted break per feature, and the per-tree state is
``words`` uint64 accumulators (multi-word for trees beyond 64 leaves).  The
lowest-set-bit scan uses ``__builtin_ctzll`` under GCC/Clang and a portable
shift loop otherwise — build with ``-DREPRO_NO_BUILTINS`` to force the
portable path (the CI degradation job does exactly that).

At batch, the per-row scorer is memory-bound: every row re-streams the whole
threshold table (~24 B/entry — hundreds of KB per row on large forests).  So
``predict_batch`` walks blocks of 8 rows through one shared pass over the
stream, amortizing every table load 8x.  The block keeps the early exit —
ascending keys make ``x > key`` monotone decreasing per row, so an 8-bit
``act`` bitset recomputed per entry only ever loses bits and ``act == 0``
ends the feature for the whole block — and applies masks branch-free:
``m[k] | (((uint64_t)((act >> r) & 1)) - 1)`` is the mask when row ``r`` is
active and all-ones (a no-op AND) when it is not.  Live-leaf state is
row-minor (``v[(t*words + k)*8 + r]``) so one (tree, word) touch lands the
whole block's lane on a single cache line.

``interleave=K`` is the v-QuickScorer multi-tree blocking knob (Lucchese et
al.; Koschel/Buschjäger/Lucchese for the ARM line): each feature's stream is
padded to a multiple of K with inert entries (key = INT32_MAX never tests
true; mask = all-ones is a no-op AND) and emitted as K-entry *groups*.  At
large tree counts consecutive ascending-key entries belong to K different
trees, so a group is K independent mask applies with no store-to-load chain
between them — the emitter unrolls them — and the block's early-exit test
collapses from one per entry to one per group: the group's FIRST key is its
smallest, so no row exceeding it means no row exceeds any later key in the
feature either.  One broadcast feature load now feeds K mask applies.

The blocked apply is lifted to SIMD with the same runtime-cpuid dispatch and
``simd_isa()`` export as the table-walk unit, but variant-named: the
dispatcher reports the emitted variant that will actually run
(``avx512-k8`` / ``avx2-k8`` / ``neon-k8`` / ``scalar``), never a
compile-time capability.  AVX2: one broadcast compare per entry yields the
8-row active set, sign-extension widens it to 64-bit lane masks, and
``v &= mk | ~act`` folds to two ``andnot`` ops per half-block per word.
AVX-512 (F+VL): the compare writes a ``__mmask8`` directly and the whole
apply is ONE ``_mm512_mask_and_epi64`` on the full 8-row lane — the mask
registers collapse the sign-extend/andnot dance entirely.  NEON: two
``vcgtq_s32`` halves widened by self-``vzip``, apply as two ``vbic`` ops per
row pair.  The x86 variants also vectorize the leaf-accumulate tail
(per-row ``maskload``/``add_epi32`` accumulators — same per-tree add order,
so partials stay bit-identical).  The scalar 8-lane block remains in every
TU as the mandatory fallback (``-DREPRO_NO_SIMD`` / non-GNU builds).

Integer translation unit only: like the other deterministic C backends, both
flint and integer modes run the uint32-partials unit and diverge only in the
shared numpy finalize, so the emitter refuses anything else.  The scalar
paths need only <stdint.h>.
"""
from __future__ import annotations

import numpy as np

from repro_torch.codegen.table_emitter import _array_lines, _decimals, _i32, _simd_prelude, _u32
from repro_torch.ir.forest_ir import refuse_margins

_CTZ64 = [
    "static int ctz64(uint64_t x) {",
    "#if defined(__GNUC__) && !defined(REPRO_NO_BUILTINS)",
    "  return __builtin_ctzll(x);",
    "#else",
    "  int n = 0;",
    "  while (!(x & 1u)) { x >>= 1; ++n; }",
    "  return n;",
    "#endif",
    "}",
]


def _u64(values) -> list:
    # 16 hex digits per value, most significant first: the big-endian bytes
    digits = np.asarray(values).astype(">u8").tobytes().hex()
    return [f"0x{digits[i:i + 16]}ull" for i in range(0, len(digits), 16)]


def _i64(values) -> list:
    return _decimals(values, "ll")


_BLOCK_ROWS = 8  # rows sharing one pass over the threshold stream


def _interleaved_stream(bv, k: int):
    """The K-group-padded threshold stream: ``(feat_off, key, tree, mask)``.

    Each feature's ascending slice is padded to a multiple of ``k`` with
    inert entries — key INT32_MAX (``x > key`` is never true, and the
    per-row scalar scorer's ``x <= key`` break fires exactly as it would at
    the real end of the stream), tree 0, mask all-ones (a no-op AND even if
    applied) — so every emitted group loop runs whole K-entry groups with
    no runtime remainder handling.  ``k == 1`` returns the layout's arrays
    unchanged.
    """
    if k <= 1:
        return bv.feat_offsets, bv.thr_key, bv.thr_tree, bv.thr_mask
    ones = np.full(bv.words, np.uint64(0xFFFFFFFFFFFFFFFF), np.uint64)
    keys, trees, masks = [], [], []
    off = np.zeros(bv.n_features + 1, np.int64)
    for f in range(bv.n_features):
        a, b = int(bv.feat_offsets[f]), int(bv.feat_offsets[f + 1])
        keys.append(bv.thr_key[a:b])
        trees.append(bv.thr_tree[a:b])
        masks.append(bv.thr_mask[a:b])
        pad = (-(b - a)) % k
        if pad:
            keys.append(np.full(pad, np.int32(2**31 - 1), np.int32))
            trees.append(np.zeros(pad, np.int32))
            masks.append(np.broadcast_to(ones, (pad, bv.words)))
        off[f + 1] = off[f] + (b - a) + pad
    return (
        off,
        np.concatenate(keys) if keys else bv.thr_key,
        np.concatenate(trees) if trees else bv.thr_tree,
        (np.concatenate(masks).reshape(-1, bv.words)
         if masks else bv.thr_mask),
    )


def _scalar_block(t, c, f, w, r, k, tail) -> list:
    """The mandatory scalar 8-row block, K-entry group loop."""
    lines = [
        f"static void predict_block{r}(const int32_t* data, uint32_t* scores) {{",
        "  /* row-minor state, cache-line aligned: one (tree, word) touch",
        f"     lands the whole block's lane on one line — v[(t*{w} + k)*{r} + rr] */",
        f"  uint64_t v[{t * w * r}] __attribute__((aligned(64)));",
        f"  for (int i = 0; i < {t * w}; ++i) {{",
        "    const uint64_t iv = init_mask[i];",
        f"    for (int rr = 0; rr < {r}; ++rr) v[i * {r} + rr] = iv;",
        "  }",
        f"  for (int f = 0; f < {f}; ++f) {{",
        f"    int32_t xf[{r}];",
        f"    for (int rr = 0; rr < {r}; ++rr) xf[rr] = data[rr * {f} + f];",
        f"    for (int64_t e = feat_off[f]; e < feat_off[f + 1]; e += {k}) {{",
        "      uint32_t act0 = 0;",
        "      {",
        "        const int32_t key = thr_key[e];",
        f"        for (int rr = 0; rr < {r}; ++rr)",
        "          act0 |= (uint32_t)(xf[rr] > key) << rr;",
        "      }",
        "      if (!act0) break;  /* group's smallest key: rest false too */",
        f"      for (int64_t ej = e; ej < e + {k}; ++ej) {{",
        "        uint32_t act = act0;",
        f"        if (ej != e) {{",
        "          const int32_t key = thr_key[ej];",
        "          act = 0;",
        f"          for (int rr = 0; rr < {r}; ++rr)",
        "            act |= (uint32_t)(xf[rr] > key) << rr;",
        "        }",
        f"        uint64_t* vt = v + (int64_t)thr_tree[ej] * {w * r};",
        f"        const uint64_t* m = thr_mask + ej * {w};",
        f"        for (int kk = 0; kk < {w}; ++kk) {{",
        "          const uint64_t mk = m[kk];",
        f"          uint64_t* vp = vt + kk * {r};",
        f"          for (int rr = 0; rr < {r}; ++rr)",
        "            vp[rr] &= mk | (((uint64_t)((act >> rr) & 1u)) - 1u);",
        "        }",
        "      }",
        "    }",
        "  }",
    ]
    return lines + tail


def _x86_vector_tail(t, c, w, r) -> list:
    """Leaf extraction + class adds with per-row __m256i accumulators.

    Row-outer / tree-inner, trees ascending — exactly the scalar tail's
    per-row add order, so the uint32 lane sums are bit-identical.  Classes
    load/store via ``maskload``/``maskstore`` (8-lane chunks, tail chunk
    masked) so no read ever crosses the leaf table's end.
    """
    nacc = -(-c // 8)
    lines = []
    for a in range(nacc):
        rem = min(8, c - a * 8)
        setr = ", ".join("-1" if i < rem else "0" for i in range(8))
        lines.append(
            f"  const __m256i cmask{a} = _mm256_setr_epi32({setr});")
    lines.append(f"  for (int rr = 0; rr < {r}; ++rr) {{")
    for a in range(nacc):
        lines.append(f"    __m256i acc{a} = _mm256_setzero_si256();")
    lines += [
        f"    for (int t = 0; t < {t}; ++t) {{",
        "      int leaf = 0;",
        f"      for (int k = 0; k < {w}; ++k) {{",
        f"        const uint64_t word = v[(t * {w} + k) * {r} + rr];",
        "        if (word) { leaf = k * 64 + ctz64(word); break; }",
        "      }",
        "      const int32_t* lf = (const int32_t*)(leaf_fixed"
        f" + (leaf_off[t] + leaf) * {c});",
    ]
    for a in range(nacc):
        lines.append(
            f"      acc{a} = _mm256_add_epi32(acc{a}, "
            f"_mm256_maskload_epi32(lf + {a * 8}, cmask{a}));")
    lines.append("    }")
    lines.append(f"    int32_t* out = (int32_t*)(scores + rr * {c});")
    for a in range(nacc):
        lines.append(
            f"    _mm256_maskstore_epi32(out + {a * 8}, cmask{a}, acc{a});")
    lines += ["  }", "}"]
    return lines


def _avx2_block(t, c, f, w, r, k, tail) -> list:
    """AVX2 8-row block: broadcast compare + double-andnot apply, K-unrolled."""

    def apply(ej: str, cmp: str) -> list:
        body = [
            f"        const __m256i alo = _mm256_cvtepi32_epi64("
            f"_mm256_castsi256_si128({cmp}));",
            f"        const __m256i ahi = _mm256_cvtepi32_epi64("
            f"_mm256_extracti128_si256({cmp}, 1));",
            f"        uint64_t* vt = v + (int64_t)thr_tree[{ej}] * {w * r};",
            f"        const uint64_t* m = thr_mask + ({ej}) * {w};",
            f"        for (int kk = 0; kk < {w}; ++kk) {{",
            "          const __m256i mk = _mm256_set1_epi64x((long long)m[kk]);",
            f"          uint64_t* vp = vt + kk * {r};",
            "          __m256i lo = _mm256_loadu_si256((const __m256i*)vp);",
            "          __m256i hi = _mm256_loadu_si256((const __m256i*)(vp + 4));",
            "          lo = _mm256_andnot_si256(_mm256_andnot_si256(mk, alo), lo);",
            "          hi = _mm256_andnot_si256(_mm256_andnot_si256(mk, ahi), hi);",
            "          _mm256_storeu_si256((__m256i*)vp, lo);",
            "          _mm256_storeu_si256((__m256i*)(vp + 4), hi);",
            "        }",
        ]
        return ["      {"] + body + ["      }"]

    lines = [
        '__attribute__((target("avx2")))',
        f"static void predict_block{r}_avx2(const int32_t* data, uint32_t* scores) {{",
        f"  uint64_t v[{t * w * r}] __attribute__((aligned(64)));",
        f"  for (int i = 0; i < {t * w}; ++i) {{",
        "    const __m256i iv = _mm256_set1_epi64x((long long)init_mask[i]);",
        f"    _mm256_storeu_si256((__m256i*)(v + i * {r}), iv);",
        f"    _mm256_storeu_si256((__m256i*)(v + i * {r} + 4), iv);",
        "  }",
        "  const __m256i vstride = _mm256_setr_epi32("
        + ", ".join(str(rr * f) for rr in range(r)) + ");",
        f"  for (int f = 0; f < {f}; ++f) {{",
        "    const __m256i xv = _mm256_i32gather_epi32(data + f, vstride, 4);",
        f"    for (int64_t e = feat_off[f]; e < feat_off[f + 1]; e += {k}) {{",
        "      const __m256i cmp0 = _mm256_cmpgt_epi32(",
        "          xv, _mm256_set1_epi32(thr_key[e]));",
        "      if (!_mm256_movemask_epi8(cmp0)) break;  /* group min key */",
    ]
    lines += apply("e", "cmp0")
    for j in range(1, k):
        lines += [
            "      {",
            f"      const __m256i cmp{j} = _mm256_cmpgt_epi32(",
            f"          xv, _mm256_set1_epi32(thr_key[e + {j}]));",
        ]
        lines += apply(f"e + {j}", f"cmp{j}")
        lines.append("      }")
    lines += ["    }", "  }"]
    return lines + tail


def _avx512_block(t, c, f, w, r, k, tail) -> list:
    """AVX-512 (F+VL) 8-row block: the compare writes a ``__mmask8`` and the
    whole mask apply is one ``_mm512_mask_and_epi64`` over the 8-row lane."""

    def apply(ej: str, act: str) -> list:
        return [
            "      {",
            f"        uint64_t* vt = v + (int64_t)thr_tree[{ej}] * {w * r};",
            f"        const uint64_t* m = thr_mask + ({ej}) * {w};",
            f"        for (int kk = 0; kk < {w}; ++kk) {{",
            f"          uint64_t* vp = vt + kk * {r};",
            "          __m512i vv = _mm512_loadu_si512((const void*)vp);",
            f"          vv = _mm512_mask_and_epi64(vv, {act}, vv,",
            "              _mm512_set1_epi64((long long)m[kk]));",
            "          _mm512_storeu_si512((void*)vp, vv);",
            "        }",
            "      }",
        ]

    lines = [
        '__attribute__((target("avx2,avx512f,avx512vl")))',
        f"static void predict_block{r}_avx512(const int32_t* data, uint32_t* scores) {{",
        "  /* 64-byte alignment: every 8-row lane is exactly one full",
        "     512-bit register and never splits a cache line */",
        f"  uint64_t v[{t * w * r}] __attribute__((aligned(64)));",
        f"  for (int i = 0; i < {t * w}; ++i)",
        f"    _mm512_storeu_si512((void*)(v + i * {r}),",
        "        _mm512_set1_epi64((long long)init_mask[i]));",
        "  const __m256i vstride = _mm256_setr_epi32("
        + ", ".join(str(rr * f) for rr in range(r)) + ");",
        f"  for (int f = 0; f < {f}; ++f) {{",
        "    const __m256i xv = _mm256_i32gather_epi32(data + f, vstride, 4);",
        f"    for (int64_t e = feat_off[f]; e < feat_off[f + 1]; e += {k}) {{",
        "      const __mmask8 act0 = _mm256_cmpgt_epi32_mask(",
        "          xv, _mm256_set1_epi32(thr_key[e]));",
        "      if (!act0) break;  /* group min key */",
    ]
    lines += apply("e", "act0")
    for j in range(1, k):
        lines += [
            "      {",
            f"      const __mmask8 act{j} = _mm256_cmpgt_epi32_mask(",
            f"          xv, _mm256_set1_epi32(thr_key[e + {j}]));",
        ]
        lines += apply(f"e + {j}", f"act{j}")
        lines.append("      }")
    lines += ["    }", "  }"]
    return lines + tail


def _neon_block(t, c, f, w, r, k, tail) -> list:
    """NEON 8-row block: two vcgtq halves, self-zip widen, vbic apply."""

    def apply(ej: str, clo: str, chi: str) -> list:
        return [
            "      {",
            f"        const uint64x2_t a01 = vreinterpretq_u64_u32("
            f"vzip1q_u32({clo}, {clo}));",
            f"        const uint64x2_t a23 = vreinterpretq_u64_u32("
            f"vzip2q_u32({clo}, {clo}));",
            f"        const uint64x2_t a45 = vreinterpretq_u64_u32("
            f"vzip1q_u32({chi}, {chi}));",
            f"        const uint64x2_t a67 = vreinterpretq_u64_u32("
            f"vzip2q_u32({chi}, {chi}));",
            f"        uint64_t* vt = v + (int64_t)thr_tree[{ej}] * {w * r};",
            f"        const uint64_t* m = thr_mask + ({ej}) * {w};",
            f"        for (int kk = 0; kk < {w}; ++kk) {{",
            "          const uint64x2_t mk = vdupq_n_u64(m[kk]);",
            f"          uint64_t* vp = vt + kk * {r};",
            "          /* v &= mk | ~a  ==  vbic(v, vbic(a, mk)) */",
            "          vst1q_u64(vp + 0, vbicq_u64(vld1q_u64(vp + 0),"
            " vbicq_u64(a01, mk)));",
            "          vst1q_u64(vp + 2, vbicq_u64(vld1q_u64(vp + 2),"
            " vbicq_u64(a23, mk)));",
            "          vst1q_u64(vp + 4, vbicq_u64(vld1q_u64(vp + 4),"
            " vbicq_u64(a45, mk)));",
            "          vst1q_u64(vp + 6, vbicq_u64(vld1q_u64(vp + 6),"
            " vbicq_u64(a67, mk)));",
            "        }",
            "      }",
        ]

    lines = [
        f"static void predict_block{r}_neon(const int32_t* data, uint32_t* scores) {{",
        f"  uint64_t v[{t * w * r}] __attribute__((aligned(64)));",
        f"  for (int i = 0; i < {t * w}; ++i) {{",
        "    const uint64x2_t iv = vdupq_n_u64(init_mask[i]);",
        f"    vst1q_u64(v + i * {r} + 0, iv);",
        f"    vst1q_u64(v + i * {r} + 2, iv);",
        f"    vst1q_u64(v + i * {r} + 4, iv);",
        f"    vst1q_u64(v + i * {r} + 6, iv);",
        "  }",
        f"  for (int f = 0; f < {f}; ++f) {{",
        f"    int32_t xf[{r}];",
        f"    for (int rr = 0; rr < {r}; ++rr) xf[rr] = data[rr * {f} + f];",
        "    const int32x4_t xlo = vld1q_s32(xf);",
        "    const int32x4_t xhi = vld1q_s32(xf + 4);",
        f"    for (int64_t e = feat_off[f]; e < feat_off[f + 1]; e += {k}) {{",
        "      const int32x4_t key0 = vdupq_n_s32(thr_key[e]);",
        "      const uint32x4_t c0lo = vcgtq_s32(xlo, key0);",
        "      const uint32x4_t c0hi = vcgtq_s32(xhi, key0);",
        "      if (!vmaxvq_u32(vorrq_u32(c0lo, c0hi))) break;  /* group min */",
    ]
    lines += apply("e", "c0lo", "c0hi")
    for j in range(1, k):
        lines += [
            "      {",
            f"      const int32x4_t key{j} = vdupq_n_s32(thr_key[e + {j}]);",
            f"      const uint32x4_t c{j}lo = vcgtq_s32(xlo, key{j});",
            f"      const uint32x4_t c{j}hi = vcgtq_s32(xhi, key{j});",
        ]
        lines += apply(f"e + {j}", f"c{j}lo", f"c{j}hi")
        lines.append("      }")
    lines += ["    }", "  }"]
    return lines + tail


def emit_bitvector_c(bv, mode: str = "integer", interleave: int = 1) -> str:
    """Emit the standalone bitvector scorer for a ``BitvectorEnsemble``.

    Single-row ``predict(data, result)`` over FlInt int32 keys filling uint32
    partials (the block tail path, and the contract every other emitter
    shares), the row-blocked ``predict_block8`` family (scalar always;
    AVX2/AVX-512/NEON under the arch gates), the shared ``predict_class``,
    and a ``predict_batch`` entry that runs full blocks through the
    dispatched blocked scorer and the remainder through ``predict`` — a
    complete translation unit; nothing from ``c_emitter`` needs appending.

    ``interleave=K`` pads each feature's stream to K-entry groups and
    restructures every block variant around them (see module docstring).
    ``K=1`` emits the ungrouped stream with per-entry early exits.
    """
    refuse_margins(bv, "codegen 'emit_bitvector_c'")
    assert mode == "integer", (
        "the bitvector scorer is emitted once as the integer translation "
        "unit; flint reuses it and diverges only in the shared finalize"
    )
    k = int(interleave)
    if k < 1:
        raise ValueError(f"interleave must be >= 1, got {interleave}")
    from repro_torch.codegen.c_emitter import emit_predict_class

    t, c, f, w = bv.n_trees, bv.n_classes, bv.n_features, bv.words
    feat_off, thr_key, thr_tree, thr_mask = _interleaved_stream(bv, k)
    lines = ["#include <stdint.h>", ""]
    lines += _simd_prelude()
    lines.append("")
    lines.append(
        f"/* InTreeger bitvector (QuickScorer-family) ensemble: per-feature\n"
        f"   ascending threshold streams + false-node leaf masks. trees={t}\n"
        f"   classes={c} entries={len(thr_key)} ({bv.total_entries} real) "
        f"words={w} scale={bv.scale} interleave={k} */"
    )
    lines += _array_lines("feat_off", "int64_t", feat_off, _i64)
    lines += _array_lines("thr_key", "int32_t", thr_key, _i32)
    lines += _array_lines("thr_tree", "int32_t", thr_tree, _i32)
    lines += _array_lines("thr_mask", "uint64_t", thr_mask.reshape(-1), _u64)
    lines += _array_lines("init_mask", "uint64_t", bv.init_mask.reshape(-1), _u64)
    lines += _array_lines("leaf_off", "int64_t", bv.leaf_offsets[:-1], _i64)
    lines += _array_lines("leaf_fixed", "uint32_t", bv.leaf_fixed.reshape(-1), _u32)
    lines.append("")
    lines += _CTZ64
    lines += [
        "",
        "void predict(const int32_t* data, uint32_t* result) {",
        f"  uint64_t v[{t * w}];",
        f"  for (int i = 0; i < {t * w}; ++i) v[i] = init_mask[i];",
        f"  for (int f = 0; f < {f}; ++f) {{",
        "    const int32_t xf = data[f];",
        "    for (int64_t e = feat_off[f]; e < feat_off[f + 1]; ++e) {",
        "      if (xf <= thr_key[e]) break;  /* ascending: rest true too */",
        f"      uint64_t* vt = v + (int64_t)thr_tree[e] * {w};",
        f"      const uint64_t* m = thr_mask + e * {w};",
        f"      for (int k = 0; k < {w}; ++k) vt[k] &= m[k];",
        "    }",
        "  }",
        f"  for (int i = 0; i < {c}; ++i) result[i] = 0;",
        f"  for (int t = 0; t < {t}; ++t) {{",
        "    int leaf = 0;",
        f"    for (int k = 0; k < {w}; ++k) {{",
        f"      const uint64_t word = v[t * {w} + k];",
        "      if (word) { leaf = k * 64 + ctz64(word); break; }",
        "    }",
        f"    const uint32_t* lf = leaf_fixed + (leaf_off[t] + leaf) * {c};",
        f"    for (int i = 0; i < {c}; ++i) result[i] += lf[i];",
        "  }",
        "}",
        "",
    ]
    lines += emit_predict_class(c, "uint32_t", "int32_t")
    r = _BLOCK_ROWS
    # leaf extraction + class adds shared by the scalar and NEON blocks; the
    # x86 variants run the same adds in the same order through vector
    # accumulators (identical order -> bit-identical partials everywhere)
    block_tail = [
        f"  for (long i = 0; i < {r * c}; ++i) scores[i] = 0;",
        f"  for (int t = 0; t < {t}; ++t) {{",
        f"    for (int rr = 0; rr < {r}; ++rr) {{",
        "      int leaf = 0;",
        f"      for (int k = 0; k < {w}; ++k) {{",
        f"        const uint64_t word = v[(t * {w} + k) * {r} + rr];",
        "        if (word) { leaf = k * 64 + ctz64(word); break; }",
        "      }",
        f"      const uint32_t* lf = leaf_fixed + (leaf_off[t] + leaf) * {c};",
        f"      uint32_t* out = scores + rr * {c};",
        f"      for (int i = 0; i < {c}; ++i) out[i] += lf[i];",
        "    }",
        "  }",
        "}",
    ]
    vec_tail = _x86_vector_tail(t, c, w, r)
    lines += [
        "",
        f"/* {r} rows share ONE pass over the threshold stream (the per-row",
        "   scorer re-streams the whole table per row and is memory-bound at",
        "   batch).  act = the block's still-active rows for this entry,",
        "   recomputed branch-free each entry: ascending keys make x > key",
        "   monotone decreasing, so act only loses bits; the early-exit test",
        f"   runs once per {k}-entry group against the group's smallest key.",
        "   Inactive rows AND with all-ones. */",
    ]
    lines += _scalar_block(t, c, f, w, r, k, block_tail)
    lines += [
        "",
        "#if defined(REPRO_HAVE_AVX2)",
    ]
    lines += _avx2_block(t, c, f, w, r, k, vec_tail)
    lines += [
        "",
    ]
    lines += _avx512_block(t, c, f, w, r, k, vec_tail)
    lines += [
        "#endif  /* REPRO_HAVE_AVX2 */",
        "",
        "#if defined(REPRO_HAVE_NEON)",
    ]
    lines += _neon_block(t, c, f, w, r, k, block_tail)
    lines += [
        "#endif  /* REPRO_HAVE_NEON */",
        "",
        "/* runtime dispatch mirrors the table-walk unit but is",
        "   variant-named: simd_isa() reports the block variant",
        "   predict_batch will actually run, never a compile-time",
        "   capability. */",
        "static const char* g_simd_isa = 0;",
        "",
        "static void pick_simd(void) {",
        "#if defined(REPRO_HAVE_AVX2)",
        '  if (__builtin_cpu_supports("avx512f") &&',
        '      __builtin_cpu_supports("avx512vl")) {',
        f'    g_simd_isa = "avx512-k{k}"; return;',
        "  }",
        f'  if (__builtin_cpu_supports("avx2")) {{'
        f' g_simd_isa = "avx2-k{k}"; return; }}',
        "#endif",
        "#if defined(REPRO_HAVE_NEON)",
        f'  g_simd_isa = "neon-k{k}"; return;',
        "#endif",
        '  g_simd_isa = "scalar";',
        "}",
        "",
        "const char* simd_isa(void) {",
        "  if (!g_simd_isa) pick_simd();",
        "  return g_simd_isa;",
        "}",
        "",
        "void predict_batch(const int32_t* data, long n_rows,",
        "                   uint32_t* scores, int32_t* preds) {",
        "  if (!g_simd_isa) pick_simd();",
        "  long r0 = 0;",
        "#if defined(REPRO_HAVE_AVX2)",
        "  if (g_simd_isa[0] == 'a' && g_simd_isa[3] == '5')",
        f"    for (; r0 + {r} <= n_rows; r0 += {r})",
        f"      predict_block{r}_avx512(data + r0 * {f}, scores + r0 * {c});",
        "  if (g_simd_isa[0] == 'a' && g_simd_isa[3] == '2')",
        f"    for (; r0 + {r} <= n_rows; r0 += {r})",
        f"      predict_block{r}_avx2(data + r0 * {f}, scores + r0 * {c});",
        "#endif",
        "#if defined(REPRO_HAVE_NEON)",
        "  if (g_simd_isa[0] == 'n')",
        f"    for (; r0 + {r} <= n_rows; r0 += {r})",
        f"      predict_block{r}_neon(data + r0 * {f}, scores + r0 * {c});",
        "#endif",
        f"  for (; r0 + {r} <= n_rows; r0 += {r})",
        f"    predict_block{r}(data + r0 * {f}, scores + r0 * {c});",
        "  for (; r0 < n_rows; ++r0)",
        f"    predict(data + r0 * {f}, scores + r0 * {c});",
        "  for (long rr = 0; rr < n_rows; ++rr) {",
        f"    const uint32_t* out = scores + rr * {c};",
        "    int best = 0;",
        f"    for (int i = 1; i < {c}; ++i) if (out[i] > out[best]) best = i;",
        "    preds[rr] = best;",
        "  }",
        "}",
        "",
    ]
    return "\n".join(lines)
