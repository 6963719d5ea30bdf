"""Vectorizable table-walk C: the ragged layout compiled data-as-arrays.

The paper's deliverable (``c_emitter.emit_c``) encodes the forest *in the
instruction stream* — one if-else cascade per tree, FlInt keys and fixed-point
leaves as immediates.  That is ideal for MCU-class single-row inference but
branchy at batch: every row takes a data-dependent path through thousands of
conditional jumps.  This emitter is the other point in the design space the
paper's architecture discussion motivates: the forest as *static data* (the
``ragged`` ForestIR layout — CSR node arrays with per-tree roots and global
child indices) plus one generic walk loop

    node = root[t];
    while (feature[node] >= 0)
      node = (data[feature[node]] <= key[node]) ? left[node] : right[node];

whose code footprint is O(1) in forest size instead of O(total_nodes).

``block_rows=R`` selects the row-blocked variant (the memory-layout/blocking
optimization line of Koschel et al. and FLInt): node records are emitted
*interleaved* — one ``(feature, key, left, right)`` quad per node, so a walk
step touches one cache line instead of four arrays — and ``predict_batch``
walks R rows through each tree in lockstep.  The R walk states live in
registers (the emitter unrolls the row loop; a runtime-bounded loop would
spill the state to the stack every step), every child select is an
arithmetic mask — branchless, so the data-dependent 50%-mispredict branch
of the scalar walk disappears — and one well-predicted test per level exits
as soon as all R rows sit on leaves.  The R independent dependent-load
chains give the memory-level parallelism a single row's serial walk cannot,
and tree-major order keeps each tree's nodes cache-hot across the rows in
flight.

The blocked file also carries *explicit SIMD* walkers over the same quads —
AVX2 on x86-64 (8 rows per ``__m256i``: one gather per quad field, a
sign-bit movemask for the all-leaves exit, ``blendv`` child selects) and
NEON on aarch64 (4 lanes, per-lane quad loads + vector compare/select) —
selected at *runtime*: ``predict_batch`` dispatches via
``__builtin_cpu_supports("avx2")`` (NEON is baseline on aarch64) and falls
back to the scalar blocked walk, which remains mandatory: SIMD blocks are
compiled only under ``__GNUC__`` on a matching arch and are disabled
entirely by ``-DREPRO_NO_SIMD`` (the compile-flags degradation CI job), so
a no-intrinsics build is the scalar file plus a dispatcher that always says
``scalar``.  The selected ISA is exported as ``const char* simd_isa(void)``.
The AVX2 walker is a per-function ``target("avx2")`` attribute, NOT a
file-level ``-mavx2``: the rest of the translation unit (scalar fallback
included) must stay executable on non-AVX2 hosts, which file-level flags
would silently break by letting gcc auto-vectorize the fallback.  Every
walker applies each row's accumulation in the same per-tree order, so
scores are bit-identical across scalar/AVX2/NEON dispatch.

Modes mirror the deterministic pair: ``integer`` (int32 FlInt compares,
uint32 fixed-point adds — bit-identical to every other backend) and ``flint``
(int32 compares, float32 adds in the same per-tree order plus the same
precomputed-reciprocal ensemble average the reference's finalize applies).
Blocking never reorders any single row's accumulation, so scores stay
bit-identical at every block size.  The emitted file needs only <stdint.h>.
"""
from __future__ import annotations

import numpy as np

from repro_torch.codegen.c_emitter import _c_float, emit_predict_class
from repro_torch.ir.forest_ir import refuse_margins

_VALS_PER_LINE = 12


# The literal formatters take a whole array and return one C literal per
# value, formatted by numpy in bulk: the full-width model's tables hold
# millions of values, and one Python call per value made emission slower than
# gcc.  The text is the JAX emitters' to the byte.

def _decimals(values, suffix: str = "") -> list:
    strs = np.asarray(values).astype(np.int64).astype(str).tolist()
    return [v + suffix for v in strs] if suffix else strs


def _i32(values) -> list:
    # INT32_MIN has no negatable literal form in C; every other value is fine
    a = np.asarray(values)
    out = _decimals(a)
    for i in np.flatnonzero(a.astype(np.int64) == -(1 << 31)).tolist():
        out[i] = "(-2147483647-1)"
    return out


def _u32(values) -> list:
    return _decimals(values, "u")


def _floats(values) -> list:
    return [_c_float(v) for v in np.asarray(values).tolist()]


def _array_lines(name: str, ctype: str, values, fmt) -> list:
    strs = fmt(values)
    lines = [f"static const {ctype} {name}[{len(strs)}] = {{"]
    for i in range(0, len(strs), _VALS_PER_LINE):
        lines.append("  " + ", ".join(strs[i:i + _VALS_PER_LINE]) + ",")
    lines.append("};")
    return lines


def emit_table_walk_c(ragged, mode: str = "integer", block_rows: int = None) -> str:
    """Emit a standalone table-walk C file for a ragged ensemble.

    Same entry-point contract as ``c_emitter.emit_c`` — ``predict(data,
    result)`` over FlInt int32 keys plus a comparison-only ``predict_class`` —
    so the shared batch entry (``emit_batch_entry``) and the test harness
    compose with it unchanged.

    ``block_rows=R`` switches the node storage to interleaved quads and
    additionally emits the row-blocked ``predict_batch`` (see module
    docstring): R register-resident walk states per tree, branch-free
    arithmetic child selects, an all-leaves early exit per level, and a
    scalar-``predict`` tail for the final partial block.
    """
    refuse_margins(ragged, "codegen 'emit_table_walk_c'")
    assert mode in ("integer", "flint"), (
        "the table walk serves the deterministic integer-compare modes; "
        "float thresholds would reintroduce the FPU the paper removes"
    )
    t, c = ragged.n_trees, ragged.n_classes
    total = ragged.total_nodes
    acc_t = "uint32_t" if mode == "integer" else "float"
    lines = ["#include <stdint.h>", ""]
    if block_rows is not None:
        lines += _simd_prelude()
        lines.append("")
    lines.append(
        f"/* InTreeger table-walk ensemble ({mode} mode): ragged ForestIR layout\n"
        f"   as static data. trees={t} classes={c} nodes={total}"
        + (f" scale={ragged.scale}" if mode == "integer" else "")
        + (f" block_rows={int(block_rows)}" if block_rows is not None else "")
        + " */"
    )
    if block_rows is None:
        lines += _array_lines("node_feature", "int32_t", ragged.feature, _i32)
        lines += _array_lines("node_key", "int32_t", ragged.threshold_key, _i32)
        lines += _array_lines("node_left", "int32_t", ragged.left, _i32)
        lines += _array_lines("node_right", "int32_t", ragged.right, _i32)
        feat = "node_feature[{n}]"
        key = "node_key[{n}]"
        left = "node_left[{n}]"
        right = "node_right[{n}]"
    else:
        # interleaved (feature, key, left, right) records: one walk step
        # touches one 16-byte quad instead of four distinct arrays
        quad = np.stack(
            [ragged.feature, ragged.threshold_key, ragged.left, ragged.right],
            axis=1,
        ).reshape(-1)
        lines += _array_lines("node_quad", "int32_t", quad, _i32)
        feat = "node_quad[4 * (long)({n})]"
        key = "node_quad[4 * (long)({n}) + 1]"
        left = "node_quad[4 * (long)({n}) + 2]"
        right = "node_quad[4 * (long)({n}) + 3]"
    if mode == "integer":
        leaf_vals = ragged.leaf_fixed.reshape(-1)
        lines += _array_lines("node_leaf", "uint32_t", leaf_vals, _u32)
    else:
        leaf_vals = ragged.leaf_probs.reshape(-1)
        lines += _array_lines("node_leaf", "float", leaf_vals, _floats)
    lines += _array_lines("tree_root", "int32_t", ragged.roots, _i32)
    lines += [
        "",
        f"void predict(const int32_t* data, {acc_t}* result) {{",
        f"  for (int i = 0; i < {c}; ++i) result[i] = 0;",
        f"  for (int t = 0; t < {t}; ++t) {{",
        "    int32_t node = tree_root[t];",
        f"    int32_t f = {feat.format(n='node')};",
        "    while (f >= 0) {",
        f"      node = (data[f] <= {key.format(n='node')}) ? "
        f"{left.format(n='node')} : {right.format(n='node')};",
        f"      f = {feat.format(n='node')};",
        "    }",
        f"    const {acc_t}* leaf = node_leaf + (long)node * {c};",
        f"    for (int i = 0; i < {c}; ++i) result[i] += leaf[i];",
        "  }",
    ]
    if mode == "flint":
        # same precomputed float32 reciprocal the reference's finalize
        # multiplies by, applied in the same place -> bit-identical averages
        rcp = np.float32(1.0) / np.float32(t)
        lines.append(f"  for (int i = 0; i < {c}; ++i) result[i] *= {_c_float(rcp)};")
    lines += ["}", ""]
    lines += emit_predict_class(c, acc_t, "int32_t")
    if block_rows is not None:
        lines += _emit_blocked_batch(ragged, mode, acc_t, int(block_rows))
    return "\n".join(lines)


def _emit_blocked_batch(ragged, mode: str, acc_t: str, block_rows: int) -> list:
    """The row-blocked ``predict_batch``: R walk chains per tree in registers.

    The emitter unrolls the row dimension so each chain is a named local —
    gcc keeps them in registers and the R dependent-load chains issue
    independently.  Per level it preloads every chain's node feature, takes
    one well-predicted exit branch when their AND is negative (all leaves:
    ``feature == -1`` is all-ones, and only an all-negative set keeps the
    sign bit through AND), and advances each chain with a branch-free
    arithmetic select.  The depth bound is a backstop: leaves self-loop, so
    extra levels are inert and the early exit usually fires first.
    """
    assert block_rows >= 1
    t, c, f = ragged.n_trees, ragged.n_classes, ragged.n_features
    depth, r = ragged.max_depth, block_rows
    chains = range(r)
    lines = [
        f"/* row-blocked walk: {r} register walk chains per tree, early exit",
        "   when every chain sits on a leaf (see table_emitter docstring). */",
        f"static void walk_block_full(const int32_t* data, {acc_t}* scores) {{",
        f"  for (long i = 0; i < {r} * {c}; ++i) scores[i] = 0;",
        f"  for (int t = 0; t < {t}; ++t) {{",
        "    const int32_t root = tree_root[t];",
        "    " + " ".join(f"int32_t n{k} = root;" for k in chains),
    ]
    if depth > 0:
        lines.append(f"    for (int d = 0; d < {depth}; ++d) {{")
        for k in chains:
            lines.append(
                f"      const int32_t f{k} = node_quad[4 * (long)n{k}];"
            )
        all_leaves = " & ".join(f"f{k}" for k in chains)
        lines.append(f"      if (({all_leaves}) < 0) break;")
        for k in chains:
            lines += [
                f"      {{ const int32_t* q{k} = node_quad + 4 * (long)n{k};",
                f"        const int32_t fi{k} = f{k} & ~(f{k} >> 31);",
                f"        const int32_t go{k} = -(data[{k} * {f} + fi{k}] <= q{k}[1]);",
                f"        n{k} = (q{k}[2] & go{k}) | (q{k}[3] & ~go{k}); }}",
            ]
        lines.append("    }")
    lines.append(
        "    " + "const int32_t node[] = {"
        + ", ".join(f"n{k}" for k in chains) + "};"
    )
    lines += [
        f"    for (long w = 0; w < {r}; ++w) {{",
        f"      const {acc_t}* leaf = node_leaf + (long)node[w] * {c};",
        f"      for (int i = 0; i < {c}; ++i) scores[w * {c} + i] += leaf[i];",
        "    }",
        "  }",
    ]
    if mode == "flint":
        rcp = np.float32(1.0) / np.float32(t)
        lines.append(
            f"  for (long i = 0; i < {r} * {c}; ++i) scores[i] *= {_c_float(rcp)};"
        )
    lines += ["}", ""]
    lines += _emit_simd_walkers(ragged, mode, acc_t)
    lines += [
        "/* runtime ISA dispatch: AVX2 via cpuid, NEON baseline on aarch64,",
        "   scalar blocked walk as the mandatory fallback (and the whole",
        "   story under -DREPRO_NO_SIMD or a non-GNU compiler). */",
        "static const char* g_simd_isa = 0;",
        "",
        "static void pick_simd(void) {",
        "#if defined(REPRO_HAVE_AVX2)",
        '  if (__builtin_cpu_supports("avx2")) { g_simd_isa = "avx2"; return; }',
        "#endif",
        "#if defined(REPRO_HAVE_NEON)",
        '  g_simd_isa = "neon";',
        "#else",
        '  g_simd_isa = "scalar";',
        "#endif",
        "}",
        "",
        "const char* simd_isa(void) {",
        "  if (!g_simd_isa) pick_simd();",
        "  return g_simd_isa;",
        "}",
        "",
        f"void predict_batch(const int32_t* data, long n_rows,",
        f"                   {acc_t}* scores, int32_t* preds) {{",
        "  if (!g_simd_isa) pick_simd();",
        "  long r0 = 0;",
        "#if defined(REPRO_HAVE_AVX2)",
        "  if (g_simd_isa[0] == 'a')",
        f"    for (; r0 + {_SIMD_ROWS_AVX2} <= n_rows; r0 += {_SIMD_ROWS_AVX2})",
        f"      walk_block{_SIMD_ROWS_AVX2}_avx2(data + r0 * {f}, scores + r0 * {c});",
        "#endif",
        "#if defined(REPRO_HAVE_NEON)",
        f"  for (; r0 + {_SIMD_ROWS_NEON} <= n_rows; r0 += {_SIMD_ROWS_NEON})",
        f"    walk_block{_SIMD_ROWS_NEON}_neon(data + r0 * {f}, scores + r0 * {c});",
        "#endif",
        f"  for (; r0 + {r} <= n_rows; r0 += {r})",
        f"    walk_block_full(data + r0 * {f}, scores + r0 * {c});",
        "  for (; r0 < n_rows; ++r0)",
        f"    predict(data + r0 * {f}, scores + r0 * {c});",
        "  for (long w = 0; w < n_rows; ++w) {",
        f"    const {acc_t}* out = scores + w * {c};",
        "    int best = 0;",
        f"    for (int i = 1; i < {c}; ++i) if (out[i] > out[best]) best = i;",
        "    preds[w] = best;",
        "  }",
        "}",
        "",
    ]
    return lines


# Two interleaved __m256i state vectors (16 rows): one vector's five
# dependent gathers per level leave the gather ports idle most of the
# latency chain; a second independent chain roughly doubles throughput
# (measured: 1 vector is *slower* than the scalar 8-chain walk).
_AVX2_VECS = 4
_SIMD_ROWS_AVX2 = 8 * _AVX2_VECS
_SIMD_ROWS_NEON = 4   # one int32x4_t of walk states


def _simd_prelude() -> list:
    """The arch/toolchain gates.  ``REPRO_HAVE_*`` is defined only when the
    intrinsics can actually compile AND ``REPRO_NO_SIMD`` was not requested —
    everything SIMD downstream keys off these two macros alone."""
    return [
        "#if !defined(REPRO_NO_SIMD) && defined(__GNUC__) && defined(__x86_64__)",
        "#define REPRO_HAVE_AVX2 1",
        "#include <immintrin.h>",
        "#endif",
        "#if !defined(REPRO_NO_SIMD) && defined(__GNUC__) && defined(__aarch64__)",
        "#define REPRO_HAVE_NEON 1",
        "#include <arm_neon.h>",
        "#endif",
    ]


def _leaf_epilogue(acc_t: str, c: int, rows: int, mode: str, n_trees: int) -> list:
    """Shared walker tail: scatter the ``rows`` final nodes into leaf adds
    (same per-tree order as every other path -> bit-identical scores)."""
    lines = [
        f"    for (long w = 0; w < {rows}; ++w) {{",
        f"      const {acc_t}* leaf = node_leaf + (long)nn[w] * {c};",
        f"      for (int i = 0; i < {c}; ++i) scores[w * {c} + i] += leaf[i];",
        "    }",
        "  }",
    ]
    if mode == "flint":
        rcp = np.float32(1.0) / np.float32(n_trees)
        lines.append(
            f"  for (long i = 0; i < {rows} * {c}; ++i) scores[i] *= {_c_float(rcp)};"
        )
    return lines


def _emit_simd_walkers(ragged, mode: str, acc_t: str) -> list:
    """The AVX2 and NEON blocked walkers over the interleaved quads.

    Same walk semantics as ``walk_block_full``, vector-width rows at a time:
    per level, gather each state's quad fields, exit when every lane's
    feature is negative (all leaves), clamp the leaf features to 0, gather
    the compared values, and select children branch-free.  Leaves self-loop
    in the quads, so mixed leaf/internal lanes stay correct without masking.
    """
    t, c, f = ragged.n_trees, ragged.n_classes, ragged.n_features
    depth = ragged.max_depth
    v8, v4, nv = _SIMD_ROWS_AVX2, _SIMD_ROWS_NEON, _AVX2_VECS
    vecs = range(nv)
    lines = [
        "#if defined(REPRO_HAVE_AVX2)",
        f"/* {v8} walk states in {nv} interleaved __m256i: quad fields via i32",
        "   gathers (scale 4 over the int32 quad array), all-leaves exit via",
        "   the combined sign-bit movemask, branch-free child select via",
        "   blendv.  The vectors' per-level gather chains are independent, so",
        "   they overlap and hide each other's gather latency.  target()",
        "   keeps AVX2 codegen out of every other function in this unit. */",
        '__attribute__((target("avx2")))',
        f"static void walk_block{v8}_avx2(const int32_t* data, {acc_t}* scores) {{",
        f"  for (long i = 0; i < {v8} * {c}; ++i) scores[i] = 0;",
    ]
    for j in vecs:
        lines.append(
            f"  const __m256i vrow{j} = _mm256_setr_epi32("
            + ", ".join(str(k * f) for k in range(8 * j, 8 * j + 8)) + ");"
        )
    lines += [
        f"  for (int t = 0; t < {t}; ++t) {{",
        "    const __m256i root = _mm256_set1_epi32(tree_root[t]);",
        "    " + " ".join(f"__m256i node{j} = root;" for j in vecs),
    ]
    if depth > 0:
        lines.append(f"    for (int d = 0; d < {depth}; ++d) {{")
        for j in vecs:
            lines += [
                f"      const __m256i q{j} = _mm256_slli_epi32(node{j}, 2);",
                f"      const __m256i fe{j} = _mm256_i32gather_epi32(node_quad, q{j}, 4);",
            ]
        all_mask = " & ".join(
            f"_mm256_movemask_ps(_mm256_castsi256_ps(fe{j}))" for j in vecs
        )
        lines.append(f"      if (({all_mask}) == 0xff) break;")
        for j in vecs:
            lines += [
                f"      const __m256i ky{j} = _mm256_i32gather_epi32(node_quad + 1, q{j}, 4);",
                f"      const __m256i lf{j} = _mm256_i32gather_epi32(node_quad + 2, q{j}, 4);",
                f"      const __m256i rt{j} = _mm256_i32gather_epi32(node_quad + 3, q{j}, 4);",
                # fi = fe & ~(fe >> 31): leaf lanes read feature 0 (inert
                # because their quads self-loop through the select)
                f"      const __m256i fi{j} = _mm256_andnot_si256("
                f"_mm256_srai_epi32(fe{j}, 31), fe{j});",
                f"      const __m256i xv{j} = _mm256_i32gather_epi32(",
                f"          data, _mm256_add_epi32(vrow{j}, fi{j}), 4);",
                f"      node{j} = _mm256_blendv_epi8(lf{j}, rt{j}, "
                f"_mm256_cmpgt_epi32(xv{j}, ky{j}));",
            ]
        lines.append("    }")
    lines.append(f"    int32_t nn[{v8}];")
    for j in vecs:
        lines.append(f"    _mm256_storeu_si256((__m256i*)(nn + {8 * j}), node{j});")
    lines += _leaf_epilogue(acc_t, c, v8, mode, t)
    lines += ["}", "#endif  /* REPRO_HAVE_AVX2 */", ""]

    lines += [
        "#if defined(REPRO_HAVE_NEON)",
        "/* 4 walk states in one int32x4_t; aarch64 has no gather, so quad",
        "   fields load per lane and the compare/select stay vectorized. */",
        f"static void walk_block{v4}_neon(const int32_t* data, {acc_t}* scores) {{",
        f"  for (long i = 0; i < {v4} * {c}; ++i) scores[i] = 0;",
        f"  for (int t = 0; t < {t}; ++t) {{",
        "    int32x4_t node = vdupq_n_s32(tree_root[t]);",
    ]
    if depth > 0:
        lines += [
            f"    for (int d = 0; d < {depth}; ++d) {{",
            f"      int32_t ni[{v4}], qf[{v4}], qk[{v4}], ql[{v4}], qr[{v4}];",
            "      vst1q_s32(ni, node);",
            f"      for (int w = 0; w < {v4}; ++w) {{",
            "        const int32_t* q = node_quad + 4 * (long)ni[w];",
            "        qf[w] = q[0]; qk[w] = q[1]; ql[w] = q[2]; qr[w] = q[3];",
            "      }",
            "      const int32x4_t fe = vld1q_s32(qf);",
            "      if (vmaxvq_s32(fe) < 0) break;  /* all lanes on leaves */",
            "      const int32x4_t fi = vbicq_s32(fe, vshrq_n_s32(fe, 31));",
            f"      int32_t fis[{v4}], xv[{v4}];",
            "      vst1q_s32(fis, fi);",
            f"      for (int w = 0; w < {v4}; ++w) xv[w] = data[w * {f} + fis[w]];",
            "      const uint32x4_t go_r = vcgtq_s32(vld1q_s32(xv), vld1q_s32(qk));",
            "      node = vbslq_s32(go_r, vld1q_s32(qr), vld1q_s32(ql));",
            "    }",
        ]
    lines += [
        f"    int32_t nn[{v4}];",
        "    vst1q_s32(nn, node);",
    ]
    lines += _leaf_epilogue(acc_t, c, v4, mode, t)
    lines += ["}", "#endif  /* REPRO_HAVE_NEON */", ""]
    return lines
