"""Paper-faithful C code generation: integer-only if-else trees.

This reproduces InTreeger's literal deliverable (Sec. III-B): a standalone,
freestanding-C, architecture-agnostic if-else implementation of the trained
ensemble where

  * branch thresholds are FlInt int32 immediates (``data`` is the feature
    vector reinterpreted as int32 keys, cf. paper Listing 2),
  * leaf probabilities are uint32 fixed-point immediates at scale
    ``floor((2**32-1)/n_trees)`` (Sec. III-A),

plus the float baseline (paper Listing 4 flavor) for comparison.  The emitted
file needs only <stdint.h> — no libm, no FPU.  Every emitter (this one, the
table walk and the bitvector scorer) refuses a margin model (boosted trees)
with ``ValueError``: the C has no signed margins or base.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.packing import PackedEnsemble
from repro_torch.ir.forest_ir import refuse_margins


def _c_float(v: float) -> str:
    s = f"{float(v):.9g}"
    if "." not in s and "e" not in s and "inf" not in s and "nan" not in s:
        s += ".0"
    return s + "f"


# indentation is capped so pathologically deep trees (depth in the thousands)
# don't blow the emitted file up with megabytes of leading spaces
_MAX_INDENT = 64


def _emit_node(lines, packed, t, node, indent, mode):
    """Emit the if-else cascade for one tree, iteratively.

    The recursive formulation nests two Python calls per tree level, so any
    tree deeper than ~¼ of ``sys.getrecursionlimit()`` would crash codegen.
    An explicit work stack makes emission depth-independent; items are either
    a node to expand or a literal line (the ``} else {`` / ``}`` scaffolding),
    pushed in reverse so they pop in source order.
    """
    stack = [("node", node, indent)]
    while stack:
        kind, payload, ind = stack.pop()
        pad = "  " * min(ind, _MAX_INDENT)
        if kind == "line":
            lines.append(f"{pad}{payload}")
            continue
        feat = int(packed.feature[t, payload])
        if feat < 0:  # leaf
            if mode == "integer":
                row = packed.leaf_fixed[t, payload]
                for c, v in enumerate(row):
                    if int(v):
                        lines.append(f"{pad}result[{c}] += {int(v)}u;")
            else:
                row = packed.leaf_probs[t, payload]
                for c, v in enumerate(row):
                    if float(v):
                        lines.append(f"{pad}result[{c}] += {_c_float(v)};")
            continue
        if mode in ("integer", "flint"):
            key = int(packed.threshold_key[t, payload]) & 0xFFFFFFFF
            cond = f"data[{feat}] <= (int32_t)0x{key:08x}"
        else:
            cond = f"data[{feat}] <= {_c_float(packed.threshold[t, payload])}"
        lines.append(f"{pad}if ({cond}) {{")
        stack.append(("line", "}", ind))
        stack.append(("node", int(packed.right[t, payload]), ind + 1))
        stack.append(("line", "} else {", ind))
        stack.append(("node", int(packed.left[t, payload]), ind + 1))


def emit_c(packed: PackedEnsemble, mode: str = "integer") -> str:
    """Emit a standalone C file for the packed ensemble.

    mode == "integer": void predict(const int32_t* data, uint32_t* result)
        ``data`` holds FlInt keys of the float features (for non-negative
        features these are the raw IEEE-754 bit patterns, exactly as in the
        paper); ``result`` accumulates fixed-point class scores.
    mode == "flint":   FlInt baseline — int32 threshold compares, float
        probability accumulation (the paper's Sec. II-D comparison point)
    mode == "float":   void predict(const float* data, float* result)
    """
    assert mode in ("integer", "flint", "float")
    refuse_margins(packed, "codegen 'emit_c'")
    c, t = packed.n_classes, packed.n_trees
    lines = ["#include <stdint.h>", ""]
    if mode == "integer":
        lines.append(
            f"/* InTreeger: integer-only if-else ensemble. trees={t} classes={c}\n"
            f"   scale = floor((2^32-1)/{t}) = {packed.scale}; scores/2^32 ~= avg prob. */"
        )
        sig = "void predict(const int32_t* data, uint32_t* result)"
    elif mode == "flint":
        lines.append(f"/* FlInt if-else ensemble: int compares, float probs. */")
        sig = "void predict(const int32_t* data, float* result)"
    else:
        lines.append(f"/* float baseline if-else ensemble. trees={t} classes={c} */")
        sig = "void predict(const float* data, float* result)"
    lines.append(sig + " {")
    for i in range(c):
        lines.append(f"  result[{i}] = 0;")
    for tree in range(t):
        lines.append(f"  /* tree {tree} */")
        _emit_node(lines, packed, tree, 0, 1, mode)
    if mode in ("float", "flint"):
        # ensemble-average by the precomputed float32 reciprocal: the
        # reference's float finalize multiplies by exactly this value, so the
        # emitted C stays bit-identical to the reference backend's scores
        rcp = np.float32(1.0) / np.float32(t)
        for i in range(c):
            lines.append(f"  result[{i}] *= {_c_float(rcp)};")
    lines.append("}")
    lines.append("")
    ty = "uint32_t" if mode == "integer" else "float"
    data_t = "float" if mode == "float" else "int32_t"
    lines += emit_predict_class(c, ty, data_t)
    return "\n".join(lines)


def emit_predict_class(n_classes: int, acc_t: str, data_t: str) -> list:
    """The argmax helper shared by every C emitter (comparisons only).

    Cross-backend prediction bit-identity depends on the tie-breaking rule
    (strict ``>``: first maximum wins, matching the reference's argmax) being the
    SAME in every emitted artifact — keep this the single source of it.
    """
    return [
        f"int predict_class(const {data_t}* data) {{",
        f"  {acc_t} result[{n_classes}];",
        "  predict(data, result);",
        "  int best = 0;",
        f"  for (int i = 1; i < {n_classes}; ++i)"
        " if (result[i] > result[best]) best = i;",
        "  return best;",
        "}",
        "",
    ]


def emit_test_harness(packed: PackedEnsemble, n_samples: int,
                      mode: str = "integer") -> str:
    """A main() that reads raw feature rows from stdin and prints argmax —
    used by tests to diff gcc-compiled output against the reference walk.

    ``mode == "float"`` reads float32 rows; flint/integer read the FlInt
    int32 keys, matching the ``predict_class`` prototype :func:`emit_c`
    produced for that mode.
    """
    assert mode in ("integer", "flint", "float")
    f = packed.n_features
    data_t = "float" if mode == "float" else "int32_t"
    return "\n".join(
        [
            "#include <stdio.h>",
            "#include <stdint.h>",
            f"int predict_class(const {data_t}* data);",
            "int main(void) {",
            f"  static {data_t} row[{f}];",
            f"  for (int s = 0; s < {n_samples}; ++s) {{",
            f"    fread(row, sizeof({data_t}), {f}, stdin);",
            '    printf("%d\\n", predict_class(row));',
            "  }",
            "  return 0;",
            "}",
            "",
        ]
    )


def emit_batch_entry(packed: PackedEnsemble, mode: str = "integer") -> str:
    """A batched entry point for shared-library serving (``NativeCBackend``).

    ``predict_batch(data, n_rows, scores, preds)`` runs the single-row
    ``predict`` over ``n_rows`` contiguous rows, filling a (n_rows, C) score
    matrix and an argmax vector — the C-side mirror of the backends'
    ``predict_scores`` contract, callable from ctypes with any row count.
    """
    assert mode in ("integer", "flint", "float")
    f, c = packed.n_features, packed.n_classes
    data_t = "float" if mode == "float" else "int32_t"
    acc_t = "uint32_t" if mode == "integer" else "float"
    return "\n".join(
        [
            f"void predict_batch(const {data_t}* data, long n_rows,",
            f"                   {acc_t}* scores, int32_t* preds) {{",
            "  for (long r = 0; r < n_rows; ++r) {",
            f"    const {data_t}* row = data + r * {f};",
            f"    {acc_t}* out = scores + r * {c};",
            "    predict(row, out);",
            "    int best = 0;",
            f"    for (int i = 1; i < {c}; ++i) if (out[i] > out[best]) best = i;",
            "    preds[r] = best;",
            "  }",
            "}",
            "",
        ]
    )
