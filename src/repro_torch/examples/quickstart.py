"""Quickstart: the InTreeger pipeline end to end, in PyTorch.

dataset -> random forest -> ForestIR (quantized once) -> layout
materializations (padded / ragged / leaf_major) -> three inference paths
(float / FlInt / InTreeger) and layout-pinned serving engines -> identical
predictions + the emitted integer-only C file (the paper's deliverable).

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

Everything runs on ``--device`` (default ``cuda``: the CUDA walk K1 serves
the ``cuda`` route; ``cpu`` runs its plain PyTorch version).  The C file is
written to ``--out`` (default: ``intreeger_model.c`` in the temp directory).
"""
from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples.quickstart")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "intreeger_model.c"))
    args = ap.parse_args(argv)

    from repro_torch.backends import have_c_toolchain
    from repro_torch.codegen.c_emitter import emit_c
    from repro_torch.core.ensemble import predict_mode
    from repro_torch.core.fixedpoint import fixed_to_prob_np
    from repro_torch.core.packing import pack_forest
    from repro_torch.data.tabular import make_shuttle_like, train_test_split
    from repro_torch.device import resolve_device
    from repro_torch.serve.engine import TreeEngine
    from repro_torch.trees.forest import RandomForestClassifier

    dev = resolve_device(args.device)

    # 1. train on a Shuttle-like dataset (58k x 7, 7 classes, paper Sec. IV-A)
    X, y = make_shuttle_like(n=20000, seed=0)
    Xtr, ytr, Xte, yte = train_test_split(X, y)
    rf = RandomForestClassifier(n_estimators=25, max_depth=7, seed=0).fit(Xtr, ytr)
    print(f"forest accuracy: {(rf.predict(Xte) == yte).mean():.4f}")

    # 2. pack to the integer-only deployment artifact (FlInt keys + 2^32/n probs)
    packed = pack_forest(rf)
    print(f"packed: {packed.n_trees} trees, scale={packed.scale}, "
          f"{packed.nbytes_integer()/1e3:.1f} kB")

    # 3. three inference paths — predictions must be identical (paper Sec. IV-B)
    _, pred_f = predict_mode(packed, Xte, "float", device=dev)
    _, pred_fl = predict_mode(packed, Xte, "flint", device=dev)
    acc_u32, pred_i = predict_mode(packed, Xte, "integer", device=dev)
    check((pred_f == pred_fl).all(), "float and flint predictions differ")
    check((pred_f == pred_i).all(), "float and integer predictions differ")
    print(f"float == flint == integer predictions on every test row (on {dev})")

    # 4. fixed-point probabilities are within n/2^32 of the float64 oracle
    delta = np.abs(fixed_to_prob_np(acc_u32, packed.n_trees) - rf.predict_proba(Xte)).max()
    print(f"max probability delta vs oracle: {delta:.2e}  (paper Fig. 2: ~1e-9)")

    # 5. the packed tables are one *layout* of the canonical ForestIR; every
    #    other registered layout materializes from the same quantization
    ir = packed.ir
    sizes = ir.nbytes_by_layout(mode="integer")
    print("layouts:", ", ".join(f"{k}={v/1e3:.1f}kB" for k, v in sorted(sizes.items())))

    # 6. layout selection end to end: the engine materializes whatever layout
    #    the backend prefers (or the one you pin) — scores stay bit-identical
    eng_padded = TreeEngine(ir, "integer", device=dev)                       # padded
    engines = {"reference/padded": eng_padded,
               "reference/leaf_major": TreeEngine(ir, "integer:reference@leaf_major",
                                                  device=dev)}
    # the CUDA walk K1 on leaf_major tables (its preferred layout)
    engines["cuda/leaf_major"] = TreeEngine(ir, "integer:cuda@leaf_major", device=dev)
    if have_c_toolchain():
        # table-walk C over the ragged layout, row-blocked: 8 register-resident
        # walk chains per tree (block_rows=1 would be the scalar walk)
        engines["native_c_table/ragged"] = TreeEngine(
            ir, "integer:native_c_table?block_rows=8", device=dev)
    # sharded execution plans: carve the forest into tree-contiguous sub-forests
    # (ForestIR.subset) or split the batch — the uint32 accumulator is an exact
    # associative sum, so merged partial scores are bit-identical to single-shard
    engines["plan/tree_parallel(4)"] = TreeEngine(ir, "integer:reference+tree_parallel:4",
                                                  device=dev)
    engines["plan/row_parallel(2)"] = TreeEngine(ir, "integer:reference+row_parallel:2",
                                                 device=dev)
    try:
        s_ref, _ = eng_padded.predict_scores(Xte[:256])
        for name, eng in engines.items():
            s, _ = eng.predict_scores(Xte[:256])
            check(np.array_equal(s, s_ref), f"{name} scores differ from reference/padded")
    finally:
        for eng in engines.values():
            eng.close()
    print(f"bit-identical uint32 scores across {len(engines)} "
          "(backend, layout, plan) routes:", ", ".join(sorted(engines)))

    # 7. the paper's deliverable: freestanding integer-only C
    c_src = emit_c(packed, mode="integer")
    with open(args.out, "w") as fh:
        fh.write(c_src)
    print(f"emitted integer-only C ({len(c_src.splitlines())} lines) "
          f"-> {args.out}  (gcc-compilable, no FPU needed)")


if __name__ == "__main__":
    main()
