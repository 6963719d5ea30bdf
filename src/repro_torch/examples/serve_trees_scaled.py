"""Batched tree-ensemble serving: the implementations side by side (float /
FlInt / integer reference walk / integer CUDA walk K1), plus the one-device
serving step (``core.serving.tree_serve_step``).

    PYTHONPATH=src python -m repro_torch.examples.serve_trees_scaled [--device cpu]
"""
from __future__ import annotations

import argparse
import time


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples.serve_trees_scaled")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from repro_torch.core.flint import float_to_key
    from repro_torch.core.packing import pack_forest
    from repro_torch.core.serving import tree_serve_step
    from repro_torch.data.tabular import make_esa_like, train_test_split
    from repro_torch.device import resolve_device
    from repro_torch.serve.engine import TreeEngine
    from repro_torch.trees.forest import RandomForestClassifier

    dev = resolve_device(args.device)
    X, y = make_esa_like(n=40000, seed=0)
    Xtr, ytr, Xte, yte = train_test_split(X, y)
    rf = RandomForestClassifier(n_estimators=32, max_depth=8, seed=0).fit(Xtr, ytr)
    packed = pack_forest(rf)

    engines = {
        "float": TreeEngine(packed, "float", device=dev),
        "flint": TreeEngine(packed, "flint", device=dev),
        "integer": TreeEngine(packed, "integer", device=dev),
        "integer+cuda": TreeEngine(packed, "integer:cuda", device=dev),
    }
    ref = None
    for name, eng in engines.items():
        eng.predict(Xte[:64])  # warm up
        t0 = time.perf_counter()
        preds = eng.predict(Xte)
        dt = time.perf_counter() - t0
        if ref is None:
            ref = preds
        check((preds == ref).all(), f"{name} diverged from float")
        recall = (preds[yte == 1] == 1).mean()
        print(f"{name:16s} {dt*1e6/len(Xte):7.3f} us/row  anomaly-recall={recall:.3f}")

    # the serving step on one device (the reference walk + argmax)
    tables = {k: getattr(packed, k)
              for k in ("feature", "threshold_key", "left", "right", "leaf_fixed")}
    keys = float_to_key(torch.from_numpy(np.ascontiguousarray(Xte)).to(dev))
    acc, preds = tree_serve_step(tables, keys, packed.max_depth, device=dev)
    check(np.array_equal(preds.cpu().numpy(), ref), "tree_serve_step diverged from float")
    print(f"tree_serve_step (one {dev.type} device) matches: {len(ref)} rows")


if __name__ == "__main__":
    main()
