"""Converter CLI: trees/io JSON -> ITRF binary artifact.

Closes the paper's dataset -> deployable-artifact loop at the command line:

    python -m repro_torch.trees.convert model.json model.itrf
    python -m repro_torch.trees.convert model.json model.itrf --strip-float --pack-leaves
    python -m repro_torch.trees.convert --inspect model.itrf
    python -m repro_torch.trees.convert --verify model.itrf [--device cpu]
    python -m repro_torch.trees.convert --selftest /tmp/demo.itrf [--device cpu]

``--strip-float`` drops the float threshold/leaf-probability sections
(deterministic-serving artifact, roughly half the bytes); ``--pack-leaves``
stores the fixed-point leaf table through the exact group codec
(:mod:`repro_torch.ir.packed_leaf`).  ``--inspect`` dumps the header, the
section table, and any tuned-host entries without loading array pages.
The files are the JAX package's (``python -m repro.trees.convert``) byte
for byte, and either package reads the other's.

``--selftest`` is the end-to-end proof: train a small forest, write its
JSON, convert, then reload the artifact **in a fresh process** via mmap and
check that the reloaded reference partials are bit-identical to the
in-process ones.  ``--verify`` is that subprocess entry point: it prints
``PARTIALS_SHA256 <hex>``, the SHA-256 of the reference walk's integer
partials on 64 seeded probe rows, which is the JAX package's digest for the
same file.  Both score on the card unless ``--device cpu`` is passed.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import tempfile


def _partials_digest(ir, rows: int = 64, seed: int = 0, device=None) -> str:
    """SHA-256 of the reference backend's integer partials on deterministic
    probe rows — the cross-process (and cross-package) identity
    fingerprint."""
    import numpy as np

    from repro_torch.backends import create_backend

    rng = np.random.default_rng(seed)
    X = rng.standard_normal((rows, ir.n_features)).astype(np.float32)
    backend = create_backend("reference", ir.materialize("padded"),
                             mode="integer", device=device)
    acc = np.ascontiguousarray(np.asarray(backend.predict_partials(X)),
                               dtype="<u4")
    return hashlib.sha256(acc.tobytes()).hexdigest()


def _convert(args) -> int:
    from repro_torch.ir import ForestIR
    from repro_torch.trees.io import forest_from_json

    with open(args.input) as fh:
        forest = forest_from_json(fh.read())
    ir = ForestIR.from_forest(forest)
    info = ir.to_itrf(args.output, include_float=not args.strip_float,
                      pack_leaves=args.pack_leaves, group=args.group)
    sizes = ir.nbytes_by_layout("integer")
    print(f"wrote {info['path']}: {info['file_bytes']} bytes, "
          f"sections {info['sections']}")
    print("layout bytes (integer): "
          + "; ".join(f"{k}={v}" for k, v in sorted(sizes.items())))
    return 0


def _inspect(path) -> int:
    from repro_torch.ir.artifact import inspect_itrf

    print(json.dumps(inspect_itrf(path), indent=2))
    return 0


def _verify(path, device) -> int:
    from repro_torch.ir import ForestIR

    ir = ForestIR.from_itrf(path, mmap=True)
    print(f"PARTIALS_SHA256 {_partials_digest(ir, device=device)}")
    return 0


def _selftest(out_path, device) -> int:
    from repro_torch.data.tabular import make_shuttle_like, train_test_split
    from repro_torch.ir import ForestIR
    from repro_torch.trees.forest import RandomForestClassifier
    from repro_torch.trees.io import forest_to_json

    Xtr, ytr, _, _ = train_test_split(*make_shuttle_like(n=1500, seed=0),
                                      seed=0)
    rf = RandomForestClassifier(n_estimators=10, max_depth=8, seed=0).fit(
        Xtr, ytr)
    with tempfile.TemporaryDirectory() as tmp:
        json_path = os.path.join(tmp, "model.json")
        with open(json_path, "w") as fh:
            fh.write(forest_to_json(rf))
        rc = main([json_path, out_path, "--pack-leaves"])
    if rc:
        return rc
    expect = _partials_digest(ForestIR.from_forest(rf), device=device)
    # the fresh-process reload: a new interpreter mmaps the artifact and
    # must reproduce the in-process partials bit-for-bit
    cmd = [sys.executable, "-m", "repro_torch.trees.convert", "--verify",
           out_path]
    if device is not None:
        cmd += ["--device", str(device)]
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    sys.stderr.write(out.stderr)
    got = None
    for line in out.stdout.splitlines():
        if line.startswith("PARTIALS_SHA256 "):
            got = line.split(None, 1)[1].strip()
    if out.returncode or got != expect:
        print(f"SELFTEST FAIL: fresh-process digest {got} != {expect}")
        return 1
    print(f"SELFTEST OK: fresh-process mmap reload bit-identical ({expect})")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.trees.convert",
        description="Convert trees/io JSON models to ITRF binary artifacts.")
    ap.add_argument("input", nargs="?", help="model JSON path")
    ap.add_argument("output", nargs="?", help="output .itrf path")
    ap.add_argument("--strip-float", action="store_true",
                    help="omit float threshold/leaf-probability sections")
    ap.add_argument("--pack-leaves", action="store_true",
                    help="group-quantize/bit-pack the fixed-point leaf table")
    ap.add_argument("--group", type=int, default=None,
                    help="codec group size (default 64)")
    ap.add_argument("--inspect", metavar="ITRF",
                    help="dump an artifact's header/section table as JSON")
    ap.add_argument("--verify", metavar="ITRF",
                    help="mmap-load an artifact and print its partials digest")
    ap.add_argument("--selftest", metavar="OUT_ITRF",
                    help="train, convert, and verify in a fresh process")
    ap.add_argument("--device", default=None,
                    help="where --verify and --selftest score (default cuda; "
                         "cpu runs the plain PyTorch walk)")
    args = ap.parse_args(argv)
    if args.inspect:
        return _inspect(args.inspect)
    if args.verify:
        return _verify(args.verify, args.device)
    if args.selftest:
        return _selftest(args.selftest, args.device)
    if not args.input or not args.output:
        ap.error("need INPUT.json and OUTPUT.itrf (or one of --inspect/"
                 "--verify/--selftest)")
    return _convert(args)


if __name__ == "__main__":
    raise SystemExit(main())
