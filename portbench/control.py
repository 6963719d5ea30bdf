"""The control: the plain reference of the cell's family put in the program's
place, on rows rounded to bfloat16, the precision below the float32 rows the
configuration states (the step that would halve the host-to-device copy).  Its
answers differ from the float32 reference wherever a rounded row crosses a
threshold, so the comparison has to come out not correct.

    python3 portbench/control.py --workload <cell> --seed <n> --seconds <s>

runs the cell as ``run.py`` does, with every ``TreeEngine.predict_scores``
answered by the control; the benchmark's own runs never load this module.
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def install(run) -> None:
    """Answer every ``TreeEngine.predict_scores`` with the cell's family's
    reference in bfloat16 over the model that ``run`` makes for the cell."""
    import torch
    from repro_torch.serve.engine import TreeEngine

    made = {}
    family_of = run.catalog.family

    def family(cfg, *args, **kwargs):
        fam = family_of(cfg, *args, **kwargs)
        make_forest = fam.make_forest

        def make(cfg, seed):
            forest = make_forest(cfg, seed)
            made["ref"] = fam.Reference(forest, run.DEVICE, rows_dtype=torch.bfloat16)
            return forest

        fam.make_forest = make
        return fam

    run.catalog.family = family
    TreeEngine.predict_scores = lambda self, X: made["ref"].scores(np.asarray(X, np.float32))


if __name__ == "__main__":
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from portbench import run as run_module

    install(run_module)
    sys.exit(run_module.main(sys.argv[1:] + ["--trace", "0"]))
