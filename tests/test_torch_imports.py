"""Import hygiene: the port and ``chip_smoke.py`` import neither JAX nor any
module of the JAX package.  Every module of the port is imported, and the
modules of the gateway slice, of the QuickScorer and sharded-plan slice and
of the deployment slice (ITRF, ``packed_leaf``, the converter, the worker
fabric) and of the host-C slice (the emitters, the C backends, ``gbt``)
must be among them."""
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

_PROBE = r"""
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
sys.path.insert(0, sys.argv[1])
import chip_smoke  # noqa: F401  (its top level only; main() needs a card)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m.startswith("jaxlib.") or m == "repro" or m.startswith("repro."))
missing = sorted(set(sys.argv[2].split(",")) - set(names))
print(len(names), bad, missing)
sys.exit(1 if bad or missing or len(names) < 20 else 0)
"""

GATEWAY_SLICE = [f"repro_torch.{m}" for m in (
    "obs", "obs.histogram", "obs.trace", "obs.export",
    "serve.metrics", "serve.cache", "serve.queue", "serve.registry",
    "serve.gateway", "serve.autotune", "trees.cart", "trees.forest", "trees.io",
)]
QUICKSCORER_AND_PLANS_SLICE = [f"repro_torch.{m}" for m in (
    "ir.bitvector", "kernels.bitvector", "backends.bitvector",
    "plan.tree_parallel", "plan.row_parallel",
)]
DEPLOYMENT_SLICE = [f"repro_torch.{m}" for m in (
    "data.tabular", "ir.packed_leaf", "ir.artifact", "trees.convert",
    "serve.wire", "serve.worker", "plan.remote",
)]
HOST_C_SLICE = [f"repro_torch.{m}" for m in (
    "codegen", "codegen.c_emitter", "codegen.table_emitter",
    "codegen.bitvector_emitter", "codegen.native_bench", "backends.native_c",
    "backends.native_c_table", "backends.native_c_bitvector", "trees.gbt",
)]


def test_port_imports_no_jax_and_no_repro():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", _PROBE, str(ROOT),
                           ",".join(GATEWAY_SLICE + QUICKSCORER_AND_PLANS_SLICE
                                    + DEPLOYMENT_SLICE + HOST_C_SLICE)],
                          env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
