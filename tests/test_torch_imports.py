"""Import hygiene: the port and ``chip_smoke.py`` import neither JAX nor any
module of the JAX package.  Every module of the port is imported, and the
modules of the gateway slice, of the QuickScorer and sharded-plan slice and
of the deployment slice (ITRF, ``packed_leaf``, the converter, the worker
fabric), of the host-C slice (the emitters, the C backends, ``gbt``), of
the drivers-and-LM slice (configs, the token pipeline, the serving step, the
driver, the examples, the LM models), of the training slice and of the mesh
slice (``sharding``, the mesh constructors, shapes, roofline, and the
modules with mesh branches) and of ``core`` (with the reference's predict
helpers) must be among them."""
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

DRIVERS_AND_LM_SLICE = [f"repro_torch.{m}" for m in (
    "configs", "configs.base", *(f"configs.{a}" for a in (
        "gemma3_27b", "granite_34b", "granite_3_2b", "hubert_xlarge", "intreeger_rf",
        "llava_next_34b", "mamba2_370m", "olmoe_1b_7b", "qwen3_moe_30b_a3b",
        "starcoder2_3b", "zamba2_2_7b")),
    "data.tokens", "core.serving", "launch", "launch.serve", "examples",
    "examples.quickstart", "examples.serve_trees_scaled", "models", "models.layers",
    "models.ssm", "models.moe", "models.transformer",
)]

TRAIN_SLICE = [f"repro_torch.{m}" for m in (
    "train", "train.tree", "train.optimizer", "train.compression",
    "train.intreeger_allreduce", "train.step", "checkpoint", "checkpoint.manager",
    "checkpoint.fault_tolerance", "launch.mesh", "launch.train", "examples.train_lm",
    "examples.integer_allreduce_demo",
)]


MESH_SLICE = [f"repro_torch.{m}" for m in (
    "sharding", "sharding.ops", "sharding.rules", "launch.mesh", "launch.shapes",
    "launch.roofline", "models.layers", "models.moe", "core.serving", "train.step",
    "train.optimizer", "launch.train", "checkpoint.manager",
)]

# the reference's ``core`` predict helpers (``predict_float`` ...
# ``make_predict_fn``), exported from ``repro_torch.core``
CORE_SLICE = [f"repro_torch.{m}" for m in (
    "core", "core.ensemble", "core.fixedpoint", "core.flint", "core.packing",
)]


def test_port_imports_no_jax_and_no_repro():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", _PROBE, str(ROOT),
                           ",".join(GATEWAY_SLICE + QUICKSCORER_AND_PLANS_SLICE
                                    + DEPLOYMENT_SLICE + HOST_C_SLICE
                                    + DRIVERS_AND_LM_SLICE + TRAIN_SLICE
                                    + MESH_SLICE + CORE_SLICE)],
                          env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
