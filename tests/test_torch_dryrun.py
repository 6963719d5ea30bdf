"""The port's dry run and its cost analyses against the JAX package's, on
the CPU: ``launch.specs``, ``launch.op_cost`` (``jaxpr_cost``'s
counterpart), ``launch.comm_analysis`` (``hlo_analysis``') and
``launch.dryrun``, and fault D's repair seen through them.

The port's side runs in this process: a fake process group (its
collectives do nothing) and ``meta`` tensors, so full-width shapes cost no
memory.  The reference's side runs in a subprocess on 8 forced host
devices, as ``tests/test_distributed.py`` runs it.

Tolerances: argument bytes and contraction flops exactly equal to the
reference's; total flops within ``FLOPS_TOL`` of its ``jaxpr_cost`` (the
elementwise ops differ between a jaxpr and aten: 0.41% measured on the
olmoe smoke loss, all of it outside the contractions: aten's ``mul``,
``add``, ``neg``, ``reciprocal`` and ``_to_copy`` against the jaxpr's
``mul``, ``logistic``, ``sub``, ``div`` and ``convert_element_type``); the trip-count
ratio in (9, 11), as the reference's test; collective bytes exact on a
hand case; local shapes exact.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import torch.utils._python_dispatch

from repro_torch.configs import get_config, smoke_config
from repro_torch.launch import comm_analysis, dryrun, op_cost
from repro_torch.launch import specs as sp
from repro_torch.launch.mesh import compat_make_mesh, make_production_mesh
from repro_torch.launch.shapes import SHAPES
from repro_torch.models import transformer as tfm
from repro_torch.sharding import ops, rules
from repro_torch.sharding.ops import P, use_mesh
from repro_torch.train import optimizer as opt
from repro_torch.train.step import make_train_step
from repro_torch.train.tree import flatten_with_paths, path_key

ROOT = Path(__file__).resolve().parents[1]
FLOPS_TOL = 0.01
# the ceiling on the port's mesh contraction flops over the reference
# mesh's (the ``model`` ranks' replicated pieces)
TP_FLOPS_RATIO = 1.15
LM_ARCHS = ("gemma3-27b", "granite-34b", "granite-3-2b", "hubert-xlarge", "llava-next-34b",
            "mamba2-370m", "olmoe-1b-7b", "qwen3-moe-30b-a3b", "starcoder2-3b", "zamba2-2.7b")
PRODUCTION = {"16x16": (False, dict(data=16, model=16)),
              "2x16x16": (True, dict(pod=2, data=16, model=16))}

# the reference's side of (a): tests/test_distributed.py's
# test_dryrun_entry_on_small_mesh, with its argument bytes and its flops
# (all, and the contractions' alone by jaxpr_cost's own rule)
JAX_SIDE = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import json
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs.base import smoke_config
from repro.launch import jaxpr_cost
from repro.launch.hlo_analysis import collective_bytes
from repro.launch.mesh import compat_make_mesh
from repro.models import transformer as tfm
from repro.sharding import rules
from repro.sharding.ops import use_mesh

def dot_flops(jaxpr, k=1.0):
    total = 0.0
    for e in jaxpr.eqns:
        name = e.primitive.name
        if name == "dot_general":
            total += k * jaxpr_cost._dot_cost(e, set()).flops
        elif name == "scan":
            total += dot_flops(e.params["jaxpr"].jaxpr, k * e.params["length"])
        elif name == "shard_map":
            total += dot_flops(e.params["jaxpr"], k * e.params["mesh"].size)
        else:
            for key in ("jaxpr", "call_jaxpr", "fun_jaxpr"):
                if key in e.params:
                    sub = e.params[key]
                    total += dot_flops(getattr(sub, "jaxpr", sub), k)
                    break
    return total

cfg = smoke_config("olmoe-1b-7b")
mesh = compat_make_mesh((2, 4), ("data", "model"))
with mesh, use_mesh(mesh):
    shapes = tfm.param_shapes(cfg)
    sh = rules.params_shardings(shapes, mesh)
    params = jax.tree.map(lambda s, h: jax.ShapeDtypeStruct(s.shape, s.dtype, sharding=h),
                          shapes, sh)
    bs = NamedSharding(mesh, P("data", None))
    batch = {k: jax.ShapeDtypeStruct((8, 64), jnp.int32, sharding=bs) for k in ("tokens", "labels")}
    fn = lambda p, b: tfm.loss_fn(cfg, p, b)[0]
    jc = jaxpr_cost.analyze(fn, params, batch)
    dots = dot_flops(jax.make_jaxpr(fn)(params, batch).jaxpr)
    compiled = jax.jit(fn).lower(params, batch).compile()
    cb = collective_bytes(compiled.as_text())
    ma = compiled.memory_analysis()
# the one program: the global batch, no mesh
plain = {k: jax.ShapeDtypeStruct(v.shape, v.dtype) for k, v in batch.items()}
one = jaxpr_cost.analyze(fn, shapes, plain)
one_dots = dot_flops(jax.make_jaxpr(fn)(shapes, plain).jaxpr)
# serving on the same mesh: a prefill of the 8 x 64 tokens into a cache of
# 64 positions, and a decode step over such a cache placed by
# cache_shardings, the batch placed by batch_pspec
serve = {}
with mesh, use_mesh(mesh):
    cache = jax.eval_shape(lambda: tfm.init_cache(cfg, 8, 64))
    cache = jax.tree.map(lambda s, h: jax.ShapeDtypeStruct(s.shape, s.dtype, sharding=h),
                         cache, rules.cache_shardings(mesh, cache))
    cells = {"prefill": (lambda p, b: tfm.prefill(cfg, p, b, max_seq=64),
                         (params, {"tokens": batch["tokens"]})),
             "decode": (lambda p, c, t: tfm.decode_step(cfg, p, c, t),
                        (params, cache, jax.ShapeDtypeStruct((8, 1), jnp.int32, sharding=bs)))}
    for mode, (f, args) in cells.items():
        serve[mode] = {"dot_flops": dot_flops(jax.make_jaxpr(f)(*args).jaxpr),
                       "argument": jax.jit(f).lower(*args).compile().memory_analysis()
                       .argument_size_in_bytes}

# the mamba2 smoke model's in-projection on the same mesh, as the compiled
# program computes it per device: the widths of the dots whose right operand
# is a (d_model, k) weight contracted on d_model, the head's (the vocabulary,
# whole or over model) left out, in the train step, prefill and decode
import re
from repro.train import optimizer as jopt
from repro.train.step import make_train_step

def in_proj_widths(text, d_model, head):
    shapes = dict(re.findall(r"(%[\\w.-]+) = \\w+\\[([\\d,]*)\\]", text))
    widths = set()
    dots = r"= \\w+\\[[\\d,]*\\]\\S* dot\\(%[\\w.-]+, (%[\\w.-]+)\\),([^\\n]*)"
    for rhs, rest in re.findall(dots, text):
        dims = [int(d) for d in shapes[rhs].split(",")]
        if "rhs_contracting_dims={0}" in rest and len(dims) == 2 and dims[0] == d_model \\
                and dims[1] not in head:
            widths.add(dims[1])
    return sorted(widths)

scfg = smoke_config("mamba2-370m")
head = {scfg.vocab_size, scfg.vocab_size // 4}
ssm_cols = {}
with mesh, use_mesh(mesh):
    shapes = tfm.param_shapes(scfg)
    sh = rules.params_shardings(shapes, mesh)
    params = jax.tree.map(lambda s, h: jax.ShapeDtypeStruct(s.shape, s.dtype, sharding=h),
                          shapes, sh)
    ostate = {"m": params, "v": params,
              "step": jax.ShapeDtypeStruct((), jnp.int32, sharding=NamedSharding(mesh, P()))}
    cache = jax.eval_shape(lambda: tfm.init_cache(scfg, 8, 64))
    cache = jax.tree.map(lambda s, h: jax.ShapeDtypeStruct(s.shape, s.dtype, sharding=h),
                         cache, rules.cache_shardings(mesh, cache))
    programs = {"train": (make_train_step(scfg, jopt.AdamWConfig()), (params, ostate, batch)),
                "prefill": (lambda p, b: tfm.prefill(scfg, p, b, max_seq=64),
                            (params, {"tokens": batch["tokens"]})),
                "decode": (lambda p, c, t: tfm.decode_step(scfg, p, c, t),
                           (params, cache, jax.ShapeDtypeStruct((8, 1), jnp.int32, sharding=bs)))}
    for mode, (f, args) in programs.items():
        text = jax.jit(f).lower(*args).compile().as_text()
        ssm_cols[mode] = in_proj_widths(text, scfg.d_model, head)
print(json.dumps({"flops": jc["flops"], "dot_flops": dots, "coll": cb["total"],
                  "temp": ma.temp_size_in_bytes, "argument": ma.argument_size_in_bytes,
                  "one_flops": one["flops"], "one_dot_flops": one_dots, "serve": serve,
                  "ssm_in_cols": ssm_cols}))
"""


@pytest.fixture(scope="module")
def reference():
    proc = subprocess.run([sys.executable, "-c", JAX_SIDE], capture_output=True, text=True,
                          timeout=560, cwd=ROOT,
                          env=dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _contraction_flops(by_op: dict) -> float:
    return sum(v for k, v in by_op.items() if k in op_cost._CONTRACTIONS)


def test_dryrun_entry_on_small_mesh_against_the_reference(reference):
    """(a) The olmoe smoke loss on a fake (data 2, model 4) mesh, rank 0's
    rows through the model split over ``model`` (each layer gathered over
    ``data`` into its ``model`` blocks), through the dry run's analyses:
    flops, collectives and temporaries as the reference's test asks;
    argument bytes equal to the reference's compiled program's; the one
    program's flops (the global batch, no mesh, as ``jaxpr_cost.analyze``
    traces it) equal in the contractions and within FLOPS_TOL in all; and
    the 8 ranks' contraction flops within ``TP_FLOPS_RATIO`` of the
    reference mesh program's."""
    cfg = smoke_config("olmoe-1b-7b")
    with dryrun.fake_world(8), compat_make_mesh((2, 4), ("data", "model"), device="cpu") as mesh, \
            use_mesh(mesh):
        params = sp.params_specs(cfg, mesh)
        batch = {k: sp.sds((8, 64), torch.int32, mesh, P("data", None))
                 for k in ("tokens", "labels")}
        blocks = ops.blocks(params, rules.params_shardings(params, mesh))
        fn = lambda p, b: tfm.loss_fn(cfg, p, {k: v.to_local() for k, v in b.items()})[0]
        rec = dryrun.measure(fn, (blocks, batch), trains=False, chips=8)
    assert rec["jaxpr_cost"]["flops"] > 1e6
    assert rec["collectives"]["total"] > 0
    assert rec["collectives"]["counts"]["all-gather"] > 0
    assert rec["memory"]["temp_size_in_bytes"] > 0
    assert rec["memory"]["argument_size_in_bytes"] == reference["argument"]
    assert reference["flops"] > 1e6 and reference["coll"] > 0 and reference["temp"] > 0

    whole = tfm.param_shapes(cfg)
    tokens = torch.zeros((8, 64), dtype=torch.int32, device="meta")
    one = op_cost.analyze(lambda p, b: tfm.loss_fn(cfg, p, b)[0], whole,
                          {"tokens": tokens, "labels": tokens})
    assert _contraction_flops(one["by_op"]) == reference["one_dot_flops"]
    gap = abs(one["flops"] - reference["one_flops"]) / reference["one_flops"]
    assert gap < FLOPS_TOL, (gap, {k: v for k, v in one["by_op"].items()
                                   if k not in op_cost._CONTRACTIONS})
    # the mesh programs: the port's 8 ranks split over ``model`` the work
    # the reference splits (1.94 times its contraction flops while the
    # ``model`` ranks repeated it); what remains above 1 is the replicated
    # router, computed alike by each ``model`` rank
    ratio = _contraction_flops(rec["jaxpr_cost"]["by_op"]) / reference["dot_flops"]
    assert ratio <= TP_FLOPS_RATIO, ratio


# the ceiling on the port's serving cells' contraction flops over the
# reference mesh program's, each rank on its rows: what repeats is the
# replicated router, computed alike by each ``model`` rank
SERVE_FLOPS_RATIO = 1.10


@pytest.mark.parametrize("mode", ["prefill", "decode"])
def test_dryrun_serving_on_small_mesh_against_the_reference(mode, reference):
    """(a) for serving, fault E: the olmoe smoke model's prefill of 8 x 64
    tokens and a decode step over a cache of 64 positions placed by
    ``rules.cache_shardings``, on the fake (data 2, model 4) mesh, the
    batch as ``DTensor``s over ``data`` (``rules.batch_pspec``), through the
    dry run's analyses: each rank serves its rows, so the 8 ranks'
    contraction flops are within ``SERVE_FLOPS_RATIO`` of the reference
    mesh program's (about the ``data`` extent, 2, while every rank served
    the whole batch), and a rank's argument bytes equal the reference's
    compiled program's (its ``pos``, a 4-byte array there, is a Python int
    here)."""
    cfg = smoke_config("olmoe-1b-7b")
    with dryrun.fake_world(8), compat_make_mesh((2, 4), ("data", "model"), device="cpu") as mesh, \
            use_mesh(mesh):
        params = sp.params_specs(cfg, mesh)
        blocks = ops.blocks(params, rules.params_shardings(params, mesh))
        if mode == "prefill":
            batch = {"tokens": sp.sds((8, 64), torch.int32, mesh, P("data", None))}
            fn, args = (lambda p, b: tfm.prefill(cfg, p, b, max_seq=64)), (blocks, batch)
        else:
            cache = tfm.init_cache(cfg, 8, 64, device="meta")
            pos = cache.pop("pos")
            sh = rules.cache_shardings(mesh, cache)
            cache = {**ops.blocks(rules.place(cache, sh), sh), "pos": pos}
            tokens = sp.sds((8, 1), torch.int32, mesh, P("data", None))
            fn, args = (lambda p, c, t: tfm.decode_step(cfg, p, c, t)), (blocks, cache, tokens)
        rec = dryrun.measure(fn, args, trains=False, chips=8)
    want = reference["serve"][mode]
    ratio = _contraction_flops(rec["jaxpr_cost"]["by_op"]) / want["dot_flops"]
    print(f"{mode}: the 8 ranks' contraction flops {ratio:.4f} times the reference mesh "
          f"program's (limit {SERVE_FLOPS_RATIO})")
    assert ratio <= SERVE_FLOPS_RATIO, ratio
    pos_bytes = 4 if mode == "decode" else 0
    assert rec["memory"]["argument_size_in_bytes"] + pos_bytes == want["argument"]


class _InProjection(torch.utils._python_dispatch.TorchDispatchMode):
    """The widths k of the ``mm``s whose right operand is a (d_model, k)
    weight, the head's widths ``skip`` left out: the in-projection's."""

    def __init__(self, d_model: int, skip):
        super().__init__()
        self.d_model, self.skip, self.widths = d_model, set(skip), set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.mm.default:
            rows, k = args[1].shape
            if rows == self.d_model and k not in self.skip:
                self.widths.add(k)
        return func(*args, **(kwargs or {}))


def _rank_program(cfg, mesh, mode: str):
    """(the program, its arguments) of ``mode`` for the mamba2 smoke model
    on ``mesh``, as the dry run lowers a cell: the train step on the
    parameters and moments as ``DTensor``s, prefill and decode on blocks,
    the batch of 8 x 64 tokens over ``data``."""
    tokens = lambda s: sp.sds((8, s), torch.int32, mesh, P("data", None))
    params = sp.params_specs(cfg, mesh)
    if mode == "train":
        return make_train_step(cfg, opt.AdamWConfig()), \
            (params, sp.opt_state_specs(cfg, mesh), {"tokens": tokens(64), "labels": tokens(64)})
    blocks = ops.blocks(params, rules.params_shardings(params, mesh))
    if mode == "prefill":
        return (lambda p, b: tfm.prefill(cfg, p, b, max_seq=64)), (blocks, {"tokens": tokens(64)})
    cache = tfm.init_cache(cfg, 8, 64, device="meta")
    pos = cache.pop("pos")
    sh = rules.cache_shardings(mesh, cache)
    cache = {**ops.blocks(rules.place(cache, sh), sh), "pos": pos}
    return (lambda p, c, t: tfm.decode_step(cfg, p, c, t)), (blocks, cache, tokens(1))


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_ssm_in_projection_is_split_as_the_reference_compiles_it(mode, reference):
    """Fault F: on (data 2, model 4) each ``model`` rank of the mamba2 smoke
    model computes as many in-projection columns as the reference's
    compiled program computes per device (137 of 548: its heads' z, x and
    dt columns and a quarter of B's and of C's), in the train step, prefill
    and decode; and the ranks' columns, as each gathers them
    (``Block.model_pieces``), make the whole in-projection once.  Each
    ``model`` rank runs in a fake process group as that rank, on ``meta``
    tensors.  With every rank computing all of B and C, each computed
    (548 - 32) / 4 + 32 = 161."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    cfg = smoke_config("mamba2-370m")
    d_inner = cfg.ssm_expand * cfg.d_model
    width = 2 * d_inner + 2 * cfg.ssm_state + d_inner // 64
    want = reference["ssm_in_cols"][mode]
    assert want == [width // 4]
    taken = []
    for rank in range(4):  # data 0, model 0 to 3
        dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=8)
        real, seen = ops.gather_block, []

        def spy(local, spec, mesh_, **kw):
            if kw.get("pieces") is not None and kw["pieces"][0] == 1:
                seen.append(kw["pieces"][1][mesh_.axis_index("model")])
            return real(local, spec, mesh_, **kw)

        ops.gather_block = spy
        try:
            with compat_make_mesh((2, 4), ("data", "model"), device="cpu") as mesh, \
                    use_mesh(mesh), torch.set_grad_enabled(mode == "train"):
                fn, args = _rank_program(cfg, mesh, mode)
                with _InProjection(cfg.d_model, {cfg.vocab_size, cfg.vocab_size // 4}) as mm:
                    fn(*args)
        finally:
            ops.gather_block = real
            if dist.is_initialized():
                dist.destroy_process_group()
        assert sorted(mm.widths) == want, (rank, sorted(mm.widths))
        assert seen and all(p == seen[0] for p in seen)
        assert sum(n for _, n in seen[0]) == want[0]
        taken += [c for start, n in seen[0] for c in range(start, start + n)]
    assert sorted(taken) == list(range(width))


def test_trip_count_awareness():
    """(b) Ten chained matmuls against one: the flops scale with the count
    (eager runs every iteration), as the reference's scan walk does."""
    def make(n):
        def f(x, w):
            for _ in range(n):
                x = x @ w
            return x
        return f

    a = torch.empty((64, 64), device="meta")
    r = op_cost.analyze(make(10), a, a)["flops"] / op_cost.analyze(make(1), a, a)["flops"]
    assert 9.0 < r < 11.0


def test_collective_bytes_on_a_hand_case():
    """(c) Over a fake group of 8: an all-gather of a (4, 8) float32 block
    gives 8 x 128 bytes, a reduce-scatter of (16, 8) float32 this rank's
    (2, 8), an all-reduce of 3 floats 12 bytes; through the port's named
    collectives and the c10d calls alike."""
    import torch.distributed as dist

    def collectives(mesh):
        x = torch.empty((4, 8), device="meta")
        assert ops._collective("all_gather", x, mesh.group("data"), dim=0).shape == (32, 8)
        rs = ops._collective("reduce_scatter", torch.empty((16, 8)), mesh.group("data"))
        assert rs.shape == (2, 8)
        ops.psum(torch.zeros(3), "data", mesh)
        dist.all_gather_into_tensor(torch.empty((32, 8), device="meta"), x)

    with dryrun.fake_world(8), compat_make_mesh((8,), ("data",), device="cpu") as mesh:
        _, got = comm_analysis.collective_bytes(collectives, mesh)
    assert got["all-gather"] == 2 * 8 * 4 * 8 * 4
    assert got["reduce-scatter"] == 2 * 8 * 4
    assert got["all-reduce"] == 12
    assert got["total"] == 2 * 1024 + 64 + 12
    assert got["counts"] == {"all-gather": 2, "reduce-scatter": 1, "all-reduce": 1}


class FakeMesh:
    """Duck-typed mesh: the reference's rules only touch .shape."""

    def __init__(self, **axes):
        self.shape = axes


def _jax_local_shapes(tree, spec_of, mesh) -> dict:
    import jax

    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(p.key) for p in path)
        out[key] = sp.local_shape(leaf.shape, mesh, tuple(spec_of(path, leaf)))
    return out


@pytest.mark.parametrize("mesh_name", list(PRODUCTION))
@pytest.mark.parametrize("arch", LM_ARCHS + ("intreeger-rf",))
def test_specs_local_shapes_equal_the_reference(arch, mesh_name, monkeypatch):
    """(d) Every block ``specs`` places on rank 0 of the production mesh
    (parameters, moments, the decode caches, the tree tables and rows) has
    the shape the reference's ``spec_for`` / ``cache_shardings`` imply on a
    duck-typed mesh of the same axes."""
    import jax

    from repro.configs.base import get_config as jax_get_config
    from repro.launch import shapes as jax_shapes
    from repro.models import transformer as jax_tfm
    from repro.sharding import rules as jax_rules

    multi_pod, axes = PRODUCTION[mesh_name]
    fake = FakeMesh(**axes)
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    local = lambda tree: {path_key(p): tuple(t.to_local().shape)
                          for p, t in flatten_with_paths(tree) if torch.is_tensor(t)}
    with dryrun.fake_world(512 if multi_pod else 256), \
            make_production_mesh(multi_pod=multi_pod, device="cpu") as mesh:
        if cfg.family == "trees":
            rows = local({"x": sp.tree_input_specs(cfg, "serve_1m", mesh)})["x"]
            assert rows == (1_048_576 // mesh.size, cfg.n_tab_features)
            tables = local(sp.tree_table_specs(cfg, mesh))
            assert tables["leaf_fixed"] == (cfg.n_trees, 2 ** (cfg.tree_depth + 1) - 1,
                                            cfg.n_classes)
            return
        want = _jax_local_shapes(jax_tfm.param_shapes(jcfg),
                                 lambda path, leaf: jax_rules.spec_for(path, leaf.shape, fake),
                                 fake)
        assert local(sp.params_specs(cfg, mesh)) == want
        ostate = sp.opt_state_specs(cfg, mesh)
        assert local(ostate["m"]) == local(ostate["v"]) == want
        monkeypatch.setattr(jax_rules, "NamedSharding", lambda mesh, spec: spec)
        for shape_name in ("decode_32k", "long_500k"):
            if shape_name not in jax_shapes.applicable_shapes(jcfg):
                continue
            info = SHAPES[shape_name]
            jcache = jax.eval_shape(lambda: jax_tfm.init_cache(jcfg, info["batch"], info["seq"]))
            jcache.pop("pos")
            specs_ = jax_rules.cache_shardings(fake, jcache, shard_seq=shape_name == "long_500k")
            flat = {"/".join(str(p.key) for p in path): s for path, s in
                    jax.tree_util.tree_flatten_with_path(
                        specs_, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]}
            want_cache = _jax_local_shapes(
                jcache, lambda path, leaf: flat["/".join(str(p.key) for p in path)], fake)
            cache, _ = sp.cache_specs(cfg, shape_name, mesh)
            assert cache.pop("pos") == 0
            assert local(cache) == want_cache, shape_name


def test_fault_d_a_rank_of_the_mesh_holds_under_a_quarter():
    """(e) Fault D: granite-3-2b at full width (meta tensors), one train
    step on a global batch of 8 x 512 tokens.  A rank of a (data 2, model
    4) mesh peaks, by the dry run's tracker, under a quarter of the same
    step's peak with no mesh (whole float32 parameters, gradients and
    moments).  A step that gathers the whole parameters and keeps whole
    gradients on every rank peaks above half."""
    cfg = get_config("granite-3-2b")
    batch = {k: torch.zeros((8, 512), dtype=torch.int32, device="meta")
             for k in ("tokens", "labels")}
    step = make_train_step(cfg, opt.AdamWConfig())
    params = tfm.param_shapes(cfg)
    ostate = opt.init_opt_state(params)
    _, plain = comm_analysis.tracked_peak(lambda: step(params, ostate, batch),
                                          (params, ostate, batch))
    with dryrun.fake_world(8), compat_make_mesh((2, 4), ("data", "model"), device="cpu") as mesh, \
            use_mesh(mesh):
        params = sp.params_specs(cfg, mesh)
        ostate = sp.opt_state_specs(cfg, mesh)
        sharded_batch = {k: sp.sds((8, 512), torch.int32, mesh, P("data", None))
                         for k in ("tokens", "labels")}
        _, peak = comm_analysis.tracked_peak(lambda: step(params, ostate, sharded_batch),
                                             (params, ostate, sharded_batch))
    n = sum(t.numel() for _, t in flatten_with_paths(tfm.param_shapes(cfg)))
    assert plain > 4 * 4 * n  # float32 parameters, gradients, m and v at least
    assert peak < plain / 4, (peak / 2**30, plain / 2**30)
