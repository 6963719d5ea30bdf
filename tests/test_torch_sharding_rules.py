"""The port's sharding rules, shapes and roofline against the JAX package's
(``tests/test_sharding_rules.py``'s cases and more): the rules are pure
data, so both packages read the same duck-typed mesh (``.shape`` only) and
must give the same spec, entry for entry, for every parameter leaf of every
full-size architecture, every batch size, and every decode architecture's
cache.  The reference's abstract shapes come from ``jax.eval_shape``, the
port's from ``meta`` tensors."""
import jax
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.launch import roofline as jax_roofline
from repro.launch import shapes as jax_shapes
from repro.models import transformer as jax_tfm
from repro.sharding import rules as jax_rules
from repro_torch.configs import get_config
from repro_torch.launch import roofline, shapes
from repro_torch.models import transformer as tfm
from repro_torch.sharding import rules
from repro_torch.sharding.ops import P, resolve
from repro_torch.train.tree import flatten_with_paths, path_key


class FakeMesh:
    """Duck-typed mesh: rules only touch .shape."""

    def __init__(self, **axes):
        self.shape = axes


LM_ARCHS = ("gemma3-27b", "granite-34b", "granite-3-2b", "hubert-xlarge", "llava-next-34b",
            "mamba2-370m", "olmoe-1b-7b", "qwen3-moe-30b-a3b", "starcoder2-3b", "zamba2-2.7b")
ALL_ARCHS = LM_ARCHS + ("intreeger-rf",)
MESHES = {
    "16x16": dict(data=16, model=16),
    "2x16x16": dict(pod=2, data=16, model=16),
    "2x4": dict(data=2, model=4),
    "1x1": dict(data=1, model=1),
}


def _jax_key(path) -> str:
    return "/".join(str(p.key) if isinstance(p, jax.tree_util.DictKey) else str(p.idx)
                    for p in path)


def _jax_specs(tree, fn) -> dict:
    return {_jax_key(path): tuple(fn(path, leaf))
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_divisibility_fallback():
    mesh = FakeMesh(data=16, model=16)
    # granite-3-2b vocab 49155 is not divisible by 16 -> replicated dim
    assert rules.spec_for(("embed",), (49155, 2048), mesh) == P(None, "data")
    assert rules.spec_for(("embed",), (262144, 5376), mesh) == P("model", "data")


def test_stacked_block_params_get_leading_none():
    mesh = FakeMesh(data=16, model=16)
    assert rules.spec_for(("blocks", "attn", "wq"), (48, 6144, 6144), mesh) == \
        P(None, "data", "model")


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_spec_for_equals_the_reference_on_every_leaf(arch, mesh_name):
    mesh = FakeMesh(**MESHES[mesh_name])
    want = _jax_specs(jax_tfm.param_shapes(jax_get_config(arch)),
                      lambda path, leaf: jax_rules.spec_for(path, leaf.shape, mesh))
    shapes_ = tfm.param_shapes(get_config(arch))
    assert all(t.device.type == "meta" for _, t in flatten_with_paths(shapes_))
    got = {path_key(path): rules.spec_for(path, tuple(leaf.shape), mesh)
           for path, leaf in flatten_with_paths(shapes_)}
    assert got == want
    # params_shardings carries the same specs, leaf for leaf
    shard = {path_key(p): s.spec for p, s in
             flatten_with_paths(rules.params_shardings(shapes_, mesh))}
    assert shard == got
    # and every sharded dimension divides its axes
    for path, leaf in flatten_with_paths(shapes_):
        for dim, ax in zip(leaf.shape, got[path_key(path)]):
            if ax is not None:
                assert dim % mesh.shape[ax] == 0, (arch, path, leaf.shape)


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_batch_pspec_and_shardings_equal_the_reference(mesh_name, monkeypatch):
    """The reference's NamedSharding needs a real mesh: with a duck-typed
    one its specs are read through a stand-in."""
    monkeypatch.setattr(jax_rules, "NamedSharding", lambda mesh, spec: spec)
    mesh = FakeMesh(**MESHES[mesh_name])
    for b in (1, 2, 3, 4, 8, 16, 24, 32, 48, 64, 128, 256, 512):
        assert tuple(rules.batch_pspec(mesh, b)) == tuple(jax_rules.batch_pspec(mesh, b)), b
        batch = {"tokens": torch.zeros((b, 8), dtype=torch.int32),
                 "patches": torch.zeros((b, 4, 3))}
        want = jax_rules.batch_shardings(mesh, {k: jax.ShapeDtypeStruct(v.shape, "float32")
                                                for k, v in batch.items()})
        got = rules.batch_shardings(mesh, batch)
        assert {k: s.spec for k, s in got.items()} == {k: tuple(v) for k, v in want.items()}


def test_batch_pspec_cases():
    mesh = FakeMesh(data=16, model=16, pod=2)
    assert rules.batch_pspec(mesh, 256) == P(("pod", "data"))
    assert rules.batch_pspec(mesh, 1) == P()
    assert rules.batch_pspec(mesh, 16) == P(("pod",))


DECODE_ARCHS = [a for a in LM_ARCHS if jax_get_config(a).has_decode]


@pytest.mark.parametrize("shard_seq", [False, True])
@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_cache_shardings_equal_the_reference(arch, shard_seq, monkeypatch):
    """Over each decode architecture's cache at decode_32k's and
    long_500k's shapes, on three meshes.  The reference's cache_shardings
    wraps each spec in a NamedSharding on the mesh; with a duck-typed mesh
    its specs are read through a stand-in NamedSharding."""
    monkeypatch.setattr(jax_rules, "NamedSharding", lambda mesh, spec: spec)
    for shape_name in ("decode_32k", "long_500k"):
        info = jax_shapes.SHAPES[shape_name]
        b, s = info["batch"], info["seq"]
        jcache = jax.eval_shape(lambda: jax_tfm.init_cache(jax_get_config(arch), b, s))
        cache = tfm.init_cache(get_config(arch), b, s, device="meta")
        for mesh_name in ("16x16", "2x16x16", "2x4"):
            mesh = FakeMesh(**MESHES[mesh_name])
            want = {_jax_key(p): tuple(spec) for p, spec in jax.tree_util.tree_flatten_with_path(
                jax_rules.cache_shardings(mesh, jcache, shard_seq=shard_seq),
                is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]}
            got = {path_key(p): sh.spec for p, sh in flatten_with_paths(
                rules.cache_shardings(mesh, cache, shard_seq=shard_seq))}
            assert got == want, (arch, shape_name, mesh_name)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_cells_and_model_flops_equal_the_reference(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    names = list(shapes.SHAPES) + list(shapes.TREE_SHAPES) + ["no_such_shape"]
    for name in names:
        assert shapes.cell_applicable(cfg, name) == jax_shapes.cell_applicable(jcfg, name)
    assert shapes.applicable_shapes(cfg) == jax_shapes.applicable_shapes(jcfg)
    for name in shapes.applicable_shapes(cfg):
        assert roofline.model_flops(cfg, name) == jax_roofline.model_flops(jcfg, name)


def test_the_cell_matrix():
    runnable = {a: shapes.applicable_shapes(get_config(a)) for a in LM_ARCHS}
    assert sum(len(v) for v in runnable.values()) == 32
    assert runnable["hubert-xlarge"] == ["train_4k", "prefill_32k"]
    assert shapes.applicable_shapes(get_config("intreeger-rf")) == ["serve_1m", "serve_64k"]


def test_roofline_terms_follow_the_reference_with_the_h100_rates(monkeypatch):
    """``terms`` is the reference's formula; its rates are one H100's."""
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.LINK_BW) == (989e12, 3.35e12, 450e9)
    for name in ("PEAK_FLOPS", "HBM_BW", "LINK_BW"):
        monkeypatch.setattr(jax_roofline, name, getattr(roofline, name))
    records = [
        dict(chips=256, jaxpr_cost=dict(flops=3.2e18, bytes_lb=4.1e15),
             collectives=dict(total=2.2e10), model_flops=2.9e18),
        dict(chips=512, jaxpr_cost=dict(flops=1e12, bytes_lb=9e14),
             collectives=dict(total=1e6)),
        dict(chips=8, jaxpr_cost=dict(flops=1e9, bytes_lb=1e6),
             collectives=dict(total=7e12), model_flops=1e9),
        dict(chips=1, jaxpr_cost=dict(flops=0.0, bytes_lb=0.0),
             collectives=dict(total=0.0)),
    ]
    for rec in records:
        assert roofline.terms(rec) == jax_roofline.terms(rec)


@pytest.mark.parametrize("logical", [("batch", None, "tp", None), ("seq", "tp"),
                                     ("rows", None), ("expert", None, None), (None,)])
def test_constrain_rule_resolves_as_the_reference(logical, monkeypatch):
    """``resolve`` is the reference ``constrain``'s divisibility rule; the
    reference's sharding call is swapped for one that records its spec."""
    from repro.sharding import ops as jax_ops

    captured = {}
    monkeypatch.setattr(jax_ops, "NamedSharding", lambda mesh, spec: spec)
    monkeypatch.setattr(jax_ops.jax.lax, "with_sharding_constraint",
                        lambda x, spec: captured.update(spec=tuple(spec)))
    for axes in (dict(data=2, model=4), dict(pod=2, data=16, model=16), dict(data=1, model=1)):
        mesh = FakeMesh(**axes)
        for shape in ((8, 6, 8, 3), (32, 64, 16, 5), (1, 1, 1, 1), (6, 4, 4, 1)):
            shape = shape[:len(logical)]
            with jax_ops.use_mesh(mesh):
                jax_ops.constrain(jax.ShapeDtypeStruct(shape, "float32"), *logical)
            assert tuple(resolve(mesh, shape, logical)) == captured["spec"], (axes, shape)
