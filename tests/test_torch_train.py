"""The port's LM training half against the JAX package on the CPU: the
schedule, global norm and clipping, ``adamw_update``, the int8 compression
with error feedback, ``loss_fn`` and ``chunked_cross_entropy`` on every LM
family's smoke model (from the JAX ``init_params`` weights through
``params_from_numpy``; olmoe also with capacity drops), the gradients against
``jax.grad``, the microbatch
rule of the train step and its accumulation, and the training driver (``tests/test_launchers.py``
cases with ``--device cpu``).

Tolerances: the schedule and the norms within 1 ulp; AdamW within rtol 1e-6
(the same float32 ops, reductions aside); the compression bit for bit; the
loss within 2e-3 (float32 CE of bf16 compute); each gradient leaf within a
relative L2 difference of 3e-2 and a cosine of 0.999 (the backward through
the bf16 forward is torch's own; the worst leaf measured is zamba2's
``blocks/ssm/dt_bias``, 0.0194 apart, cosine 0.99981).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import smoke_config as jax_smoke_config
from repro.models import transformer as jtfm
from repro.train import compression as jcomp
from repro.train import optimizer as jopt
from repro.train import step as jstep
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import smoke_config
from repro_torch.data.tokens import pipeline_for
from repro_torch.models import transformer as tfm
from repro_torch.train import compression as comp
from repro_torch.train import optimizer as opt
from repro_torch.train import step as tstep
from repro_torch.train.tree import flatten_with_paths, path_key, tree_leaves, tree_map

ARCHS = ["granite-3-2b", "olmoe-1b-7b", "mamba2-370m", "zamba2-2.7b", "llava-next-34b",
         "hubert-xlarge"]
# olmoe with a capacity of half the routed pairs: the dropped pairs all land
# in the dispatch buffer's spare slot, which is cut off, so their gradient
# must be 0, as the reference's dropping scatter gives
CASES = ARCHS + ["olmoe-1b-7b@capacity=0.5"]
LOSS_TOL = 2e-3
GRAD_REL_L2, GRAD_COSINE = 3e-2, 0.999
B, S = 4, 40  # S is no multiple of the SSM chunk (32)


@pytest.fixture(autouse=True)
def _one_thread():
    """The models here are small: one intra-op thread each, which leaves the
    other test workers' cores alone."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np_tree(seed: int):
    """A float32 tree whose dict keys are not in sorted order."""
    rng = np.random.default_rng(seed)
    draw = lambda *shape: rng.normal(size=shape).astype(np.float32)
    return {"w": draw(16, 8), "nested": {"b": draw(5), "a": draw(3, 4)}, "bias": draw(7)}


def _torch(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _jnp(tree):
    return jax.tree.map(jnp.asarray, tree)


def test_lr_schedule_matches_jax_within_one_ulp():
    cfg = opt.AdamWConfig(lr=3e-3, warmup_steps=10, total_steps=100)
    jcfg = jopt.AdamWConfig(lr=3e-3, warmup_steps=10, total_steps=100)
    got = np.array([float(opt.lr_at(cfg, s)) for s in range(121)], np.float32)
    want = np.array([float(jopt.lr_at(jcfg, s)) for s in range(121)], np.float32)
    np.testing.assert_array_max_ulp(got, want, maxulp=1)
    # a tensor step gives the int step's value
    assert float(opt.lr_at(cfg, torch.tensor(37, dtype=torch.int32))) == got[37]


@pytest.mark.parametrize("max_norm", [1.0, 100.0])
def test_global_norm_and_clip_match_jax_within_one_ulp(max_norm):
    """The norm and the clip factor within 1 ulp of the reference's (the
    per-leaf sums reduce in another order); the clipped leaves are the
    leaves times that factor."""
    tree = _np_tree(1)
    norm = opt.global_norm(_torch(tree))
    jnorm = np.float32(jopt.global_norm(_jnp(tree)))
    np.testing.assert_array_max_ulp(np.float32(norm), jnorm, maxulp=1)
    clipped, n = opt.clip_by_global_norm(_torch(tree), max_norm)
    assert float(n) == float(norm)
    scale = np.float32(min(1.0, max_norm / (float(norm) + np.float32(1e-9))))
    jscale = np.minimum(np.float32(1), np.float32(max_norm) / (jnorm + np.float32(1e-9)))
    np.testing.assert_array_max_ulp(scale, jscale, maxulp=1)
    assert (scale == 1) == (max_norm == 100.0)
    for (path, got), (_, leaf) in zip(flatten_with_paths(clipped), flatten_with_paths(tree)):
        assert np.array_equal(got.numpy(), leaf * scale), path


@pytest.mark.parametrize("grad_scale", [1.0, 0.01], ids=["clipped", "unclipped"])
def test_adamw_update_matches_jax(grad_scale):
    cfg = dict(lr=2e-3, warmup_steps=4, total_steps=20)
    params, grads = _np_tree(2), tree_map(lambda a: a * grad_scale, _np_tree(3))
    m = _np_tree(4)
    v = tree_map(np.abs, _np_tree(5))
    step = np.int32(6)
    want_p, want_o, want_m = jopt.adamw_update(
        jopt.AdamWConfig(**cfg), _jnp(grads),
        {"m": _jnp(m), "v": _jnp(v), "step": jnp.asarray(step)}, _jnp(params))
    tp = _torch(params)
    got_p, got_o, got_m = opt.adamw_update(
        opt.AdamWConfig(**cfg), _torch(grads),
        {"m": _torch(m), "v": _torch(v), "step": torch.tensor(step)}, tp)
    assert got_p is tp  # in place
    assert int(got_o["step"]) == int(want_o["step"]) == 7
    assert got_o["step"].dtype == torch.int32
    for got, want in ((got_p, want_p), (got_o["m"], want_o["m"]), (got_o["v"], want_o["v"])):
        for (path, g), (_, w) in zip(flatten_with_paths(got),
                                     flatten_with_paths(jax.tree.map(np.asarray, want))):
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=0, err_msg=path_key(path))
    assert float(got_m["grad_norm"]) == pytest.approx(float(want_m["grad_norm"]), rel=1e-6)
    assert float(got_m["lr"]) == pytest.approx(float(want_m["lr"]), rel=1e-6)


def test_compress_tree_with_feedback_is_bit_identical():
    residual, jresidual = None, None
    for step in range(4):
        grads = _np_tree(10 + step)
        q, s, residual = comp.compress_tree_with_feedback(_torch(grads), residual)
        jq, js, jresidual = jcomp.compress_tree_with_feedback(_jnp(grads), jresidual)
        for got, want in ((q, jq), (s, js), (residual, jresidual)):
            for (path, g), (_, w) in zip(flatten_with_paths(got),
                                         flatten_with_paths(jax.tree.map(np.asarray, want))):
                g = g.numpy()
                assert g.dtype == w.dtype and g.shape == w.shape, path
                assert g.tobytes() == w.tobytes(), (step, path)
    deq = comp.dequantize_int8(q["w"], s["w"]).numpy()
    assert np.array_equal(deq, np.asarray(jcomp.dequantize_int8(jq["w"], js["w"])))


# ---------------------------------------------------------------------------
# the loss and its gradients on the smoke models
# ---------------------------------------------------------------------------

def _batch(cfg):
    """The token pipeline's batch, with a fifth of the labels set to -1."""
    batch = pipeline_for(cfg, B, S, seed=3).batch_at(0)
    labels = batch["labels"]
    labels[np.random.default_rng(0).random(labels.shape) < 0.2] = -1
    return batch


def _configs(case: str):
    """(the JAX config, the port's config) of ``arch`` or
    ``arch@capacity=<moe_capacity_factor>``."""
    arch, _, capacity = case.partition("@capacity=")
    jcfg, cfg = jax_smoke_config(arch), smoke_config(arch)
    if capacity:
        jcfg = dataclasses.replace(jcfg, moe_capacity_factor=float(capacity))
        cfg = dataclasses.replace(cfg, moe_capacity_factor=float(capacity))
    return jcfg, cfg


@functools.lru_cache(maxsize=None)
def _jax_case(case: str):
    """(the JAX params as numpy, the batch, JAX's loss and gradients)."""
    jcfg, cfg = _configs(case)
    jp = jtfm.init_params(jcfg, jax.random.PRNGKey(1))
    batch = _batch(cfg)
    fn = jax.jit(jax.value_and_grad(lambda p, b: jtfm.loss_fn(jcfg, p, b), has_aux=True))
    (loss, parts), grads = fn(jp, _jnp(batch))
    flat = {path_key(tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path)):
            np.asarray(g) for path, g in jax.tree_util.tree_flatten_with_path(grads)[0]}
    return jax.tree.map(np.asarray, jp), batch, float(loss), float(parts["ce"]), flat


@pytest.mark.parametrize("case", CASES)
def test_loss_and_gradients_match_jax(case):
    cfg = _configs(case)[1]
    npp, batch, want_loss, want_ce, want_grads = _jax_case(case)
    params = tfm.params_from_numpy(cfg, npp, device="cpu")
    for p in tree_leaves(params):
        p.requires_grad_(True)
    loss, parts = tfm.loss_fn(cfg, params, {k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    assert abs(loss.item() - want_loss) < LOSS_TOL, (loss.item(), want_loss)
    assert abs(parts["ce"].item() - want_ce) < LOSS_TOL
    for path, p in flatten_with_paths(params):
        got = p.grad.double().numpy().ravel()
        want = want_grads[path_key(path)].astype(np.float64).ravel()
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        cos = got @ want / (np.linalg.norm(got) * np.linalg.norm(want))
        assert rel <= GRAD_REL_L2 and cos >= GRAD_COSINE, (path_key(path), rel, cos)


def test_serving_forward_is_the_training_forward():
    """``forward_logits`` runs the backbone without recomputation; the
    training backbone (``remat=True``) gives the same hidden states and the
    same gradients."""
    cfg = smoke_config("zamba2-2.7b")
    params = tfm.init_params(cfg, 5, device="cpu")
    x, _ = tfm.embed_inputs(cfg, params, {"tokens": torch.from_numpy(
        _batch(cfg)["tokens"])})
    outs = []
    for remat in (True, False):
        p = tree_map(lambda a: a.clone().requires_grad_(True), params)
        h, _ = tfm.backbone(cfg, p, x.detach(), remat=remat)
        h.float().square().mean().backward()
        outs.append((h.detach(), [q.grad for _, q in flatten_with_paths(p)]))
    assert torch.equal(outs[0][0], outs[1][0])
    # the embedding, final norm and head take no part in the backbone
    assert sum(g is not None for g in outs[0][1]) == len(outs[0][1]) - 2
    assert all((a is None and b is None) or torch.equal(a, b)
               for a, b in zip(outs[0][1], outs[1][1]))


@pytest.mark.parametrize("arch", ["granite-3-2b", "llava-next-34b"])
def test_chunked_cross_entropy_pads_a_partial_chunk_like_jax(arch):
    """Chunks of 16 over 40 (or 24, after llava's patches) positions: the
    last chunk is padded with label -1, as the reference pads it."""
    cfg, jcfg = smoke_config(arch), jax_smoke_config(arch)
    npp, batch = _jax_case(arch)[:2]
    rng = np.random.default_rng(7)
    x = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    offset = cfg.vision_patches if cfg.family == "vlm" else 0
    want = jtfm.chunked_cross_entropy(
        jcfg, _jnp(npp), jnp.asarray(x, jnp.bfloat16), jnp.asarray(batch["labels"]),
        chunk=16, label_offset=offset)
    got = tfm.chunked_cross_entropy(
        cfg, tfm.params_from_numpy(cfg, npp, device="cpu"),
        torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(batch["labels"]),
        chunk=16, label_offset=offset)
    assert abs(float(got) - float(want)) < LOSS_TOL, (float(got), float(want))


# ---------------------------------------------------------------------------
# the train step's microbatches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b, microbatches, n_micro", [(8, 4, 4), (6, 4, 3), (5, 4, 1)])
def test_microbatch_rule_matches_jax(monkeypatch, b, microbatches, n_micro):
    """The reference's train step (traced, not run) splits its batch into
    the microbatches the port's step takes, each ``loss_fn`` call's batch
    seen; the port's step leaves each parameter the mean of the slices'
    gradients, added in slice order, bit for bit."""
    jcfg = dataclasses.replace(jax_smoke_config("granite-3-2b"), microbatches=microbatches)
    cfg = dataclasses.replace(smoke_config("granite-3-2b"), microbatches=microbatches)
    batch = pipeline_for(cfg, b, 32, seed=1).batch_at(0)
    seen = {"jax": [], "torch": []}

    def spy(fn, key):
        def wrapped(cfg_, params, mb, **kw):
            seen[key].append(mb["tokens"].shape[0])
            return fn(cfg_, params, mb, **kw)
        return wrapped

    monkeypatch.setattr(jtfm, "loss_fn", spy(jtfm.loss_fn, "jax"))
    jp = jax.eval_shape(lambda: jtfm.init_params(jcfg, jax.random.PRNGKey(1)))
    jax.eval_shape(jstep.make_train_step(jcfg), jp, jax.eval_shape(jopt.init_opt_state, jp),
                   _jnp(batch))
    assert seen["jax"] == [b // n_micro]  # traced once, inside the scan
    assert tstep.n_microbatches(b, microbatches) == n_micro

    params = tfm.init_params(cfg, 1, device="cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    size = b // n_micro
    want, want_loss = None, 0.0
    for i in range(n_micro):
        p = tree_map(lambda a: a.detach().clone().requires_grad_(True), params)
        loss, _ = tfm.loss_fn(cfg, p, {k: v[i * size:(i + 1) * size] for k, v in tb.items()})
        loss.backward()
        grads = [q.grad for q in tree_leaves(p)]
        want = grads if want is None else [a + g for a, g in zip(want, grads)]
        want_loss = want_loss + loss.detach()
    monkeypatch.setattr(tfm, "loss_fn", spy(tfm.loss_fn, "torch"))
    ostate = opt.init_opt_state(params)
    got = tstep.make_train_step(cfg, opt.AdamWConfig())
    loss, parts = tstep.accumulate_grads(cfg, params, tb, n_micro)
    assert seen["torch"] == [size] * n_micro
    assert torch.equal(loss, want_loss / n_micro if n_micro > 1 else want_loss)
    for q, w in zip(tree_leaves(params), want):
        assert torch.equal(q.grad, w / n_micro if n_micro > 1 else w)
    _, ostate, metrics = got(params, ostate, batch)
    assert int(ostate["step"]) == 1 and torch.equal(metrics["loss"], loss)
    assert all(p.grad is None for p in tree_leaves(params))


# ---------------------------------------------------------------------------
# the training driver (tests/test_launchers.py's cases, on the CPU)
# ---------------------------------------------------------------------------

def test_train_driver_loss_descends():
    from repro_torch.launch.train import main

    losses = main([
        "--arch", "granite-3-2b", "--smoke", "--steps", "30",
        "--batch", "8", "--seq", "64", "--lr", "5e-3", "--log-every", "10",
        "--device", "cpu",
    ])
    assert len(losses) == 30
    assert losses[-1] < losses[0] - 0.2, (losses[0], losses[-1])


def test_train_driver_checkpoints(tmp_path):
    from repro_torch.launch.train import main

    main([
        "--arch", "mamba2-370m", "--smoke", "--steps", "12", "--batch", "4",
        "--seq", "64", "--ckpt-dir", str(tmp_path), "--ckpt-every", "5", "--device", "cpu",
    ])
    assert CheckpointManager(tmp_path).latest_step() == 10


def test_train_driver_refuses_the_production_mesh():
    """The production mesh needs 256 ranks; a process without a group
    raises with the count it found, and never trains on a smaller mesh."""
    from repro_torch.launch.train import main

    with pytest.raises(RuntimeError, match=r"needs a process group of 256 ranks; found none"):
        main(["--arch", "granite-3-2b", "--production-mesh", "--device", "cpu"])
