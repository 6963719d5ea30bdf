"""The port's checkpoints and restarts: ``tests/test_checkpoint.py``'s cases
on the port (atomic commit, async save and GC, partial writes ignored, the
crash-restart loop and its limit, the straggler watchdog, int8 error
feedback), checkpoints that cross between the packages in both directions
bit for bit (the same files byte for byte from the same tree), and the
elastic re-mesh plan equal to the JAX package's."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JaxCheckpointManager
from repro.launch.mesh import elastic_mesh_shape as jax_elastic_mesh_shape
from repro_torch.checkpoint.fault_tolerance import (RestartableLoop, StepWatchdog,
                                                    plan_elastic_remesh)
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.launch.mesh import elastic_mesh_shape
from repro_torch.train.compression import compress_tree_with_feedback, dequantize_int8
from repro_torch.train.tree import flatten_with_paths, tree_map


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "a": torch.from_numpy(rng.normal(size=(16, 8)).astype(np.float32)),
        "nested": {"b": torch.from_numpy(rng.integers(0, 5, (4,)).astype(np.int32)),
                   "step": torch.tensor(7, dtype=torch.int32)},
    }


def _assert_same(got, want):
    for (path, g), (_, w) in zip(flatten_with_paths(got), flatten_with_paths(want)):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, path
        assert g.tobytes() == w.tobytes(), path


def test_save_restore_roundtrip(tmp_path):
    mgr = CheckpointManager(tmp_path)
    t = _tree()
    mgr.save(3, t)
    assert mgr.latest_step() == 3
    restored = mgr.restore(3, tree_map(torch.zeros_like, t))
    assert all(torch.is_tensor(x) for _, x in flatten_with_paths(restored))
    _assert_same(restored, t)


def test_async_save_copies_before_the_caller_moves_on(tmp_path):
    """The tensors go to the host before the thread starts: an update in
    place right after ``save`` returns does not reach the files."""
    mgr = CheckpointManager(tmp_path)
    t = _tree()
    want = tree_map(torch.clone, t)
    mgr.save(1, t, blocking=False)
    t["a"].add_(1.0)
    mgr.wait()
    _assert_same(mgr.restore(1, t), want)


@pytest.mark.parametrize("blocking", [True, False])
def test_save_and_gc(tmp_path, blocking):
    mgr = CheckpointManager(tmp_path, keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, _tree(s), blocking=blocking)
        mgr.wait()
    steps = sorted(int(p.name.split("_")[1]) for p in tmp_path.glob("step_*"))
    assert steps == [3, 4]


def test_partial_write_not_restored(tmp_path):
    """A crash mid-save must never be picked up (no COMMITTED marker)."""
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, _tree())
    broken = tmp_path / "step_000000009"
    broken.mkdir()
    (broken / "MANIFEST.json").write_text("{}")  # no COMMITTED
    (tmp_path / "step_000000011.tmp").mkdir()
    assert mgr.latest_step() == 1


def test_restartable_loop_recovers(tmp_path):
    mgr = CheckpointManager(tmp_path)
    crashes = {"left": 2}

    def step_fn(state, step):
        if step == 7 and crashes["left"] > 0:
            crashes["left"] -= 1
            raise RuntimeError("injected node failure")
        return {"x": state["x"] + 1}

    loop = RestartableLoop(mgr, ckpt_every=5, max_restarts=5)
    state, info = loop.run({"x": torch.zeros(())}, step_fn, total_steps=12)
    assert info["restarts"] == 2
    assert float(state["x"]) == 12  # deterministic despite crashes


def test_restart_limit(tmp_path):
    mgr = CheckpointManager(tmp_path)

    def bad(state, step):
        raise RuntimeError("always")

    loop = RestartableLoop(mgr, max_restarts=2)
    with pytest.raises(RuntimeError):
        loop.run({"x": torch.zeros(())}, bad, total_steps=3)


def test_watchdog_flags_stragglers():
    wd = StepWatchdog(factor=3.0)
    for _ in range(10):
        assert not wd.observe(0.1)
    assert wd.observe(1.0)  # 10x median
    assert wd.stragglers == 1


def test_int8_compression_error_feedback():
    rng = np.random.default_rng(0)
    g = {"w": torch.from_numpy(rng.normal(size=(512,)).astype(np.float32))}
    residual = None
    acc_err = []
    est_sum = np.zeros(512)
    exact_sum = np.zeros(512)
    for step in range(20):
        q, s, residual = compress_tree_with_feedback(g, residual)
        est_sum += dequantize_int8(q["w"], s["w"]).numpy()
        exact_sum += g["w"].numpy()
        acc_err.append(np.abs(est_sum - exact_sum).max())
    # error feedback keeps cumulative drift bounded (does not grow ~linearly)
    assert acc_err[-1] < 3 * max(acc_err[:3]) + 1e-3


def test_bfloat16_leaf_is_refused(tmp_path):
    with pytest.raises(TypeError, match="bfloat16"):
        CheckpointManager(tmp_path).save(1, {"w": torch.zeros(3, dtype=torch.bfloat16)})
    assert CheckpointManager(tmp_path).latest_step() is None


def test_restore_raises_on_a_missing_leaf(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(2, {"a": torch.zeros(2)})
    with pytest.raises(KeyError, match="missing leaves"):
        mgr.restore(2, {"a": torch.zeros(2), "b": torch.zeros(1)})


# ---------------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------------

def _dir_bytes(step_dir):
    return {p.name: p.read_bytes() for p in sorted(step_dir.iterdir())}


def test_checkpoints_cross_between_the_packages(tmp_path):
    """The same tree saved by each package gives the same files byte for
    byte; each package restores the other's bit for bit."""
    t = _tree(3)
    jt = jax.tree.map(lambda x: jnp.asarray(x.numpy()), t)
    CheckpointManager(tmp_path / "torch").save(5, t)
    JaxCheckpointManager(tmp_path / "jax").save(5, jt)
    ours, theirs = (_dir_bytes(tmp_path / d / "step_000000005") for d in ("torch", "jax"))
    assert ours == theirs
    manifest = json.loads(ours["MANIFEST.json"])
    assert list(manifest["leaves"]) == ["a", "nested/b", "nested/step"]

    # a JAX checkpoint restored by the port, onto the target's device
    from_jax = CheckpointManager(tmp_path / "jax").restore(5, tree_map(torch.zeros_like, t))
    _assert_same(from_jax, t)
    assert all(x.device.type == "cpu" for _, x in flatten_with_paths(from_jax))
    # the port's checkpoint restored by the JAX package
    from_torch = JaxCheckpointManager(tmp_path / "torch").restore(
        5, jax.tree.map(jnp.zeros_like, jt))
    _assert_same(from_torch, t)


def test_training_state_crosses_to_jax(tmp_path):
    """A training state (params and AdamW state) the port saves restores in
    the JAX package into the JAX optimizer's own structure."""
    from repro.train import optimizer as jopt
    from repro_torch.configs import smoke_config
    from repro_torch.models import transformer as tfm
    from repro_torch.train import optimizer as opt

    params = tfm.init_params(smoke_config("granite-3-2b"), 0, device="cpu")
    state = {"params": params, "opt": opt.init_opt_state(params)}
    CheckpointManager(tmp_path).save(3, state)
    jparams = jax.tree.map(lambda x: jnp.zeros(x.shape, jnp.float32), params,
                           is_leaf=torch.is_tensor)
    target = {"params": jparams, "opt": jopt.init_opt_state(jparams)}
    _assert_same(JaxCheckpointManager(tmp_path).restore(3, target), state)


def test_elastic_mesh_shape_matches_jax():
    for n in range(1, 1025):
        assert elastic_mesh_shape(n) == jax_elastic_mesh_shape(n), n
        assert elastic_mesh_shape(n, model=8) == jax_elastic_mesh_shape(n, model=8), n
    assert plan_elastic_remesh(480) == jax_elastic_mesh_shape(480)
