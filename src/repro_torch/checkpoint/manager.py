"""Checkpointing with async save, atomic commit, and resume: the PyTorch
counterpart of the JAX package's ``checkpoint/manager.py``, on its on-disk
protocol, so either package restores the other's checkpoints.

Layout (one directory per step):
    <dir>/step_000123/
        MANIFEST.json      {step, leaves: {path: {file, shape, dtype}}}
        <leaf-path>.npy    one file per tree leaf, its path's "/" as "__"
        COMMITTED          written last — a checkpoint without it is ignored

Contract (the reference's):
  * saves are atomic: a step is written under ``step_<n>.tmp`` and renamed
    once ``COMMITTED`` is in it, so a partial write is never restored,
  * ``latest_step`` skips uncommitted or corrupt directories,
  * the newest ``keep`` committed steps are kept.

Tensors are copied to the host before an async save's thread starts, so the
caller may go on updating them in place; a ``DTensor`` is gathered whole
first.  ``restore`` puts each leaf on the device of the target's leaf (or
on ``device``) and, given ``shardings`` (``sharding.rules.NamedSharding``
leaves), places it by its sharding: the elastic re-mesh path restores onto
whatever mesh the restarted job has.  numpy has no bfloat16, so a bf16 leaf
is refused rather than widened: training state is float32 and int32.
"""
from __future__ import annotations

import json
import pathlib
import shutil
import threading
from typing import Optional

import numpy as np
import torch

from repro_torch.train.tree import flatten_with_paths, path_key, unflatten_like


def _flatten(tree) -> dict:
    """``{"a/b/c": leaf}`` in the JAX package's leaf order."""
    return {path_key(path): leaf for path, leaf in flatten_with_paths(tree)}


def _to_host(key: str, leaf) -> np.ndarray:
    """A copy of ``leaf`` as a numpy array (never a view of a tensor the
    caller may update while the save runs)."""
    if torch.is_tensor(leaf):
        from repro_torch.sharding.ops import gather

        leaf = gather(leaf)
        if leaf.dtype == torch.bfloat16:
            raise TypeError(f"checkpoint leaf {key!r} is bfloat16, which numpy cannot hold; "
                            "save float32 (the training state is float32 and int32)")
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(leaf, copy=True)


class CheckpointManager:
    def __init__(self, directory, keep: int = 3):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree, *, blocking: bool = True):
        self.wait()
        flat = {key: _to_host(key, leaf) for key, leaf in _flatten(tree).items()}

        def _write():
            tmp = self.dir / f"step_{step:09d}.tmp"
            final = self.dir / f"step_{step:09d}"
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir(parents=True)
            manifest = {"step": step, "leaves": {}}
            for key, arr in flat.items():
                fn = key.replace("/", "__") + ".npy"
                np.save(tmp / fn, arr)
                manifest["leaves"][key] = {
                    "file": fn,
                    "shape": list(arr.shape),
                    "dtype": str(arr.dtype),
                }
            (tmp / "MANIFEST.json").write_text(json.dumps(manifest))
            (tmp / "COMMITTED").write_text("ok")
            if final.exists():
                shutil.rmtree(final)
            tmp.rename(final)
            self._gc()

        if blocking:
            _write()
        else:
            def _run():
                try:
                    _write()
                except Exception as exc:  # re-raised by wait() in the caller
                    self._error = exc

            self._thread = threading.Thread(target=_run, daemon=True)
            self._thread.start()

    def wait(self):
        """Wait for an async save; raises what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            error, self._error = self._error, None
            raise error

    def _gc(self):
        steps = sorted(self._committed_steps())
        for s in steps[: -self.keep]:
            shutil.rmtree(self.dir / f"step_{s:09d}", ignore_errors=True)

    # --------------------------------------------------------------- restore
    def _committed_steps(self):
        out = []
        for p in self.dir.glob("step_*"):
            if p.suffix == ".tmp" or not (p / "COMMITTED").exists():
                continue
            try:
                out.append(int(p.name.split("_")[1]))
            except (IndexError, ValueError):
                continue
        return out

    def latest_step(self) -> Optional[int]:
        steps = self._committed_steps()
        return max(steps) if steps else None

    def restore(self, step: int, target_tree, shardings=None, device=None):
        """Restore into the structure of ``target_tree``: a tensor leaf
        comes back as a tensor on ``device`` or, by default, on the target
        leaf's device, and as a ``DTensor`` placed by its sharding where
        ``shardings`` (a tree of ``NamedSharding``, or a part of one) has
        one; any other leaf as a numpy array."""
        from repro_torch.sharding import ops

        d = self.dir / f"step_{step:09d}"
        manifest = json.loads((d / "MANIFEST.json").read_text())
        flat_target = _flatten(target_tree)
        flat_shard = _flatten(shardings) if shardings is not None else {}
        missing = set(flat_target) - set(manifest["leaves"])
        if missing:
            raise KeyError(f"checkpoint at step {step} missing leaves: {sorted(missing)[:5]}")
        restored = {}
        for key, want in flat_target.items():
            arr = np.load(d / manifest["leaves"][key]["file"])
            s = flat_shard.get(key)
            if torch.is_tensor(want) or s is not None:
                where = device if device is not None else (
                    want.device if torch.is_tensor(want) else s.mesh.device_type)
                arr = torch.from_numpy(arr).to(where)
            if s is not None:
                arr = ops.from_local(ops.local_block(arr, s.mesh, s.spec).contiguous(), s.mesh,
                                     s.spec)
            restored[key] = arr
        return unflatten_like(target_tree, restored)
