"""TreeParallelPlan: carve the forest into tree-contiguous shards and merge
exact integer partial sums.

Every tree's contribution is a uint32 fixed-point addend at one
per-ensemble scale, so the ensemble sum is associative: shard partials
merge with no loss at all, which a float-accumulating ensemble cannot
promise.  Each shard is one backend built on ``ForestIR.subset``'s
sub-forest on the plan's device, and the shards run on a thread pool (the
backends' torch work and kernel launches release the interpreter lock) and
merge on the host.  Shards may run different backends: ``cuda|bitvector``
puts half the trees on K1 and half on K5 and is still bit-identical to the
single plan.

Where every shard is on the default-layout reference walk and there is a
device per shard (``fused_devices``), the plan takes the fused strategy
instead, the counterpart of the JAX package's ``shard_map``: each shard's
padded sub-forest is padded again to one ``(T', N)`` shape with inert trees
and nodes (self-looping zero-mass leaves, which add exactly 0), shard i's
tables live on device i, every shard's walk is queued from the calling
thread before any result is read, and the partials are copied to the first
device and merged there with one masked sum.  ``device_parallel="auto"``
picks it where the rule holds; ``True`` demands it and raises where the
rule fails (a heterogeneous plan, another layout, backend kwargs, or fewer
devices than shards), as in the JAX package.

Deterministic modes only: float accumulation is not associative, so a float
forest cannot be tree-sharded losslessly (use ``row_parallel``, which
shards the batch instead).
"""
from __future__ import annotations

import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from functools import reduce
from itertools import cycle, islice
from typing import Optional

import numpy as np
import torch

from repro_torch.core.ensemble import _predict, u32_numpy
from repro_torch.core.flint import float_to_key_np
from repro_torch.device import resolve_device
from repro_torch.plan.base import ExecutionPlan, as_ir, build_backend, register_plan

_DEFAULT_SHARDS = 2
_U32_MASK = 0xFFFFFFFF


def thread_shard_cap() -> int:
    """The threaded path's shard ceiling: one in-flight shard per core,
    floor 2 (shards beyond the cores contend without running at once; the
    second shard still overlaps the first's dispatch and merge on one
    core)."""
    return max(os.cpu_count() or 1, 2)


def fused_devices(device: torch.device) -> list:
    """The devices the fused strategy lays its shards on, one a shard:
    every card for a ``cuda`` plan, the one CPU for a ``cpu`` plan.  The
    selection rule and the strategy both read this list.  The threaded
    path's core cap does not apply: devices are not cores."""
    if device.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [device]


def tree_ranges(n_trees: int, shards: int) -> list:
    """Contiguous, near-equal ``[start, stop)`` tree ranges, empties dropped
    (a 3-tree forest asked for 8 shards runs 3 single-tree shards)."""
    bounds = np.linspace(0, n_trees, min(int(shards), n_trees) + 1).astype(int)
    return [(int(a), int(b)) for a, b in zip(bounds[:-1], bounds[1:]) if b > a]


@register_plan
class TreeParallelPlan(ExecutionPlan):
    name = "tree_parallel"
    deterministic_only = True

    def __init__(self, model, *, mode: str = "integer", backend="reference",
                 shards=None, layout: Optional[str] = None,
                 backend_kwargs: Optional[dict] = None, device=None,
                 device_parallel="auto", clamp_shards: bool = True):
        ir = as_ir(model)
        super().__init__(ir, mode=mode)
        if not self._spec.deterministic:
            raise ValueError(
                f"tree_parallel needs exact integer partials; mode {mode!r} "
                "accumulates floats — shard the batch (row_parallel) instead"
            )
        if isinstance(backend, str):
            names = [backend] * int(shards or _DEFAULT_SHARDS)
        else:  # heterogeneous: a sequence of backend names, cycled over shards
            names = list(islice(cycle(backend), int(shards or len(backend))))
        if not names:
            raise ValueError("tree_parallel needs at least one shard")
        self.ir = ir
        self.device = resolve_device(device)
        self.ranges = tree_ranges(ir.n_trees, len(names))
        names = names[: len(self.ranges)]
        self._fused = None
        self._shard_backends: tuple = ()
        self._labels: list = []
        if self._can_fuse(names, layout, backend_kwargs, device_parallel):
            self._build_fused()
        else:
            if device_parallel is True:
                raise ValueError(
                    "device_parallel=True needs a homogeneous 'reference' "
                    "plan (default layout, no backend kwargs) and at least "
                    f"{len(self.ranges)} {self.device.type} devices"
                )
            # oversubscription cap (threaded path only): shards beyond the
            # core budget cannot run concurrently, they just contend.  An
            # explicit heterogeneous backend mix is an explicit fan-out
            # request and is honored as asked; clamp_shards=False opts a
            # homogeneous plan out.
            cap = thread_shard_cap()
            if clamp_shards and isinstance(backend, str) and len(self.ranges) > cap:
                self.ranges = tree_ranges(ir.n_trees, cap)
                names = names[: len(self.ranges)]
            self._shard_backends = tuple(
                build_backend(name, ir.subset(a, b), mode, layout, backend_kwargs,
                              self.device)
                for name, (a, b) in zip(names, self.ranges)
            )
            self._labels = [f"s{i}:{b.name}[{a}:{e}]" for i, (b, (a, e))
                            in enumerate(zip(self._shard_backends, self.ranges))]
        self._pool = None  # threaded path: created lazily, released by close()
        self._pool_lock = threading.Lock()

    # ----------------------------------------------------------- strategies
    def _can_fuse(self, names, layout, backend_kwargs, device_parallel) -> bool:
        """The JAX package's rule for the fused strategy: asked for (or
        auto), two or more shards, all on the default-layout reference
        walk, and a device per shard (``fused_devices``)."""
        if not device_parallel or len(self.ranges) < 2:
            return False
        if any(n != "reference" for n in names) or backend_kwargs:
            return False
        if layout not in (None, "padded"):
            return False
        return len(fused_devices(self.device)) >= len(self.ranges)

    def _build_fused(self) -> None:
        """Pad every shard's padded tables to one (T', N) with inert trees
        and nodes (feature -1, key 0, children looping to themselves, zero
        leaves: each adds exactly 0 to the uint32 accumulator, so fusing
        cannot perturb partials) and put shard i's on device i, as the
        tensors the reference walk reads."""
        subs = [self.ir.subset(a, b).materialize("padded") for a, b in self.ranges]
        S = len(subs)
        C = self.ir.n_classes
        Tp = max(s.n_trees for s in subs)
        N = max(s.feature.shape[1] for s in subs)
        selfloop = np.tile(np.arange(N, dtype=np.int64), (Tp, 1))
        self._fused_devices = fused_devices(self.device)[:S]
        self._fused = []
        for s, dev in zip(subs, self._fused_devices):
            T0, N0 = s.feature.shape
            tables = dict(feature=np.full((Tp, N), -1, np.int64),
                          threshold=np.zeros((Tp, N), np.int32),
                          left=selfloop.copy(), right=selfloop.copy(),
                          leaf=np.zeros((Tp, N, C), np.int64))
            tables["feature"][:T0, :N0] = s.feature
            tables["threshold"][:T0, :N0] = s.threshold_key
            tables["left"][:T0, :N0] = s.left
            tables["right"][:T0, :N0] = s.right
            tables["leaf"][:T0, :N0] = s.leaf_fixed
            self._fused.append({k: torch.from_numpy(v).to(dev) for k, v in tables.items()})
        self._depth = int(self.ir.max_depth)
        self._fused_label = f"fused:reference[x{S}]"

    def _run_fused(self, keys: np.ndarray) -> np.ndarray:
        """Every shard's walk queued on its device, then the partials
        copied to the first device and summed there (int64, masked to 32
        bits: the uint32 sum, associative, so the merged accumulator is the
        single plan's bits)."""
        parts = [_predict(tables, torch.from_numpy(keys).to(dev), self._depth, True)
                 for tables, dev in zip(self._fused, self._fused_devices)]
        home = self._fused_devices[0]
        acc = sum(p.view(torch.int32).to(home).to(torch.int64) & _U32_MASK for p in parts)
        return u32_numpy((acc & _U32_MASK).to(torch.int32))

    # ------------------------------------------------------------ execution
    def predict_partials(self, X):
        X = np.asarray(X, np.float32)
        # capture the parent span on the dispatching thread: the shard pool
        # threads get it via submit args, not via the thread-local
        parent = self.trace_parent
        if self._fused is not None:
            # the partials are read back inside the timed span, so it holds
            # the device work and the merge on the first device
            return self._timed(self._fused_label, self._run_fused, float_to_key_np(X),
                               span_parent=parent)
        pool = self._ensure_pool()
        futs = [
            pool.submit(self._timed, lab, b.predict_partials, X, span_parent=parent)
            for lab, b in zip(self._labels, self._shard_backends)
        ]
        partials = [np.asarray(f.result()) for f in futs]
        # uint32 adds wrap mod 2^32: the exact merge (the IR's scale keeps a
        # whole forest's sum from wrapping)
        t0 = time.perf_counter_ns()
        merged = reduce(np.add, partials)
        t1 = time.perf_counter_ns()
        self._record_stage("merge", (t1 - t0) / 1e6)
        self._span("merge", t0, t1, parent, shards=len(partials))
        return merged

    def _ensure_pool(self) -> ThreadPoolExecutor:
        # callers on several threads (gateway executors) share the plan:
        # create the pool once, under a lock
        with self._pool_lock:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(
                    max_workers=len(self._shard_backends),
                    thread_name_prefix="tree-shard",
                )
            return self._pool

    def close(self) -> None:
        """Drain in-flight shard dispatches and release the pool.  The plan
        stays usable — the next ``predict_partials`` re-creates the pool —
        because registry-memoized engines outlive one gateway."""
        with self._pool_lock:
            pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown(wait=True)

    # -------------------------------------------------------------- metadata
    @property
    def fused(self) -> bool:
        """True when the shards run as the fused device computation."""
        return self._fused is not None

    @property
    def backends(self) -> tuple:
        return self._shard_backends

    @property
    def packed(self):
        return self.ir

    @property
    def n_shards(self) -> int:
        return len(self.ranges)

    @property
    def compiles_per_shape(self) -> bool:
        if self._fused is not None:
            return True  # the reference walk, as its backend declares
        return super().compiles_per_shape

    @property
    def backend_name(self) -> str:
        if self._fused is not None:
            return "reference"
        return super().backend_name

    def describe(self) -> dict:
        d = super().describe()
        d.update(shards=self.n_shards, tree_ranges=self.ranges, fused=self.fused)
        return d
