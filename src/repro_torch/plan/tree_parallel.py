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

The JAX package has a second, fused strategy: all shards on the reference
walk in one ``shard_map`` over one device per shard.  The port keeps its
selection rule (:meth:`TreeParallelPlan._can_fuse`, counting the devices of
the plan's kind) but not the strategy, which waits for a machine with
several cards: where the rule picks it, ``device_parallel="auto"`` takes the
threaded path, which gives the same bits, and ``device_parallel=True``
raises.  On fewer devices than shards, as on one card or the CPU, "auto"
takes the threaded path and ``True`` raises, as in the JAX package.

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

from repro_torch.device import resolve_device
from repro_torch.plan.base import ExecutionPlan, as_ir, build_backend, register_plan

_DEFAULT_SHARDS = 2
_FUSED_NOT_PORTED = ("the fused (device-parallel) tree_parallel strategy is not "
                     "ported yet: it waits for a machine with several cards")


def thread_shard_cap() -> int:
    """The threaded path's shard ceiling: one in-flight shard per core,
    floor 2 (shards beyond the cores contend without running at once; the
    second shard still overlaps the first's dispatch and merge on one
    core)."""
    return max(os.cpu_count() or 1, 2)


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
        # where the JAX package's rule picks the fused strategy (not ported),
        # "auto" takes the threaded path, whose bits are the same; only an
        # explicit ask for it raises
        fuse = self._can_fuse(names, layout, backend_kwargs, device_parallel)
        if device_parallel is True:
            if fuse:
                raise ValueError(f"{_FUSED_NOT_PORTED}; pass device_parallel=False "
                                 "or \"auto\" for the threaded path")
            raise ValueError(
                "device_parallel=True needs a homogeneous 'reference' "
                "plan (default layout, no backend kwargs) and at least "
                f"{len(self.ranges)} {self.device.type} devices; "
                f"{_FUSED_NOT_PORTED}"
            )
        # oversubscription cap: shards beyond the core budget cannot run
        # concurrently, they just contend.  An explicit heterogeneous
        # backend mix is an explicit fan-out request and is honored as
        # asked; clamp_shards=False opts a homogeneous plan out.
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
        self._pool = None  # created lazily, released by close()
        self._pool_lock = threading.Lock()

    def _can_fuse(self, names, layout, backend_kwargs, device_parallel) -> bool:
        """The JAX package's rule for the fused strategy: asked for (or
        auto), two or more shards, all on the default-layout reference
        walk, and a device of the plan's kind per shard."""
        if not device_parallel or len(self.ranges) < 2:
            return False
        if any(n != "reference" for n in names) or backend_kwargs:
            return False
        if layout not in (None, "padded"):
            return False
        devices = torch.cuda.device_count() if self.device.type == "cuda" else 1
        return devices >= len(self.ranges)

    # ------------------------------------------------------------ execution
    def predict_partials(self, X):
        X = np.asarray(X, np.float32)
        # capture the parent span on the dispatching thread: the shard pool
        # threads get it via submit args, not via the thread-local
        parent = self.trace_parent
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
        self._record_stage("merge", (t1 - t0) / 1e9)
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
        """Whether the shards run as one fused device computation: never in
        the port (the fused strategy is not ported)."""
        return False

    @property
    def backends(self) -> tuple:
        return self._shard_backends

    @property
    def packed(self):
        return self.ir

    @property
    def n_shards(self) -> int:
        return len(self.ranges)

    def describe(self) -> dict:
        d = super().describe()
        d.update(shards=self.n_shards, tree_ranges=self.ranges, fused=self.fused)
        return d
