"""The ExecutionPlan protocol and the name-keyed plan registry.

A plan sits between the serving engine and the backend layer and decides how
one logical forest is carved across executors:

    engine -> ExecutionPlan -> backend.predict_partials -> merge -> finalize

The integer-only accumulation is what makes the split sound: the
deterministic modes (flint/integer) accumulate exact uint32 partials, and
uint32 addition is associative, so a forest cut into tree-contiguous
sub-forests (``ForestIR.subset``) and merged gives the single plan's bits,
whichever backend computed each shard.  Finalize
(``core.ensemble.finalize_partials``) runs exactly once, on the merged
uint32 accumulator.

Three registered plans:
  * ``single``        — one backend, the whole forest.
  * ``tree_parallel`` — tree shards, one backend each (possibly different
                        backends), run on a thread pool; uint32 merge.
  * ``row_parallel``  — batch shards over one backend; bit-exact for every
                        mode, float included.
Plans that only serve exact-integer partial modes set
``deterministic_only = True`` so the gateway rejects the route up front.
A margin model (boosted trees) merges its shards as the same wrapping uint32
sums, exact mod 2^32; its finalize reads them as int32 and adds the base.
It takes the ``integer`` mode only, and ``remote_tree_parallel`` refuses it.

Tracing is duck-typed: a tracer is any object with
``record(name, t0_ns, t1_ns, parent=..., **attrs)``.  While a
``torch.profiler`` records, each shard's call is a ``plan.shard`` range and
the finalize a ``plan.finalize`` range (``repro_torch.obs.profiled``); a
margin model's signed view, base add and argmax are a ``plan.margins`` range
inside it, recorded as the stage ``margins``.
"""
from __future__ import annotations

import abc
import threading
from typing import ClassVar, Optional

from repro_torch.core.ensemble import finalize_margins, finalize_partials, mode_spec
from repro_torch.ir.forest_ir import margin_ir, refuse_margins
from repro_torch.obs import stage


def build_backend(backend, model, mode: str, layout: Optional[str],
                  backend_kwargs: Optional[dict], device=None):
    """Resolve one shard's backend: a registered name (materialize the wanted
    layout, then construct on ``device``) or an already-built instance (then
    the artifact, mode and device are taken from it; a conflicting layout
    pin fails loudly)."""
    from repro_torch.backends import backend_class, create_backend
    from repro_torch.ir import resolve_artifact

    if isinstance(backend, str):
        caps = backend_class(backend).capabilities
        wanted = layout or caps.preferred_layout
        caps.require_layout(wanted, backend)
        return create_backend(
            backend, resolve_artifact(model, wanted), mode=mode, device=device,
            **(backend_kwargs or {})
        )
    if layout is not None and getattr(backend, "layout", "padded") != layout:
        raise ValueError(
            f"layout {layout!r} conflicts with the constructed "
            f"backend's artifact (layout {backend.layout!r}); "
            "materialize the backend on the wanted layout instead"
        )
    return backend


def as_ir(model):
    """The canonical ForestIR behind ``model`` (IR or any layout artifact)."""
    from repro_torch.ir import ForestIR

    if isinstance(model, ForestIR):
        return model
    ir = getattr(model, "ir", None)
    if ir is not None:
        return ir
    if hasattr(model, "to_ir"):
        return model.to_ir()
    raise ValueError(
        f"cannot shard a {type(model).__name__!r} artifact: no ForestIR "
        "back-reference to carve sub-forests from"
    )


class ExecutionPlan(abc.ABC):
    """How one logical forest is executed: shards, merge, finalize."""

    name: ClassVar[str]
    #: True for plans that only serve exact-integer partial modes (the
    #: gateway validates the route against this before building engines)
    deterministic_only: ClassVar[bool] = False

    def __init__(self, model, *, mode: str = "integer"):
        if mode != "integer":
            refuse_margins(model, f"mode {mode!r} under plan {self.name!r}")
        self.mode = mode
        self._spec = mode_spec(mode)
        # the FULL ensemble's finalize constants
        self._n_trees = getattr(model, "n_trees", None)
        self._scale = getattr(model, "scale", None)
        ir = margin_ir(model)
        self._base = None if ir is None else ir.base_fixed
        self._timings: dict = {}
        self._stages: dict = {}
        self._timings_lock = threading.Lock()
        self._tracer = None
        self._trace_tls = threading.local()

    # ------------------------------------------------------------ execution
    @abc.abstractmethod
    def predict_partials(self, X):
        """Float features (B, F) -> merged (B, C) uint32 partials."""

    def predict_scores(self, X):
        """(scores, preds) via the standalone finalize over merged partials."""
        if not self.deterministic:
            raise NotImplementedError(
                f"plan {self.name!r} must override predict_scores for the "
                f"non-deterministic mode {self.mode!r}"
            )
        acc = self.predict_partials(X)
        with stage("plan.finalize", self._record_stage, "finalize", self._tracer,
                   self.trace_parent):
            if self._base is None:
                return finalize_partials(self.mode, acc, self._n_trees, self._scale)
            with stage("plan.margins", self._record_stage, "margins", self._tracer,
                       self.trace_parent):
                return finalize_margins(acc, self._base)

    # ------------------------------------------------------- shard metadata
    @property
    @abc.abstractmethod
    def backends(self) -> tuple:
        """The shard backends."""

    @property
    @abc.abstractmethod
    def packed(self):
        """A metadata-bearing artifact for the full forest."""

    @property
    def n_shards(self) -> int:
        return max(len(self.backends), 1)

    @property
    def deterministic(self) -> bool:
        return self._spec.deterministic

    @property
    def compiles_per_shape(self) -> bool:
        return any(b.capabilities.compiles_per_shape for b in self.backends)

    @property
    def preferred_block_rows(self) -> Optional[int]:
        hints = [b.capabilities.preferred_block_rows for b in self.backends]
        hints = [h for h in hints if h]
        return max(hints) if hints else None

    @property
    def layout(self) -> str:
        layouts = []
        for b in self.backends:
            if b.layout not in layouts:
                layouts.append(b.layout)
        return "+".join(layouts) if layouts else "padded"

    @property
    def backend_name(self) -> str:
        names = []
        for b in self.backends:
            if b.name not in names:
                names.append(b.name)
        return "+".join(names) if names else self.name

    def describe(self) -> dict:
        return {
            "plan": self.name,
            "mode": self.mode,
            "shards": self.n_shards,
            "backends": [b.name for b in self.backends],
            "layout": self.layout,
        }

    # ------------------------------------------------- timing + trace spans
    def attach_tracer(self, tracer) -> None:
        """Attach a tracer (plan-wide; idempotent)."""
        self._tracer = tracer

    @property
    def trace_parent(self):
        """The span that parents this thread's execution spans."""
        return getattr(self._trace_tls, "parent", None)

    @trace_parent.setter
    def trace_parent(self, span) -> None:
        self._trace_tls.parent = span

    def _span(self, name: str, t0_ns: int, t1_ns: int, parent, **attrs) -> None:
        """Commit one completed span under ``parent`` (no-op when untraced)."""
        if parent and self._tracer is not None:
            self._tracer.record(name, t0_ns, t1_ns, parent=parent, **attrs)

    def _record(self, label: str, ms: float) -> None:
        with self._timings_lock:
            total, calls = self._timings.get(label, (0.0, 0))
            self._timings[label] = (total + ms, calls + 1)

    def _record_stage(self, name: str, ms: float) -> None:
        """Accumulate one pipeline-stage sample (pad/merge/finalize)."""
        with self._timings_lock:
            total, calls = self._stages.get(name, (0.0, 0))
            self._stages[name] = (total + ms, calls + 1)

    def _timed(self, label: str, fn, *args, span_parent=None):
        """Run ``fn`` timing it into the shard ledger (and a span when
        traced).  Backends return host arrays, so the wall time includes
        the device work.  Shard pool threads receive the parent span
        explicitly (captured by the dispatching thread), never via the
        thread-local.  The profiler range is ``plan.shard`` whatever the
        label, which stays the span's."""
        with stage("plan.shard", self._record, label, self._tracer, span_parent,
                   f"shard:{label}", label=label):
            return fn(*args)

    def drain_timings(self) -> dict:
        """Per-shard wall time since the last drain: ``{label: (ms, calls)}``."""
        with self._timings_lock:
            out, self._timings = self._timings, {}
        return out

    def drain_stage_timings(self) -> dict:
        """Pipeline-stage wall time since the last drain."""
        with self._timings_lock:
            out, self._stages = self._stages, {}
        return out

    def drain_setup_timings(self) -> dict:
        """One-time setup cost to fold into the engine's warm ledger."""
        return {}

    def close(self) -> None:
        """Release executors the plan owns (the sharded plans' thread
        pools); implementations drain in-flight work first."""


_REGISTRY: dict = {}


def register_plan(cls):
    """Class decorator: make ``cls`` constructible via :func:`create_plan`."""
    if not (isinstance(cls, type) and issubclass(cls, ExecutionPlan)):
        raise TypeError(f"register_plan expects an ExecutionPlan subclass, got {cls!r}")
    _REGISTRY[cls.name] = cls
    return cls


def available_plans() -> list:
    return sorted(_REGISTRY)


def plan_class(name: str):
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown plan {name!r}; available: {available_plans()}"
        ) from None


def select_plan(plan: Optional[str], *, mode: str, backend, shards=None,
                model=None) -> str:
    """Capability-driven auto-selection (``plan in (None, "auto")``).

    A sequence of backend names means heterogeneous tree-parallel.  One
    shard (or none requested) is the single plan.  Several shards pick
    tree-parallel when the mode accumulates exact integer partials and the
    forest has trees to carve; otherwise row-parallel, which is bit-exact
    for any mode because rows are independent.
    """
    if plan not in (None, "auto"):
        plan_class(plan)  # fail fast on unknown names
        return plan
    if not isinstance(backend, str) and isinstance(backend, (list, tuple)):
        return "tree_parallel"
    if shards is None or int(shards) <= 1:
        return "single"
    n_trees = getattr(model, "n_trees", None)
    if mode_spec(mode).deterministic and (n_trees is None or n_trees >= 2):
        return "tree_parallel"
    return "row_parallel"


def create_plan(name: Optional[str], model, *, mode: str = "integer",
                backend="reference", shards=None, layout: Optional[str] = None,
                backend_kwargs: Optional[dict] = None, device=None,
                **plan_kwargs) -> ExecutionPlan:
    """Instantiate a plan by name (``None``/"auto" -> :func:`select_plan`)."""
    resolved = select_plan(name, mode=mode, backend=backend, shards=shards,
                           model=model)
    return plan_class(resolved)(
        model, mode=mode, backend=backend, shards=shards, layout=layout,
        backend_kwargs=backend_kwargs, device=device, **plan_kwargs
    )
