"""SingleShardPlan: the whole forest on one backend.

Deterministic modes go through the base partials + finalize split; float
mode and backends without partials keep the backend's fused predict.
"""
from __future__ import annotations

from repro_torch.plan.base import ExecutionPlan, build_backend, register_plan


@register_plan
class SingleShardPlan(ExecutionPlan):
    name = "single"

    def __init__(self, model, *, mode: str = "integer", backend="reference",
                 shards=None, layout=None, backend_kwargs=None, device=None):
        if shards not in (None, 1):
            raise ValueError(
                f"the single plan runs exactly one shard, got shards={shards}; "
                "use plan='tree_parallel' or 'row_parallel' to shard"
            )
        self.backend = build_backend(backend, model, mode, layout,
                                     backend_kwargs, device)
        # an already-constructed backend instance carries its own mode/model
        super().__init__(self.backend.packed, mode=self.backend.mode)
        self._label = f"s0:{self.backend.name}"
        from repro_torch.backends.base import TreeBackend

        impl = getattr(type(self.backend), "predict_partials", None)
        self._has_partials = (impl is not None
                              and impl is not TreeBackend.predict_partials)

    @property
    def backends(self) -> tuple:
        return (self.backend,)

    @property
    def packed(self):
        return self.backend.packed

    def predict_partials(self, X):
        return self._timed(self._label, self.backend.predict_partials, X,
                           span_parent=self.trace_parent)

    def predict_scores(self, X):
        if self.deterministic and self._has_partials:
            return super().predict_scores(X)
        return self._timed(self._label, self.backend.predict_scores, X,
                           span_parent=self.trace_parent)
