"""The TreeBackend protocol and the name-keyed backend registry.

Every execution strategy for a materialized forest implements

    predict_partials(X) -> (B, C) uint32 partial accumulators (numpy)
    predict_scores(X)   -> (scores, preds)

and declares what it can do in :class:`BackendCapabilities`.  The serving
stack routes through this layer only.  Backends hold their tables as
tensors on one device, chosen at construction: ``cuda`` unless the caller
passes ``device="cpu"``.
"""
from __future__ import annotations

import abc
from dataclasses import dataclass
from typing import ClassVar, Optional

from repro_torch.device import resolve_device
from repro_torch.ir.forest_ir import margin_ir, refuse_margins


class BackendUnavailable(RuntimeError):
    """The backend cannot run on this host (e.g. its kernels do not build)."""


@dataclass(frozen=True)
class BackendCapabilities:
    """What a backend supports and how the serving layer should drive it.

    modes:               inference modes the backend implements.
    deterministic_modes: modes whose scores are bit-exact integers.
    preferred_block_rows: row-blocking hint; ``TreeEngine`` uses it as the
                         default ``max_bucket``.
    compiles_per_shape:  True when the engine should pad batches to row
                         buckets (a bounded set of shapes).
    supported_layouts:   ForestIR layouts this backend can walk.
    preferred_layout:    the layout materialized when the caller pins none.
    """

    modes: tuple
    deterministic_modes: tuple
    preferred_block_rows: Optional[int] = None
    compiles_per_shape: bool = True
    supported_layouts: tuple = ("padded",)
    preferred_layout: str = "padded"

    def require_layout(self, layout: str, backend_name: str) -> None:
        """Fail fast when ``layout`` is not walkable."""
        if layout not in self.supported_layouts:
            raise ValueError(
                f"backend {backend_name!r} cannot walk layout {layout!r}; "
                f"supported layouts: {self.supported_layouts}"
            )


class TreeBackend(abc.ABC):
    """One execution strategy for a materialized forest, fixed to one mode
    and one device."""

    name: ClassVar[str]
    capabilities: ClassVar[BackendCapabilities]
    #: True when the backend serves a margin model (boosted trees) in
    #: ``integer`` mode: its partials are the uint32 sums of any leaf bit
    #: patterns, so the signed margins come out exact
    margins: ClassVar[bool] = False

    def __init__(self, packed, mode: str = "integer", *, device=None):
        if mode not in self.capabilities.modes:
            raise ValueError(
                f"backend {self.name!r} does not implement mode {mode!r}; "
                f"supported modes: {self.capabilities.modes}"
            )
        self.capabilities.require_layout(getattr(packed, "layout", "padded"),
                                         self.name)
        if not self.margins:
            refuse_margins(packed, f"backend {self.name!r}")
        elif mode != "integer":
            refuse_margins(packed, f"mode {mode!r} on backend {self.name!r}")
        self.packed = packed
        self.mode = mode
        self.device = self.placement(device)

    @classmethod
    def placement(cls, device=None):
        """The device this backend's work runs on when a caller or plan
        passes ``device``: that device, ``cuda`` for ``None``."""
        return resolve_device(device)

    @property
    def layout(self) -> str:
        """The layout of the artifact this backend was built on."""
        return getattr(self.packed, "layout", "padded")

    @property
    def deterministic(self) -> bool:
        """True when outputs are bit-exact integer scores."""
        return self.mode in self.capabilities.deterministic_modes

    def predict_partials(self, X):
        """Float features (B, F) -> (B, C) uint32 partials (numpy)."""
        raise NotImplementedError(
            f"backend {self.name!r} does not expose integer partials for "
            f"mode {self.mode!r}"
        )

    def predict_scores(self, X):
        """Float features (B, F) -> (scores (B, C), preds (B,) int32); for
        deterministic modes ``finalize_partials(predict_partials(X))``, with
        a margin model's base added."""
        from repro_torch.core.ensemble import finalize_margins, finalize_partials

        if not self.deterministic:
            raise NotImplementedError(
                f"backend {self.name!r} must override predict_scores for "
                f"the non-deterministic mode {self.mode!r}"
            )
        acc = self.predict_partials(X)
        ir = margin_ir(self.packed)
        if ir is not None:
            return finalize_margins(acc, ir.base_fixed)
        return finalize_partials(self.mode, acc, self.packed.n_trees,
                                 self.packed.scale)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"<{type(self).__name__} mode={self.mode!r} device={self.device}>"


_REGISTRY: dict = {}


def register_backend(cls):
    """Class decorator: make ``cls`` constructible via :func:`create_backend`."""
    if not (isinstance(cls, type) and issubclass(cls, TreeBackend)):
        raise TypeError(f"register_backend expects a TreeBackend subclass, got {cls!r}")
    _REGISTRY[cls.name] = cls
    return cls


def available_backends() -> list:
    return sorted(_REGISTRY)


def backend_class(name: str):
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown backend {name!r}; available: {available_backends()}"
        ) from None


def create_backend(name: str, packed, *, mode: str = "integer", device=None,
                   **kwargs) -> TreeBackend:
    """Instantiate a registered backend by name for one (model, mode) on
    ``device`` (``cuda`` unless ``device="cpu"`` is passed)."""
    return backend_class(name)(packed, mode, device=device, **kwargs)
