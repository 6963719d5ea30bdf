"""`EngineSpec` — the one serializable description of an engine route.

String grammar (every part optional)::

    [mode:]backend[|backend2...][@layout][+plan[:shards]][?key=val,...]

    integer:cuda@leaf_major
    flint:reference
    integer                      (bare mode; backend defaults to reference)

``+auto:N`` pins a shard count while leaving plan selection to
``select_plan``.  The reserved query key ``autotune=1`` arms the autotuner;
every other query key lands in ``backend_kwargs`` with int/float/bool
literals parsed.  Pure Python: names are checked against the port's own
registries, and only by :meth:`EngineSpec.validate`.
"""
from __future__ import annotations

import dataclasses
import warnings
from dataclasses import dataclass, field
from typing import Any, Mapping, Optional, Tuple, Union

__all__ = ["EngineSpec", "MODES"]

#: Deterministic + float execution modes (kept in sync with
#: repro_torch.core.ensemble.MODES; duplicated so parsing a spec never has
#: to import torch).
MODES = ("float", "flint", "integer")

_LOOSE_KEYS = ("mode", "backend", "layout", "plan", "shards",
               "backend_kwargs", "autotune")
_warned_callers: set = set()


def _parse_literal(text: str):
    """Query-string value -> int / float / bool / str."""
    low = text.lower()
    if low in ("true", "false"):
        return low == "true"
    try:
        return int(text)
    except ValueError:
        pass
    try:
        return float(text)
    except ValueError:
        return text


def _fmt_literal(v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    return str(v)


@dataclass(frozen=True)
class EngineSpec:
    """A complete, serializable engine route.

    ``backend`` is a registered backend name, a tuple of names (one per
    shard, cycled — a heterogeneous pool), or at runtime a live backend
    *instance* (which then cannot be serialized).  ``plan=None`` /
    ``layout=None`` mean "let ``select_plan`` / backend capabilities
    decide".
    """

    mode: str = "integer"
    backend: Union[str, Tuple[str, ...], Any] = "reference"
    layout: Optional[str] = None
    plan: Optional[str] = None
    shards: Optional[int] = None
    backend_kwargs: Optional[dict] = None
    autotune: bool = False

    def __post_init__(self):
        if isinstance(self.backend, list):
            object.__setattr__(self, "backend", tuple(self.backend))

    # -- construction ------------------------------------------------------

    @classmethod
    def parse(cls, text: str, *, validate: bool = True) -> "EngineSpec":
        """Parse the ``[mode:]backend[@layout][+plan[:shards]][?k=v]``
        grammar (see module docstring)."""
        s = str(text).strip()
        if not s:
            raise ValueError("empty engine spec")
        query = None
        if "?" in s:
            s, query = s.split("?", 1)
        plan_part = None
        if "+" in s:
            s, plan_part = s.split("+", 1)
        layout = None
        if "@" in s:
            s, layout = s.split("@", 1)
            if "@" in layout:
                raise ValueError(f"more than one @layout in spec {text!r}")
            layout = layout.strip() or None
        mode = "integer"
        s = s.strip()
        if ":" in s:
            mode, s = (p.strip() for p in s.split(":", 1))
        elif s in MODES:  # bare mode, default backend
            mode, s = s, ""
        backend: Union[str, Tuple[str, ...]] = s or "reference"
        if isinstance(backend, str) and "|" in backend:
            backend = tuple(b.strip() for b in backend.split("|") if b.strip())
        plan = shards = None
        if plan_part:
            plan = plan_part.strip()
            if ":" in plan:
                plan, shards_txt = plan.split(":", 1)
                try:
                    shards = int(shards_txt)
                except ValueError:
                    raise ValueError(
                        f"bad shard count {shards_txt!r} in spec {text!r}")
            if plan in ("", "auto"):
                plan = None  # shards pinned, plan auto-selected
        backend_kwargs: dict = {}
        autotune = False
        if query:
            for item in query.split(","):
                if not item:
                    continue
                k, sep, v = item.partition("=")
                if not sep:
                    raise ValueError(f"bad query item {item!r} in spec {text!r}")
                if k == "autotune":
                    autotune = bool(_parse_literal(v))
                else:
                    backend_kwargs[k] = _parse_literal(v)
        spec = cls(mode=mode, backend=backend, layout=layout, plan=plan,
                   shards=shards, backend_kwargs=backend_kwargs or None,
                   autotune=autotune)
        if validate:
            spec.validate()
        return spec

    @classmethod
    def from_dict(cls, d: Mapping) -> "EngineSpec":
        """Inverse of :meth:`to_dict` (extra keys rejected)."""
        extra = set(d) - set(_LOOSE_KEYS)
        if extra:
            raise ValueError(f"unknown EngineSpec keys {sorted(extra)}")
        kw = {k: d[k] for k in _LOOSE_KEYS if d.get(k) is not None}
        if isinstance(kw.get("backend"), list):
            kw["backend"] = tuple(kw["backend"])
        if "autotune" in kw:
            kw["autotune"] = bool(kw["autotune"])
        return cls(**kw)

    @classmethod
    def coerce(cls, spec=None, *, caller: str = "engine", **loose) -> "EngineSpec":
        """Accept an :class:`EngineSpec` | spec string | dict | ``None`` +
        loose kwargs, and return a spec.

        The loose-kwargs route (``backend=...`` etc. without a spec) is the
        pre-spec API; it still works but emits one ``DeprecationWarning``
        per call site.  Mixing a spec with loose kwargs is an error — there
        would be no unambiguous precedence.
        """
        loose = {k: v for k, v in loose.items()
                 if v is not None and not (k == "autotune" and v is False)}
        if spec is None:
            if loose and caller not in _warned_callers:
                _warned_callers.add(caller)
                warnings.warn(
                    f"{caller}: loose route kwargs "
                    f"({', '.join(sorted(loose))}) are deprecated; pass "
                    "spec=EngineSpec(...) or a spec string like "
                    "'integer:cuda@leaf_major'",
                    DeprecationWarning, stacklevel=3)
            return cls(**loose)
        if loose:
            raise ValueError(
                f"{caller}: pass the route either as a spec or as loose "
                f"kwargs, not both (got spec and {sorted(loose)})")
        if isinstance(spec, cls):
            return spec
        if isinstance(spec, str):
            return cls.parse(spec)
        if isinstance(spec, Mapping):
            return cls.from_dict(spec)
        raise TypeError(f"{caller}: cannot interpret {type(spec).__name__} "
                        "as an EngineSpec")

    # -- validation --------------------------------------------------------

    def validate(self) -> "EngineSpec":
        """Check mode/backend/layout/plan names against the live registries
        (imports them lazily — parsing alone never pulls in torch)."""
        if self.mode not in MODES:
            raise ValueError(f"unknown mode {self.mode!r}; have {MODES}")
        if self.shards is not None and self.shards < 1:
            raise ValueError(f"shards must be >= 1, got {self.shards}")
        names = ([self.backend] if isinstance(self.backend, str)
                 else list(self.backend) if isinstance(self.backend, tuple)
                 else [])  # live instances validate themselves at build
        if names:
            from repro_torch.backends import available_backends
            have = set(available_backends())
            for n in names:
                if n not in have:
                    raise ValueError(
                        f"unknown backend {n!r}; have {sorted(have)}")
        if self.layout is not None:
            from repro_torch.ir import available_layouts
            if self.layout not in available_layouts():
                raise ValueError(f"unknown layout {self.layout!r}; have "
                                 f"{sorted(available_layouts())}")
        if self.plan is not None:
            from repro_torch.plan import available_plans
            if self.plan not in available_plans():
                raise ValueError(f"unknown plan {self.plan!r}; have "
                                 f"{sorted(available_plans())}")
        return self

    # -- serialization -----------------------------------------------------

    def to_dict(self) -> dict:
        """JSON-safe dict (the handshake payload form).  Raises if the
        backend is a live instance rather than registered names."""
        b = self.backend
        if not isinstance(b, str):
            if not (isinstance(b, tuple) and all(isinstance(n, str) for n in b)):
                raise TypeError("EngineSpec with a live backend instance "
                                "cannot be serialized; use registered names")
            b = list(b)
        return {
            "mode": self.mode,
            "backend": b,
            "layout": self.layout,
            "plan": self.plan,
            "shards": self.shards,
            "backend_kwargs": dict(self.backend_kwargs) if self.backend_kwargs else None,
            "autotune": bool(self.autotune),
        }

    def canonical(self) -> str:
        """Render back to the compact grammar (parse/canonical round-trip
        is stable)."""
        b = self.backend
        btxt = b if isinstance(b, str) else (
            "|".join(b) if isinstance(b, tuple) else
            getattr(b, "name", type(b).__name__))
        out = f"{self.mode}:{btxt}"
        if self.layout:
            out += f"@{self.layout}"
        if self.plan:
            out += f"+{self.plan}"
            if self.shards:
                out += f":{self.shards}"
        elif self.shards:
            out += f"+auto:{self.shards}"
        q = dict(sorted((self.backend_kwargs or {}).items()))
        if self.autotune:
            q["autotune"] = True
        if q:
            out += "?" + ",".join(f"{k}={_fmt_literal(v)}" for k, v in q.items())
        return out

    def __str__(self) -> str:
        return self.canonical()

    def replace(self, **changes) -> "EngineSpec":
        return dataclasses.replace(self, **changes)
