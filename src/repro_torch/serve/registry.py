"""Multi-model registry: versioned packed ensembles behind stable model ids.

Models enter through any boundary the repo supports:
  * a trained forest object (``register_forest``): a random forest, or a
    booster (``GradientBoostedClassifier`` or its duck type), which serves
    int32 margins on the routes that take a margin model
    (``ir.forest_ir.refuse_margins``),
  * the Treelite-style JSON artifact (``register_json``), i.e. the
    ``trees/io`` exchange format — the path externally-trained models take,
  * an already-quantized artifact (``register_packed``), or
  * the ITRF binary artifact (``register_artifact``) — the deployment
    boundary: the file is mmap-ed read-only and the version serves views
    over the shared pages (every layout copies what it reads into tables
    of its own, so nothing writes through the mapping).  Re-registering the
    same unchanged file reuses the already-parsed IR *object*, layouts and
    all.  The measured load wall-ms rides the compile/warm ledger as the
    ``"load"`` bucket of the version's first engine.  ``export_tuned``
    writes the version's autotune winners back into the file's ``tune_db``.

Each ``register_*`` call creates a new immutable :class:`ModelVersion` and
atomically repoints the model id at it (hot-swap).  In-flight batches formed
against the previous version keep their reference and finish on it; new
requests route to the new version.  Engines are built lazily per (version,
mode, backend, layout, plan, autotune, device) and memoized, so a registry
fronts every route — the torch reference walk or the CUDA kernels, over any
layout the backend walks — with one set of device tables per version and
route.  The version's artifact carries the canonical IR, so every layout
materializes from one quantization.

Retention: the registry keeps the newest ``retain`` versions per model id
(default 2: current + previous, so in-flight batches on the just-swapped-out
version still finish) and releases anything older —
:meth:`ModelVersion.release` closes and drops every engine, and with them
the tables they hold on the card.  ``release(model_id, version)`` frees a
retained non-current version explicitly.
"""
from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass, field

from repro_torch.core.packing import PackedEnsemble, pack_forest
from repro_torch.serve.engine import TreeEngine
from repro_torch.trees.io import forest_from_json


def _freeze(obj):
    """Nested dict/list -> hashable tuples (the plan_kwargs memo-key leg)."""
    if isinstance(obj, dict):
        return tuple(sorted(((k, _freeze(v)) for k, v in obj.items()),
                            key=lambda kv: kv[0]))
    if isinstance(obj, (list, tuple)):
        return tuple(_freeze(v) for v in obj)
    return obj


@dataclass
class ModelVersion:
    model_id: str
    version: int
    packed: PackedEnsemble  # or a ForestIR (register_artifact)
    source: str  # "forest" | "json" | "packed" | "artifact"
    _engines: dict = field(default_factory=dict, repr=False)
    # register_artifact's measured load wall-ms, charged once to the first
    # engine's compile ledger under the "load" bucket
    _load_ms: float = field(default=None, repr=False)
    released: bool = field(default=False, repr=False)
    # wall-ms spent constructing each route's engine (tables copied to the
    # device) — the cold-start cost ``describe()`` surfaces per model
    _build_ms: dict = field(default_factory=dict, repr=False)
    # measured autotune winners per route — written by TreeEngine warm-time
    # tuning, copied forward across hot-swaps by the registry so a
    # swapped-in version reuses the measurement
    _tuned: dict = field(default_factory=dict, repr=False)
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    def engine(self, spec=None, *, device=None,
               plan_kwargs: dict = None) -> TreeEngine:
        """The memoized TreeEngine for one route on ``device`` (``cuda``
        unless ``device="cpu"`` is passed).

        The route is an :class:`~repro_torch.serve.spec.EngineSpec` (object,
        dict, or spec string) — ``engine("integer:cuda?impl=onehot")``.
        A layout of ``None`` resolves to the backend's ``preferred_layout``
        (and memoizes under the resolved name, so a later explicit request
        for that layout reuses the same engine).  The route's
        ``backend_kwargs`` are part of the memo key, so routes that differ
        only in a kernel knob (``impl=onehot``) get engines of their own.
        ``autotune`` arms warm-time measured tuning (memoized separately, so
        tuned and untuned routes never alias); winners land in this
        version's ``_tuned`` cache and survive hot-swaps.  A sequence of
        backend names (heterogeneous tree-parallel, ``cuda|bitvector``)
        memoizes under the tuple, each shard on its backend's preferred
        layout unless the spec pins one.  ``plan_kwargs`` carries plan knobs
        (``device_parallel``, ``clamp_shards``, the remote plan's
        ``workers``) and is part of the memo key; the remote plan also
        receives this version's identity, which its handshake carries.
        """
        from repro_torch.backends import backend_class
        from repro_torch.device import resolve_device
        from repro_torch.plan import select_plan
        from repro_torch.serve.spec import EngineSpec

        spec = EngineSpec.coerce(spec, caller="ModelVersion.engine")
        dev = resolve_device(device)
        if isinstance(spec.backend, str):
            resolved = spec.layout or \
                backend_class(spec.backend).capabilities.preferred_layout
        else:  # heterogeneous shard spec: memoize under the name tuple
            resolved = spec.layout
        # memoize under the *resolved* plan so plan=None / "auto" / "single"
        # share one engine instead of building the same route per alias
        resolved_plan = select_plan(spec.plan, mode=spec.mode,
                                    backend=spec.backend, shards=spec.shards,
                                    model=self.packed)
        key = (spec.mode, spec.backend, resolved, resolved_plan,
               None if resolved_plan == "single" else spec.shards,
               bool(spec.autotune), tuple(sorted((spec.backend_kwargs or {}).items())),
               str(dev), _freeze(plan_kwargs))
        with self._lock:
            if self.released:
                raise RuntimeError(
                    f"model {self.model_id!r} v{self.version} was released; "
                    f"route new requests through the registry's current "
                    f"version"
                )
            if key not in self._engines:
                t0 = time.perf_counter()
                pk = dict(plan_kwargs or {})
                if resolved_plan == "remote_tree_parallel":
                    pk.setdefault("model_id", self.model_id)
                    pk.setdefault("version", self.version)
                eng = TreeEngine(
                    self.packed, spec.replace(layout=resolved),
                    plan_kwargs=pk or None, tuned_store=self._tuned, device=dev,
                )
                if self._load_ms is not None:
                    # the artifact's load cost surfaces once, in the ledger
                    # the build, tune and remote costs ride
                    eng._compile_ms["load"] = self._load_ms
                    self._load_ms = None
                self._engines[key] = eng
                backend = spec.backend if isinstance(spec.backend, str) \
                    else "|".join(spec.backend)
                route = "/".join(str(p) for p in (spec.mode, backend, resolved,
                                                  resolved_plan, dev))
                self._build_ms[route] = (time.perf_counter() - t0) * 1e3
            return self._engines[key]

    def release(self) -> None:
        """Close and drop every engine this version built (their device
        tables become collectable).  Idempotent; an engine handle obtained
        before the release stops serving."""
        with self._lock:
            engines = list(self._engines.values())
            self._engines.clear()
            self.released = True
        for eng in engines:
            eng.close()


class ModelRegistry:
    def __init__(self, *, retain: int = 2):
        if retain < 1:
            raise ValueError("retain must keep at least the current version")
        self.retain = retain
        self._models: dict[str, ModelVersion] = {}
        self._history: dict[str, int] = {}  # model_id -> latest version number
        # model_id -> {version: ModelVersion} for the retained window
        self._versions: dict[str, dict[int, ModelVersion]] = {}
        # (realpath, mtime_ns, size) -> ForestIR: hot-swapping back to an
        # already-mapped, unchanged artifact file reuses the parsed IR and
        # its materialized layouts
        self._artifact_cache: dict = {}
        self._lock = threading.Lock()

    # ---------------------------------------------------------- registration
    def _install(self, model_id: str, packed, source: str) -> ModelVersion:
        with self._lock:
            version = self._history.get(model_id, 0) + 1
            mv = ModelVersion(model_id=model_id, version=version, packed=packed,
                              source=source)
            prev = self._models.get(model_id)
            if prev is not None:
                # carry measured autotune winners across the hot-swap: the
                # card didn't change, so the new version serves on the tuned
                # config immediately instead of re-measuring during warm
                mv._tuned.update(prev._tuned)
            self._history[model_id] = version
            self._models[model_id] = mv  # atomic repoint = hot-swap
            window = self._versions.setdefault(model_id, {})
            window[version] = mv
            evict = sorted(window)[:-self.retain]
            evicted = [window.pop(v) for v in evict]
        for old in evicted:  # outside the lock: close() may drain executors
            old.release()
        return mv

    def register_packed(self, model_id: str, packed: PackedEnsemble) -> ModelVersion:
        return self._install(model_id, packed, "packed")

    def register_forest(self, model_id: str, forest) -> ModelVersion:
        return self._install(model_id, pack_forest(forest), "forest")

    def register_json(self, model_id: str, payload: str) -> ModelVersion:
        """Load from the trees/io JSON artifact boundary."""
        return self._install(model_id, pack_forest(forest_from_json(payload)), "json")

    def register_artifact(self, model_id: str, path, *,
                          mmap: bool = True) -> ModelVersion:
        """Load an ITRF binary artifact — no JSON parse, no re-quantization.

        With ``mmap=True`` the version's ForestIR is read-only views over
        the file mapping, and every process registering the same file shares
        one page cache.  The measured load wall-ms lands in the first
        engine's compile ledger under ``"load"``.  Autotune winners the
        artifact carries for a device of this host (see
        :func:`repro_torch.ir.artifact.tune_host_key`) seed the version's
        ``_tuned`` cache; every other entry is ignored.
        """
        from repro_torch.ir.artifact import deserialize_tuned, read_itrf

        t0 = time.perf_counter()
        cache_key = ir = None
        if mmap:
            try:
                st = os.stat(path)
                cache_key = (os.path.realpath(path), st.st_mtime_ns, st.st_size)
            except OSError:
                cache_key = None
            with self._lock:
                ir = self._artifact_cache.get(cache_key)
        if ir is None:
            ir = read_itrf(path, mmap_arrays=mmap)
            if cache_key is not None:
                with self._lock:
                    self._artifact_cache[cache_key] = ir
        load_ms = (time.perf_counter() - t0) * 1e3
        mv = self._install(model_id, ir, "artifact")
        mv._load_ms = load_ms
        for route, kwargs in deserialize_tuned(ir.itrf_tuned).items():
            # live measurements carried across the swap still win
            mv._tuned.setdefault(route, kwargs)
        return mv

    def export_tuned(self, model_id: str, path) -> None:
        """Persist the current version's measured autotune winners into an
        existing ITRF file's ``tune_db`` section, each under its device's
        host key, so the next process to ``register_artifact`` it on the
        same card starts tuned."""
        from repro_torch.ir.artifact import update_tuned

        mv = self.get(model_id)
        with mv._lock:
            tuned = dict(mv._tuned)
        if tuned:
            update_tuned(path, tuned)

    def release(self, model_id: str, version: int) -> None:
        """Free a retained, non-current version explicitly (its engines
        close; their device tables become collectable)."""
        with self._lock:
            if self._models.get(model_id) is not None \
                    and self._models[model_id].version == version:
                raise ValueError(
                    f"version {version} is the current version of "
                    f"{model_id!r}; register a replacement before releasing"
                )
            mv = self._versions.get(model_id, {}).pop(version, None)
        if mv is None:
            raise KeyError(f"no retained version {version} for {model_id!r}")
        mv.release()

    # ---------------------------------------------------------------- lookup
    def get(self, model_id: str) -> ModelVersion:
        try:
            return self._models[model_id]
        except KeyError:
            raise KeyError(f"unknown model id {model_id!r}; have {sorted(self._models)}")

    def version(self, model_id: str) -> int:
        return self.get(model_id).version

    def ids(self) -> list:
        return sorted(self._models)

    def describe(self) -> dict:
        from repro_torch.ir import ForestIR
        from repro_torch.ir.forest_ir import margin_ir

        out = {}
        for mid, mv in sorted(self._models.items()):
            d = {
                "version": mv.version,
                "source": mv.source,
                "kind": "averaged" if margin_ir(mv.packed) is None else "margin",
                "n_trees": mv.packed.n_trees,
                "n_classes": mv.packed.n_classes,
                "n_features": mv.packed.n_features,
                "artifact_kb": mv.packed.nbytes_integer() / 1e3,
            }
            # bytes per layout, for the layouts serving routes have actually
            # materialized (reporting must not force builds of the others)
            ir = mv.packed if isinstance(mv.packed, ForestIR) \
                else getattr(mv.packed, "ir", None)
            if ir is not None:
                d["layout_kb"] = {
                    name: ir.materialize(name).nbytes_integer() / 1e3
                    for name in ir.materialized_layouts()
                }
            if mv._build_ms:
                d["engine_builds"] = dict(sorted(mv._build_ms.items()))
            out[mid] = d
        return out
