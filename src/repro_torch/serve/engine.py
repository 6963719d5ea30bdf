"""The serving engines.

``LMEngine``: batched prefill + greedy/temperature decode for the LM archs
on one device, the caches kept on that device.

``TreeEngine``: the serving path's shape-bucketing wrapper over one plan.

    engine -> ExecutionPlan -> backend.predict_partials -> merge -> finalize

For plans that work per shape, incoming batches are padded up to a small set
of power-of-two row buckets (capped at ``max_bucket``, which defaults to the
backend's ``preferred_block_rows``).  Tree traversal is row-independent, so
padding rows never perturb real rows.  Bucketing also decides the cuda
backend's walk: a 37-row request pads to 64 rows and takes K1, a 20-row one
pads to 32 and takes K2.
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np

from repro_torch.obs import stage


class LMEngine:
    """Batched prefill + greedy or sampled decode for one LM configuration.

    ``params`` are float32 parameters (``models.transformer.init_params``
    or ``params_from_numpy``).  The engine keeps them on ``device`` (``cuda``
    unless the caller passes another; without a card it raises) with every
    matmul weight cast to bf16 once, which gives the bits the reference gets
    by casting at each use and reads half the bytes per decode step.  On the
    card TF32 stays off (``models.layers.no_tf32``).
    """

    def __init__(self, cfg, params, *, max_seq: int = 1024, device=None):
        from repro_torch.device import resolve_device
        from repro_torch.models import transformer as tfm
        from repro_torch.models.layers import no_tf32

        self.cfg = cfg
        self.max_seq = max_seq
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            no_tf32()
        self.params = tfm.cast_matmul_weights(
            tfm.tree_map(lambda a: a.to(self.device), params))

    def prefill(self, batch: dict):
        """(last-token logits (B, V) float32, cache) for a batch of numpy
        arrays or tensors."""
        import torch

        from repro_torch.models import transformer as tfm

        batch = {k: torch.as_tensor(v).to(self.device) for k, v in batch.items()}
        with torch.inference_mode():
            return tfm.prefill(self.cfg, self.params, batch, max_seq=self.max_seq)

    def decode(self, cache, tokens):
        """One step: tokens (B, 1) -> (logits (B, V), cache advanced in place)."""
        import torch

        from repro_torch.models import transformer as tfm

        with torch.inference_mode():
            return tfm.decode_step(self.cfg, self.params, cache, tokens)

    def generate(self, batch: dict, n_tokens: int, *, temperature: float = 0.0,
                 seed: int = 0):
        """Greedy (T=0) or sampled decode.  Returns (B, n_tokens) int32 on
        the engine's device.  Sampling draws from a ``torch.Generator`` on
        the device seeded with ``seed``: the same seed gives the same tokens
        here, not the reference's (its stream is JAX's)."""
        import torch

        logits, cache = self.prefill(batch)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        toks = []
        b = logits.shape[0]
        for _ in range(n_tokens):
            if temperature > 0:
                probs = torch.softmax(logits / temperature, dim=-1)
                nxt = torch.multinomial(probs, 1, generator=gen)
            else:
                nxt = torch.argmax(logits, dim=-1)
            nxt = nxt.to(torch.int32).reshape(b, 1)
            toks.append(nxt)
            logits, cache = self.decode(cache, nxt)
        return torch.cat(toks, dim=1)


def bucket_rows(b: int, *, max_bucket: int = 4096) -> int:
    """Padded row count for a batch of ``b`` rows: the next power of two,
    capped at ``max_bucket``; beyond the cap, the next ``max_bucket``
    multiple."""
    if b <= 0:
        raise ValueError("batch must have at least one row")
    if b >= max_bucket:
        return -(-b // max_bucket) * max_bucket
    return 1 << (b - 1).bit_length()


class TreeEngine:
    """Shape-bucketing wrapper over one :class:`~repro_torch.plan.ExecutionPlan`.

    ``packed`` is a :class:`~repro_torch.ir.ForestIR` or any materialized
    layout artifact.  The route is one :class:`~repro_torch.serve.spec.
    EngineSpec`, passed as ``spec`` (an EngineSpec, a dict, or a string like
    ``"integer:cuda@leaf_major"``); the loose keyword arguments survive as
    the reference's deprecation shim.  ``device`` places the backend's
    tables and work: ``cuda`` unless ``device="cpu"`` is passed.
    ``predict``/``predict_scores`` take numpy (B, F) float32 rows of any
    count and return numpy results: uint32 scores for an averaged forest,
    and for a margin model (a booster's IR, ``integer`` mode only) its (B, C)
    int32 margins with the base added; ``predict_partials`` returns the
    merged uint32 partials either way.

    ``autotune=True`` (or ``?autotune=true`` in the spec) measures the cuda
    backend's CTA shape, or a host-C backend's ``block_rows`` or
    ``interleave``, during :meth:`warm` and rebuilds the plan on the
    measured winner (:mod:`repro_torch.serve.autotune`); single-plan
    string-backend routes only, and knobs the caller already pinned via
    ``backend_kwargs`` are never overridden.  ``tuned_store`` (a mutable
    dict, normally the owning ``ModelVersion``'s) caches winners per route
    so a hot-swapped version or a rebuilt engine skips re-measuring.
    """

    def __init__(self, packed=None, spec=None, *, mode: Optional[str] = None,
                 backend=None, backend_kwargs: Optional[dict] = None,
                 max_bucket: Optional[int] = None, layout: Optional[str] = None,
                 plan: Optional[str] = None, shards: Optional[int] = None,
                 plan_kwargs: Optional[dict] = None, autotune=None,
                 tuned_store: Optional[dict] = None, device=None):
        from repro_torch.device import resolve_device
        from repro_torch.plan import create_plan, select_plan
        from repro_torch.serve.autotune import TUNABLE_BACKENDS, autotune_enabled, \
            config_str
        from repro_torch.serve.spec import EngineSpec

        spec = EngineSpec.coerce(spec, caller="TreeEngine", mode=mode,
                                 backend=backend, layout=layout, plan=plan,
                                 shards=shards, backend_kwargs=backend_kwargs,
                                 autotune=autotune)
        self.spec = spec
        backend_kwargs = dict(spec.backend_kwargs) if spec.backend_kwargs else None
        self._ctor = dict(packed=packed, mode=spec.mode, backend=spec.backend,
                          backend_kwargs=backend_kwargs, layout=spec.layout,
                          plan=spec.plan, shards=spec.shards,
                          plan_kwargs=plan_kwargs, device=resolve_device(device))
        self._tuned_store = tuned_store if tuned_store is not None else {}
        self._tuned_config: Optional[str] = None
        self._pending_tune = False
        if autotune_enabled(spec.autotune) and isinstance(spec.backend, str) \
                and spec.backend in TUNABLE_BACKENDS \
                and select_plan(spec.plan, mode=spec.mode, backend=spec.backend,
                                shards=spec.shards, model=packed) == "single":
            winner = self._tuned_store.get(self._tune_key())
            if winner is not None:
                # a cached measurement (hot-swap, rebuilt engine): apply it
                # now — caller-pinned kwargs still win on key collisions
                backend_kwargs = {**winner, **(backend_kwargs or {})}
                self._tuned_config = config_str(winner)
            else:
                self._pending_tune = True
        self.plan = create_plan(
            spec.plan, packed, mode=spec.mode, backend=spec.backend,
            shards=spec.shards, layout=spec.layout, backend_kwargs=backend_kwargs,
            device=self._ctor["device"], **(plan_kwargs or {})
        )
        self.packed = self.plan.packed
        self.mode = self.plan.mode
        self.max_bucket = max_bucket or self.plan.preferred_block_rows or 4096
        self.compiled_buckets: set[int] = set()
        # first-execution wall ms per bucket, the autotuner's "tune" and the
        # registry's artifact-load ms under "load", drained into metrics
        self._compile_ms: dict = {}
        self.closed = False

    def _tune_key(self):
        # the route's own kwargs (``impl``) pick the kernel being tuned, so
        # routes that differ only in them measure and cache independently;
        # the device is the one the backend runs on, which for the host-C
        # backends is the CPU whatever the engine's device
        from repro_torch.backends import backend_class

        c = self._ctor
        return (c["backend"], c["layout"], c["mode"],
                tuple(sorted((c["backend_kwargs"] or {}).items())),
                str(backend_class(c["backend"]).placement(c["device"])))

    @property
    def tuned_config(self) -> Optional[str]:
        """The autotuned backend config serving this engine (e.g.
        ``"block_b=128,block_t=2"``), or ``None`` when untuned (autotune
        off, tuning still pending, or a knob the caller pinned)."""
        return self._tuned_config

    def _run_autotune(self, max_rows: int) -> None:
        """Measure the backend's candidate grid and rebuild the plan on the
        winner (see :mod:`repro_torch.serve.autotune`).  Runs at most once,
        at the start of the first :meth:`warm`; the measuring wall-ms lands
        in the compile ledger under ``"tune"`` and the winner in
        ``tuned_store``."""
        from repro_torch.plan import create_plan
        from repro_torch.serve import autotune as at

        self._pending_tune = False
        c = self._ctor
        user_kw = c["backend_kwargs"] or {}
        backend = self.backend
        grid = at.candidate_grid(self.backend_name, backend.packed,
                                 device=backend.device)
        if not grid or set(grid[0]) & set(user_kw):
            return  # nothing to sweep, or the caller pinned the knob
        t0 = time.perf_counter()
        winner, winner_backend, _ = at.tune_backend(
            self.backend_name, backend.packed, self.mode,
            rows=min(max(max_rows, 1), at._TUNE_ROWS), baseline=backend,
            backend_kwargs=user_kw, device=backend.device,
        )
        self._compile_ms["tune"] = (time.perf_counter() - t0) * 1e3
        if winner is None:
            return
        self._tuned_store[self._tune_key()] = winner
        self._tuned_config = at.config_str(winner)
        if winner_backend is not backend:
            # serve on the measured winner: rebuild the plan around the
            # already-built winning backend
            self.plan = create_plan(
                c["plan"], c["packed"], mode=c["mode"], backend=winner_backend,
                shards=c["shards"], layout=c["layout"], **(c["plan_kwargs"] or {})
            )
            self.compiled_buckets.clear()

    @property
    def backend(self):
        """The (first) shard backend."""
        backends = self.plan.backends
        return backends[0] if backends else None

    @property
    def backend_name(self) -> str:
        return self.plan.backend_name

    @property
    def plan_name(self) -> str:
        return self.plan.name

    @property
    def n_shards(self) -> int:
        return self.plan.n_shards

    @property
    def layout(self) -> str:
        """The ForestIR layout(s) the plan's backends are walking."""
        return self.plan.layout

    @property
    def deterministic(self) -> bool:
        """True when outputs are bit-exact integer scores."""
        return self.plan.deterministic

    def describe(self) -> dict:
        """The plan's description (plan, mode, shards, backends, layout) and
        the model's: ``kind`` (``averaged`` or ``margin``), ``n_trees``,
        ``n_classes``, and for a margin model ``trees_per_class`` and
        ``margin_scale``."""
        from repro_torch.ir.forest_ir import AVERAGED, margin_ir

        d = self.plan.describe()
        ir = margin_ir(self.packed)
        d.update(kind=AVERAGED if ir is None else ir.kind, n_trees=self.packed.n_trees,
                 n_classes=self.packed.n_classes)
        if ir is not None:
            d.update(trees_per_class=ir.trees_per_class(), margin_scale=int(ir.scale))
        return d

    def simd_isa(self):
        """The SIMD ISA the serving backend (the first shard's) dispatches
        to: ``"avx2"`` / ``"neon"`` / ``"scalar"`` / ``"avx512-k8"``-style
        names for the host-C backends, ``None`` for backends without the
        surface (the card's, the reference walk, remote shards).  A mixed
        plan reports its first shard's, as the JAX engine does, so
        ``native_c_table|cuda`` has an ISA and ``cuda|native_c_table`` has
        none.  May trigger the backend's first build — callers wanting a free
        probe should ask after serving has started."""
        fn = getattr(self.backend, "simd_isa", None)
        return fn() if fn is not None else None

    def drain_shard_timings(self) -> dict:
        """Per-shard wall time since the last drain (``{label: (ms, calls)}``)."""
        return self.plan.drain_timings()

    def drain_stage_timings(self) -> dict:
        """Pipeline-stage wall time since the last drain (pad, finalize)."""
        return self.plan.drain_stage_timings()

    def drain_compile_timings(self) -> dict:
        """First-execution wall ms per bucket since the last drain (the
        kernels' build lands in the first bucket's entry), with the one-time
        costs: ``"tune"``, ``"load"`` (an ITRF artifact's registration) and
        the plan's setup (``"remote"``: workers' connect and handshake)."""
        out, self._compile_ms = self._compile_ms, {}
        out.update(self.plan.drain_setup_timings())
        return out

    def close(self) -> None:
        """Release executors the plan owns and mark the engine closed."""
        self.closed = True
        self.plan.close()

    def attach_trace(self, tracer, parent) -> None:
        """Attach a tracer and the span that parents this thread's spans."""
        self.plan.attach_tracer(tracer)
        self.plan.trace_parent = parent

    def detach_trace(self) -> None:
        self.plan.trace_parent = None

    def warm(self, max_rows: int) -> None:
        """Run every bucket any batch of 1..``max_rows`` rows can map to: the
        power-of-two buckets below ``max_bucket`` and the ``max_bucket``
        multiples at or above it.  Warming goes through the plan, so every
        shard of a sharded plan sees the shapes real predicts hand it (row
        chunks for row-parallel, whole buckets per tree shard), and every
        shard's kernels are built before the first request.  When
        autotuning is armed, the candidate sweep runs first, and the buckets
        warm whatever won."""
        if self._pending_tune:
            self._run_autotune(max_rows)
        zeros = lambda nb: np.zeros((nb, self.packed.n_features), np.float32)
        if not self.plan.compiles_per_shape:
            self.predict(zeros(1))
            return
        top = bucket_rows(max_rows, max_bucket=self.max_bucket)
        nb = 1
        while nb <= top and nb < self.max_bucket:
            self.predict(zeros(nb))
            nb *= 2
        if top >= self.max_bucket:
            for m in range(self.max_bucket, top + 1, self.max_bucket):
                self.predict(zeros(m))

    def padded_rows(self, b: int) -> int:
        """Rows actually executed for a ``b``-row batch."""
        if not self.plan.compiles_per_shape:
            return b
        return bucket_rows(b, max_bucket=self.max_bucket)

    def _pad(self, X):
        X = np.asarray(X, np.float32)
        if X.ndim != 2:
            raise ValueError(f"expected (B, F) features, got shape {X.shape}")
        b = X.shape[0]
        nb = self.padded_rows(b)
        if nb != b:
            X = np.concatenate([X, np.zeros((nb - b, X.shape[1]), np.float32)])
        return X, b, nb

    def _pad_traced(self, X):
        plan = self.plan
        with stage("engine.pad", plan._record_stage, "pad", plan._tracer,
                   plan.trace_parent) as st:
            X, b, nb = self._pad(X)
            st.attrs = {"rows": b, "padded": nb}
        return X, b, nb

    def _execute(self, fn, X):
        X, b, nb = self._pad_traced(X)
        cold = self.plan.compiles_per_shape and nb not in self.compiled_buckets
        t0 = time.perf_counter()
        out = fn(X)
        if self.plan.compiles_per_shape:
            # only a predict that returned has run its bucket
            self.compiled_buckets.add(nb)
            if cold:
                self._compile_ms[nb] = (time.perf_counter() - t0) * 1e3
        return out, b

    def predict_scores(self, X):
        (scores, preds), b = self._execute(self.plan.predict_scores, X)
        return np.asarray(scores)[:b], np.asarray(preds)[:b]

    def predict(self, X) -> np.ndarray:
        return self.predict_scores(X)[1]

    def predict_partials(self, X):
        """Merged (B, C) uint32 partials through the bucketed path."""
        acc, b = self._execute(self.plan.predict_partials, X)
        return np.asarray(acc)[:b]
