"""Runnable serving driver: the PyTorch counterpart of ``repro.launch.serve``.

Three modes, matching the paper's end-to-end story adapted to a serving stack:
  * ``--trees``: train an RF on a synthetic Shuttle-like dataset, quantize it
    into the ForestIR, and serve batched predictions through the three modes
    (float / flint / integer), every execution backend (reference torch walk,
    the CUDA walk K1, if-else C, table-walk C) and multiple ForestIR layouts
    (padded / leaf_major / ragged), reporting agreement and latency — the
    InTreeger pipeline as a service.
  * ``--trees --gateway``: the async serving gateway end-to-end.  Trains
    several forests, registers them in a versioned ``ModelRegistry`` (one via
    the trees/io JSON artifact boundary), then replays a simulated-client
    workload — Poisson arrivals, mixed 1..16-row requests, a hot key pool so
    repeated FlInt-quantized keys exercise the response cache, and a mid-run
    hot-swap of one model to a new version.  Requests flow
    ``Gateway.submit → QuantizedKeyCache → MicroBatcher (coalesce to
    block-shaped batches under a latency deadline, with admission control)
    → ModelRegistry → TreeEngine (shape-bucketed, over the ``--gw-plan``
    execution plan and ``--gw-backend`` backend; ``--gw-shards`` carves the
    forest tree-parallel or the batch row-parallel with bit-identical
    outputs)``, and the run ends with a per-model metrics table (throughput,
    p50/p95/p99 latency, batch occupancy, cache hit rate, per-shard
    timings) plus a bit-identity check of gateway outputs against direct
    ``TreeEngine.predict_scores``.  Observability flags: ``--gw-trace``
    samples per-request span trees (``--gw-trace-sample`` sets the rate) and
    prints a flame-style stage summary; ``--gw-trace-out`` writes the spans
    as JSONL; ``--gw-metrics-out`` writes a Prometheus-text metrics snapshot
    (plus a ``.json`` sibling with the full stats dict).
  * LM mode (the default): load a config (``--smoke`` for the reduced one),
    draw its parameters from a seed on the device, and run batched
    prefill+decode generation; prints tok/s and the peak device memory.

The gateway route is one ``--gw-spec`` EngineSpec string (the per-field
``--gw-*`` flags stay as overrides), and ``--workers`` serves tree shards on
worker *processes* over the ITRG wire protocol — spawn N on loopback or
connect to a fleet started with ``--worker-listen HOST:PORT`` (or
``python -m repro_torch.serve.worker``).

Everything runs on ``--device`` (default ``cuda``; without a card it
raises); ``--device cpu`` runs the kernels' plain PyTorch versions.

  PYTHONPATH=src python -m repro_torch.launch.serve --trees --rows 20000
  PYTHONPATH=src python -m repro_torch.launch.serve --trees --gateway --gw-requests 400
  PYTHONPATH=src python -m repro_torch.launch.serve --trees --gateway \
      --gw-spec 'integer:bitvector@leaf_major+tree_parallel:4'
  PYTHONPATH=src python -m repro_torch.launch.serve --trees --gateway --workers 2
  PYTHONPATH=src python -m repro_torch.launch.serve --worker-listen 0.0.0.0:7071
  PYTHONPATH=src python -m repro_torch.launch.serve --trees --gateway \
      --gw-trace-out trace.jsonl --gw-metrics-out metrics.prom
  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-2b --smoke
  PYTHONPATH=src python -m repro_torch.launch.serve --trees --device cpu
"""
from __future__ import annotations

import argparse
import time

import numpy as np


def serve_trees(args):
    from repro_torch.backends import have_c_toolchain
    from repro_torch.core.packing import pack_forest
    from repro_torch.data.tabular import make_shuttle_like, train_test_split
    from repro_torch.serve.engine import TreeEngine
    from repro_torch.trees.forest import RandomForestClassifier

    X, y = make_shuttle_like(n=args.rows, seed=0)
    Xtr, ytr, Xte, yte = train_test_split(X, y)
    rf = RandomForestClassifier(
        n_estimators=args.n_trees, max_depth=args.depth, seed=0
    ).fit(Xtr, ytr)
    packed = pack_forest(rf)
    print(
        f"forest: {args.n_trees} trees depth<={args.depth}; packed "
        f"integer artifact {packed.nbytes_integer()/1e3:.1f} kB "
        f"(float: {packed.nbytes_float()/1e3:.1f} kB)"
    )
    dev = args.device
    engines = {m: TreeEngine(packed, m, device=dev) for m in ("float", "flint", "integer")}
    engines["integer-leafmajor"] = TreeEngine(packed, "integer:reference@leaf_major",
                                              device=dev)
    engines["integer-cuda"] = TreeEngine(packed, "integer:cuda", device=dev)
    if have_c_toolchain():
        engines["integer-native-c"] = TreeEngine(packed, "integer:native_c", device=dev)
        # the table-walk C backend resolves the ragged ForestIR layout
        # through packed.ir — same model, fourth execution strategy
        engines["integer-c-table"] = TreeEngine(packed, "integer:native_c_table",
                                                device=dev)
    else:
        print("gcc not found: skipping the native_c / native_c_table rows")
    ref = None
    for name, eng in engines.items():
        eng.predict(Xte[:128])  # warmup/compile
        t0 = time.time()
        for _ in range(args.reps):
            preds = eng.predict(Xte)
        dt = (time.time() - t0) / args.reps
        acc = (preds == yte).mean()
        agree = 1.0 if ref is None else (preds == ref).mean()
        ref = preds if ref is None else ref
        print(
            f"{name:16s} acc={acc:.4f} agree_with_float={agree:.6f} "
            f"{dt*1e6/len(Xte):8.3f} us/row"
        )


def build_gateway_models(registry, *, rows: int = 8000, seed: int = 0):
    """Train + register the demo model set; returns per-model row pools.

    ``esa-rf`` goes through the JSON artifact boundary on purpose — that is
    the registry's external-model load path and must stay exercised.
    """
    from repro_torch.data.tabular import make_esa_like, make_shuttle_like, train_test_split
    from repro_torch.trees.forest import RandomForestClassifier
    from repro_torch.trees.io import forest_to_json

    pools = {}
    Xs, ys = make_shuttle_like(n=rows, seed=seed)
    Xtr, ytr, Xte, _ = train_test_split(Xs, ys, seed=seed)
    registry.register_forest(
        "shuttle-rf", RandomForestClassifier(n_estimators=20, max_depth=6, seed=seed).fit(Xtr, ytr)
    )
    pools["shuttle-rf"] = Xte
    registry.register_forest(
        "shuttle-deep", RandomForestClassifier(n_estimators=40, max_depth=8, seed=seed + 1).fit(Xtr, ytr)
    )
    pools["shuttle-deep"] = Xte
    Xe, ye = make_esa_like(n=rows, seed=seed)
    Xetr, yetr, Xete, _ = train_test_split(Xe, ye, seed=seed)
    rf_esa = RandomForestClassifier(n_estimators=12, max_depth=6, seed=seed + 2).fit(Xetr, yetr)
    registry.register_json("esa-rf", forest_to_json(rf_esa))
    pools["esa-rf"] = Xete
    return pools, (Xtr, ytr)


async def run_gateway_workload(gateway, pools, *, n_requests: int, rate_hz: float,
                               hot_frac: float = 0.3, seed: int = 0,
                               hot_swap=None, row_choices=(1, 1, 1, 1, 2, 2, 4, 8, 16)):
    """Poisson-arrival simulated clients.  Returns (results, n_rejected).

    ``rate_hz=inf`` degenerates to a burst (all requests at t=0), which
    measures pure gateway capacity.  ``hot_swap``: optional
    ``(request_index, fn)`` — ``fn(gateway)`` runs mid-workload to
    re-register a model (version bump under live traffic).
    """
    import asyncio

    from repro_torch.serve.queue import AdmissionError

    rng = np.random.default_rng(seed)
    model_ids = list(pools)
    # a small hot pool per model -> repeated quantized keys -> cache hits
    hot = {m: pools[m][rng.integers(0, len(pools[m]), 24)] for m in model_ids}
    row_choices = np.asarray(row_choices)
    tasks, rejected = [], 0

    async def one(model_id, X):
        nonlocal rejected
        try:
            return model_id, X, await gateway.submit(model_id, X)
        except AdmissionError:
            rejected += 1
            return None

    for i in range(n_requests):
        if hot_swap is not None and i == hot_swap[0]:
            hot_swap[1](gateway)
        model_id = model_ids[int(rng.integers(0, len(model_ids)))]
        n_rows = int(rng.choice(row_choices))
        if rng.random() < hot_frac:
            X = hot[model_id][rng.integers(0, len(hot[model_id]), n_rows)]
        else:
            X = pools[model_id][rng.integers(0, len(pools[model_id]), n_rows)]
        tasks.append(asyncio.ensure_future(one(model_id, X)))
        if rate_hz != float("inf"):
            await asyncio.sleep(rng.exponential(1.0 / rate_hz))
    results = [r for r in await asyncio.gather(*tasks) if r is not None]
    return results, rejected


def resolve_gateway_spec(args):
    """One EngineSpec from ``--gw-spec`` plus the legacy per-field flags.

    ``--gw-spec`` is the canonical form; any legacy flag given explicitly
    overrides the corresponding spec field (the flags default to None so
    "not given" is distinguishable).  ``--workers`` selects the remote plan
    (when no plan was named) and becomes the plan's deployment kwargs:
    an integer spawns that many loopback worker processes, a comma list
    connects to an already-running fleet.
    Returns ``(spec, plan_kwargs)``.
    """
    from repro_torch.serve.spec import EngineSpec

    spec = EngineSpec.parse(args.gw_spec) if args.gw_spec else EngineSpec()
    over = {}
    if args.gw_mode is not None:
        over["mode"] = args.gw_mode
    if args.gw_backend is not None:
        over["backend"] = args.gw_backend
    if args.gw_layout is not None:
        over["layout"] = args.gw_layout
    if args.gw_plan is not None:
        over["plan"] = None if args.gw_plan == "auto" else args.gw_plan
    if args.gw_shards is not None:
        over["shards"] = args.gw_shards
    if args.gw_autotune:
        over["autotune"] = True
    if args.gw_block_rows is not None:
        backend = over.get("backend", spec.backend)
        if backend != "native_c_table":
            raise SystemExit(
                "--gw-block-rows is the table-walk C row-block knob; it "
                f"needs the native_c_table backend (got {backend!r})"
            )
        over["backend_kwargs"] = dict(spec.backend_kwargs or {},
                                      block_rows=args.gw_block_rows)
    plan_kwargs = None
    if getattr(args, "workers", None):
        w = args.workers
        workers = int(w) if w.isdigit() else [a.strip() for a in w.split(",")]
        plan_kwargs = {"workers": workers}
        if spec.plan is None and "plan" not in over:
            over["plan"] = "remote_tree_parallel"
        if (over.get("shards") or spec.shards) is None:
            over["shards"] = workers if isinstance(workers, int) else len(workers)
    return (spec.replace(**over) if over else spec), plan_kwargs


def serve_gateway(args):
    import asyncio

    from repro_torch.serve.gateway import Gateway
    from repro_torch.serve.registry import ModelRegistry
    from repro_torch.trees.forest import RandomForestClassifier

    spec, plan_kwargs = resolve_gateway_spec(args)
    print(f"gateway route: {spec}"
          + (f"  plan_kwargs={plan_kwargs}" if plan_kwargs else ""))

    registry = ModelRegistry()
    t0 = time.time()
    pools, (Xtr, ytr) = build_gateway_models(registry, rows=args.rows // 2 or 4000)
    print(f"registered models in {time.time()-t0:.1f}s: {registry.describe()}")
    tracer = None
    if args.gw_trace or args.gw_trace_out:
        from repro_torch.obs import Tracer

        tracer = Tracer(sample=args.gw_trace_sample)
    gateway = Gateway(
        registry,
        spec,
        device=args.device,
        plan_kwargs=plan_kwargs,
        max_batch_rows=args.gw_batch_rows,
        max_delay_ms=args.gw_max_delay_ms,
        max_queue_rows=args.gw_queue_rows,
        tracer=tracer,
    )

    # warm every (model, bucket) pair — through the plan, so every shard of a
    # tree-/row-parallel route pre-compiles — so compiles don't pollute
    # latency stats
    t0 = time.time()
    for mid in registry.ids():
        eng = registry.get(mid).engine(spec, device=args.device, plan_kwargs=plan_kwargs)
        eng.warm(args.gw_batch_rows)
    print(f"warmed shape buckets in {time.time()-t0:.1f}s "
          f"(plan={eng.plan_name}, shards={eng.n_shards}, "
          f"tuned={eng.tuned_config or '-'})")

    def _do_swap(gw):
        mv = gw.registry.register_forest(
            "shuttle-rf",
            RandomForestClassifier(n_estimators=28, max_depth=6, seed=9).fit(Xtr, ytr),
        )
        # warm the new version too (every shard of its plan)
        mv.engine(spec, device=args.device, plan_kwargs=plan_kwargs).warm(args.gw_batch_rows)
        print(f"  hot-swapped shuttle-rf -> v{mv.version} under live traffic")

    swap_done = []

    def swap(gw):
        # train/warm off the event loop; the registry repoint itself is atomic
        swap_done.append(asyncio.get_running_loop().run_in_executor(None, _do_swap, gw))

    async def main():
        t0 = time.time()
        results, rejected = await run_gateway_workload(
            gateway, pools, n_requests=args.gw_requests, rate_hz=args.gw_rate,
            hot_swap=(args.gw_requests // 2, swap),
        )
        dt = time.time() - t0
        for fut in swap_done:  # make sure the hot-swap has landed
            await fut
        print(f"\nworkload: {len(results)} requests served, {rejected} rejected, "
              f"{dt:.2f}s wall ({len(results)/dt:.0f} req/s)")
        print(gateway.render_table())
        print(f"cache: {gateway.cache.stats()}")

        if tracer is not None:
            from repro_torch.obs import render_flame, write_jsonl

            spans = tracer.spans()
            print(f"\ntraces: {tracer.started} requests sampled, "
                  f"{len(spans)} spans ({tracer.dropped} dropped)")
            print(render_flame(spans))
            if args.gw_trace_out:
                write_jsonl(spans, args.gw_trace_out)
                print(f"wrote trace JSONL -> {args.gw_trace_out}")
        if args.gw_metrics_out:
            import re

            from repro_torch.obs import render_prometheus, snapshot_json

            st = gateway.stats()
            with open(args.gw_metrics_out, "w") as f:
                f.write(render_prometheus(st["per_model"]))
            jpath = re.sub(r"\.prom$", "", args.gw_metrics_out) + ".json"
            with open(jpath, "w") as f:
                f.write(snapshot_json(st, aggregate=gateway.metrics.aggregate()))
            print(f"wrote metrics exposition -> {args.gw_metrics_out} + {jpath}")

        # bit-identity: gateway outputs == direct engine on the same rows
        ok = True
        for mid in registry.ids():
            X = pools[mid][:48]
            g_scores, g_preds = await gateway.submit(mid, X)
            d_scores, d_preds = registry.get(mid).engine(
                spec, device=args.device, plan_kwargs=plan_kwargs
            ).predict_scores(X)
            ok &= bool((g_scores == d_scores).all() and (g_preds == d_preds).all())
        print(f"gateway == direct engine (bit-identical): {ok}")
        await gateway.close()
        return ok

    ok = asyncio.run(main())
    if not ok:
        raise SystemExit("gateway outputs diverged from direct engine")


def serve_lm(args):
    import torch

    from repro_torch.configs.base import get_config, smoke_config
    from repro_torch.data.tokens import pipeline_for
    from repro_torch.models import transformer as tfm
    from repro_torch.serve.engine import LMEngine

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    dev = args.device
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    # float32 parameters drawn on the device; the engine keeps its bf16
    # matmul copies and the float32 ones are dropped with this call's dict
    engine = LMEngine(cfg, tfm.init_params(cfg, 0, device=dev),
                      max_seq=args.prompt + args.tokens, device=dev)
    pipe = pipeline_for(cfg, args.batch, args.prompt)
    batch = {k: v for k, v in pipe.batch_at(0).items() if k != "labels"}
    t0 = time.time()
    out = engine.generate(batch, args.tokens, temperature=args.temperature).cpu()
    dt = time.time() - t0
    print(f"generated {tuple(out.shape)} tokens in {dt:.2f}s "
          f"({args.batch*args.tokens/dt:.1f} tok/s); sample: {out[0, :16].numpy()}")
    if dev.type == "cuda":
        print(f"peak device memory: {torch.cuda.max_memory_allocated(dev) / 2**30:.3f} GiB "
              f"on {torch.cuda.get_device_name(dev)}")
    else:
        print(f"peak device memory: not measured on {dev}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--trees", action="store_true")
    ap.add_argument("--rows", type=int, default=20000)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--n-trees", type=int, default=50)
    ap.add_argument("--depth", type=int, default=7)
    ap.add_argument("--gateway", action="store_true",
                    help="run the async dynamic-batching gateway workload")
    ap.add_argument("--gw-requests", type=int, default=400)
    ap.add_argument("--gw-rate", type=float, default=400.0, help="Poisson arrival rate (req/s)")
    ap.add_argument("--gw-batch-rows", type=int, default=64)
    ap.add_argument("--gw-max-delay-ms", type=float, default=5.0)
    ap.add_argument("--gw-queue-rows", type=int, default=2048)
    ap.add_argument("--gw-spec", default=None, metavar="SPEC",
                    help="the serving route as one EngineSpec string, e.g. "
                         "'integer:bitvector@leaf_major+tree_parallel:4' or "
                         "'flint:reference+remote_tree_parallel:2'; the "
                         "--gw-mode/--gw-backend/--gw-layout/--gw-plan/"
                         "--gw-shards flags remain as per-field overrides")
    ap.add_argument("--gw-mode", default=None, choices=("float", "flint", "integer"))
    from repro_torch.backends import available_backends

    ap.add_argument("--gw-backend", default=None,
                    choices=tuple(available_backends()),
                    help="execution backend behind the gateway "
                         "(default: reference)")
    from repro_torch.ir import available_layouts

    ap.add_argument("--gw-layout", default=None,
                    choices=tuple(available_layouts()),
                    help="ForestIR layout to materialize (default: the "
                         "backend's preferred layout)")
    ap.add_argument("--gw-block-rows", type=int, default=None,
                    help="rows in flight per tree for the table-walk C "
                         "backend (1 = scalar walk; default: the backend's "
                         "preferred_block_rows)")
    from repro_torch.plan import available_plans

    ap.add_argument("--gw-plan", default=None,
                    choices=tuple(available_plans()) + ("auto",),
                    help="execution plan behind the gateway (default: "
                         "single-shard; 'auto' selects by capability from "
                         "--gw-shards and the mode)")
    ap.add_argument("--gw-autotune", action="store_true",
                    help="measure backend construction knobs (table-walk "
                         "block_rows, bitvector interleave width, the CUDA "
                         "walk's CTA shape) during warm and serve on the winner; "
                         "REPRO_AUTOTUNE=0 disables globally")
    ap.add_argument("--gw-shards", type=int, default=None,
                    help="shard count for tree-/row-parallel plans (trees "
                         "are carved via ForestIR.subset; partial integer "
                         "scores merge bit-exactly)")
    ap.add_argument("--workers", default=None, metavar="N|HOST:PORT,...",
                    help="serve tree shards on worker processes: an integer "
                         "spawns that many loopback workers, a comma list "
                         "connects to already-running ones (see "
                         "--worker-listen); implies the remote_tree_parallel "
                         "plan unless --gw-plan/--gw-spec name another")
    ap.add_argument("--worker-listen", default=None, metavar="HOST:PORT",
                    help="run as a shard worker instead of a gateway: bind "
                         "here, print WORKER_READY, and serve uint32 "
                         "partials over the ITRG wire protocol (equivalent "
                         "to python -m repro_torch.serve.worker)")
    ap.add_argument("--worker-span-out", default=None, metavar="PATH",
                    help="worker mode: append per-request span JSONL here")
    ap.add_argument("--gw-trace", action="store_true",
                    help="sample per-request span trees and print a "
                         "flame-style stage summary after the workload")
    ap.add_argument("--gw-trace-sample", type=float, default=1.0,
                    help="fraction of requests to trace (deterministic "
                         "accumulator sampling; default 1.0)")
    ap.add_argument("--gw-trace-out", default=None,
                    help="write sampled spans as JSONL (implies --gw-trace)")
    ap.add_argument("--gw-metrics-out", default=None,
                    help="write a Prometheus-text metrics snapshot here "
                         "(plus a .json sibling with the full stats dict)")
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda",
                    help="where every mode runs (default cuda; cpu runs the "
                         "kernels' plain PyTorch versions)")
    args = ap.parse_args(argv)
    if args.worker_listen:
        from repro_torch.serve import worker

        wargv = ["--listen", args.worker_listen, "--device", args.device]
        if args.worker_span_out:
            wargv += ["--span-out", args.worker_span_out]
        return worker.main(wargv)
    from repro_torch.device import resolve_device

    args.device = resolve_device(args.device)
    if args.trees and args.gateway:
        serve_gateway(args)
    elif args.trees:
        serve_trees(args)
    else:
        serve_lm(args)


if __name__ == "__main__":
    main()
