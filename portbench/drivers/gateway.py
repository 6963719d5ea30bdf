"""Online callers: ``clients`` coroutines in a closed loop on one event loop,
each awaiting ``Gateway.submit`` and sending its next request once answered.
The gateway's cache, micro-batcher and engine are the program's; the mix
gives its settings under ``gateway``."""
from __future__ import annotations

import asyncio
import time

from portbench import system

# the mix keys this driver reads besides the generator's
KEYS = ("route", "gateway")


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        self.answers = []
        self.errors = []
        self.records = {}

    def build(self) -> None:
        """The registry, the gateway on the mix's route and its engine, every
        bucket up to the largest request warmed.  In traced runs each batch's
        real rows are noted where the gateway hands it to its engine, one
        append a batch; the program's tracer stays off in every run."""
        from repro_torch.serve import Gateway, ModelRegistry

        ctx = self.ctx
        reg = ModelRegistry()
        mv = reg.register_forest(system.MODEL_ID, ctx.family.program_model(ctx.forest))
        self.gw = Gateway(reg, ctx.mix["route"], device=ctx.device, **ctx.mix["gateway"])
        eng = mv.engine(self.gw.spec, device=ctx.device, plan_kwargs=self.gw.plan_kwargs)
        eng.warm(max(ctx.mix["sizes"]))
        system.sync(ctx.device)
        self.batches = []  # (entry ns, real rows) of each batch, traced runs only
        if ctx.trace:
            predict = eng.predict_scores

            def noted(X):
                self.batches.append((time.perf_counter_ns(), len(X)))
                return predict(X)

            eng.predict_scores = noted

    async def _phase(self, seconds: float, window: bool) -> tuple:
        ctx, gw = self.ctx, self.gw
        log = []
        deadline = time.perf_counter() + seconds

        async def client():
            while time.perf_counter() < deadline:
                req = ctx.traffic.next()
                x = ctx.traffic.rows(req)
                t = time.perf_counter()
                try:
                    scores, preds = await gw.submit(system.MODEL_ID, x)
                except Exception as e:  # refused or failed: counted as failed
                    log.append((t, time.perf_counter(), req.n, False))
                    self.errors.append(repr(e))
                    continue
                log.append((t, time.perf_counter(), req.n, True))
                if window and req.keep:
                    self.answers.append((req.start, req.n, scores, preds))

        t0 = time.perf_counter()
        tasks = [asyncio.create_task(client()) for _ in range(ctx.mix["clients"])]
        done, pending = await asyncio.wait(tasks, timeout=seconds + 60)
        for task in pending:
            task.cancel()
        for task in done:
            task.result()
        return t0, log, len(pending)

    def _counters(self) -> dict:
        """The gateway's own counters (``Gateway.stats()``), to be differenced
        over the window."""
        st = self.gw.stats()["per_model"].get(system.MODEL_ID, {})
        queue = st.get("stages", {}).get("queue", {"count": 0, "sum": 0.0})
        return {"queue_count": queue["count"], "queue_ms": queue["sum"]}

    async def _session(self, warmup_s: float, seconds: float, window) -> None:
        await self._phase(warmup_s, False)
        before = self._counters()
        self.batches.clear()
        with window:
            t0, reqs, stuck = await self._phase(seconds, True)
            system.sync(self.ctx.device)
        after = self._counters()
        reqs.sort()
        self.records = {
            "t0": t0, "t1": max([r[1] for r in reqs], default=t0),
            "requests": reqs, "stuck": stuck,
            "counters": {k: after[k] - before[k] for k in after},
            # one launch a batch: the real rows of each, in the order dispatched
            "batches": [rows for _, rows in sorted(self.batches)],
        }
        await self.gw.close()

    def serve(self, warmup_s: float, seconds: float, window) -> None:
        asyncio.run(self._session(warmup_s, seconds, window))

    def close(self) -> None:
        self.gw = None
