"""Bulk scoring: ``clients`` threads in a closed loop, each sending its next
request to one shared ``TreeEngine.predict_scores`` as soon as the last one is
answered, as batch-scoring workers that share one model on one card do."""
from __future__ import annotations

import threading
import time

from portbench import system

# the mix keys this driver reads besides the generator's
KEYS = ("route",)


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        self.answers = []   # (ring start, rows, scores, preds) of kept answers
        self.errors = []
        self.records = {}

    def build(self) -> None:
        """The engine on the mix's route, and each of the mix's request sizes
        run once, so every bucket the window uses is warm."""
        from repro_torch.ir import ForestIR
        from repro_torch.serve import TreeEngine

        ctx = self.ctx
        ir = ForestIR.from_forest(ctx.family.program_model(ctx.forest))
        self.engine = TreeEngine(ir, spec=ctx.mix["route"], device=ctx.device)
        for n in sorted(set(ctx.mix["sizes"])):
            self.engine.predict_scores(ctx.traffic.ring[:n])
        system.sync(ctx.device)

    def _phase(self, seconds: float, window: bool) -> tuple:
        ctx, eng = self.ctx, self.engine
        n = ctx.mix["clients"]
        logs = [[] for _ in range(n)]
        go = threading.Barrier(n + 1)
        deadline = []

        def client(i):
            go.wait()
            while time.perf_counter() < deadline[0]:
                req = ctx.traffic.next()
                x = ctx.traffic.rows(req)
                t = time.perf_counter()
                try:
                    scores, preds = eng.predict_scores(x)
                except Exception as e:  # an answer that never comes: counted as failed
                    logs[i].append((t, time.perf_counter(), req.n, False))
                    self.errors.append(repr(e))
                    continue
                logs[i].append((t, time.perf_counter(), req.n, True))
                if window and req.keep:
                    self.answers.append((req.start, req.n, scores, preds))

        threads = [threading.Thread(target=client, args=(i,), daemon=True) for i in range(n)]
        for th in threads:
            th.start()
        t0 = time.perf_counter()
        deadline.append(t0 + seconds)
        go.wait()
        for th in threads:
            th.join(timeout=seconds + 60)
        stuck = sum(th.is_alive() for th in threads)
        return t0, [r for log in logs for r in log], stuck

    def serve(self, warmup_s: float, seconds: float, window) -> None:
        """``warmup_s`` of the mix, then the window: ``seconds`` of it inside
        ``window`` (the harness's context: the profiler in traced runs)."""
        self._phase(warmup_s, False)
        self.engine.drain_stage_timings()
        with window:
            t0, reqs, stuck = self._phase(seconds, True)
            system.sync(self.ctx.device)
        stages = self.engine.drain_stage_timings()
        reqs.sort()
        self.records = {
            "t0": t0, "t1": max([r[1] for r in reqs], default=t0),
            "requests": reqs, "stuck": stuck, "stages": stages,
            # one launch a request: the real rows of each, in the order sent
            "batches": [r[2] for r in reqs if r[3]],
        }

    def close(self) -> None:
        self.engine.close()
        self.engine = None
