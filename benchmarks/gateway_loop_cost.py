"""The gateway's own loop time a request: cache probe, fill and stitch.

Drives ``repro_torch.serve.Gateway.submit`` with the micro-batcher replaced
by a stub that answers at once from precomputed rows, so what is timed is
the event loop's work a request minus the batcher and the engine: FlInt
keys, the cache probe, the fill (with its evictions) and the stitch, plus
the metrics and span bookkeeping around them.  The cache is first filled to
its capacity (65,536 rows by default) with fresh rows, as the benchmark's
gateway cell keeps it; then each request size is timed on fresh rows (every
row a miss that evicts) and on repeats (every row a hit).  The shape is the
``intreeger-rf`` serving forest's: 87 features, 8 classes.

    PYTHONPATH=src python benchmarks/gateway_loop_cost.py [--reps 2000]

Prints one ``size,fresh_ms,repeat_ms`` line a size, the mix-weighted means
with the gateway cell's shares (0.35, 0.35, 0.2, 0.1 for 1, 20, 256 and
4,096 rows), and the cache's counters.  Imports neither jax nor ``repro``.
"""
from __future__ import annotations

import argparse
import asyncio
import statistics
import time

import numpy as np

SIZES = (1, 20, 256, 4096)
SHARES = (0.35, 0.35, 0.2, 0.1)


def build(features: int, classes: int, cache_rows: int):
    from repro_torch.serve import Gateway, ModelRegistry
    from repro_torch.trees.forest import RandomForestClassifier

    rng = np.random.default_rng(0)
    X = rng.normal(size=(400, features)).astype(np.float32)
    y = np.arange(400) % classes
    reg = ModelRegistry()
    reg.register_forest("m", RandomForestClassifier(n_estimators=1, max_depth=3,
                                                    seed=0).fit(X, y))
    gw = Gateway(reg, "integer:reference", device="cpu", cache_rows=cache_rows)
    answer = rng.random((max(SIZES), classes)).astype(np.float32)
    labels = answer.argmax(axis=1).astype(np.int32)
    version = reg.version("m")

    async def stub(model_id, rows, span=None):  # the batcher, answered at once
        return answer[:len(rows)], labels[:len(rows)], version

    gw.batcher.submit = stub
    return gw


async def measure(gw, features: int, reps: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)

    def fresh(n):
        return rng.normal(size=(n, features)).astype(np.float32)

    for _ in range(gw.cache.capacity_rows // max(SIZES) + 1):  # a full cache
        await gw.submit("m", fresh(max(SIZES)))
    out = {}
    for n in SIZES:
        rows = [fresh(n) for _ in range(max(20, reps // n))]
        # the repeats: the newest requests the cache still holds whole
        kinds = {"fresh": rows, "repeat": rows[-(gw.cache.capacity_rows // n):]}
        times = {kind: [] for kind in kinds}
        for kind, requests in kinds.items():
            for X in requests:
                t = time.perf_counter()
                await gw.submit("m", X)
                times[kind].append((time.perf_counter() - t) * 1e3)
        out[n] = {kind: statistics.median(v) for kind, v in times.items()}
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=2000,
                    help="rows a size and kind (20 requests at least)")
    ap.add_argument("--features", type=int, default=87)
    ap.add_argument("--classes", type=int, default=8)
    ap.add_argument("--cache-rows", type=int, default=65536)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args()
    gw = build(args.features, args.classes, args.cache_rows)
    res = asyncio.run(measure(gw, args.features, args.reps, args.seed))
    print("size,fresh_ms,repeat_ms")
    for n in SIZES:
        print(f"{n},{res[n]['fresh']:.5f},{res[n]['repeat']:.5f}")
    for kind in ("fresh", "repeat"):
        mix = sum(s * res[n][kind] for n, s in zip(SIZES, SHARES))
        print(f"mix_{kind}_ms,{mix:.5f}")
    print("cache", gw.cache.stats())


if __name__ == "__main__":
    main()
