"""The rows' host-to-device copy of one bulk request, five ways, on one card.

A bulk request of the covtype cells is 65,536 rows of 54 float32 features
(14.16 MB).  Each of ``--threads`` threads (1, then 4 by default) copies its
own requests, taken in turn from a seeded ring of rows larger than the host's
caches, to the card on a stream of its own, and waits for its stream after
each one:

  * ``pageable``: ``torch.from_numpy(rows).to(card)``, the driver staging the
    copy through its own bounce buffer;
  * ``alloc_torch``: ``rows.pin_memory()`` (torch's caching host allocator,
    torch's ``copy_``) and ``.to(card, non_blocking=True)``;
  * ``alloc_numpy``: ``torch.empty(..., pin_memory=True)``, ``np.copyto`` into
    it, then the same ``.to``;
  * ``buffer_torch`` and ``buffer_numpy``: one pinned buffer a thread, kept
    across calls, with an event recorded after each copy and synchronised
    before the next write into it, filled by ``copy_`` or ``np.copyto``.

Per way and thread count it prints the host milliseconds a call spends
filling pinned memory, the milliseconds a call takes to its stream's end,
the copy's device milliseconds (CUDA events around it on the stream) and the
threads' aggregate GB/s.  Then, a way at a time, one thread fills pinned
memory in a loop while a probe thread sleeps 0.1 ms at a time: a fill that
held the interpreter lock would make the probe's wake-ups late by as long
as the fill takes, so the probe's lateness beside its lateness alone says
whether the fill releases the lock.  Last, ``--steady-s`` seconds of four
threads at once, pageable and then ``alloc_torch``, give each second's
aggregate GB/s and median device ms a copy: how steady each way's rate is
from second to second on a shared host.

    python3 benchmarks/pinned_staging.py [--reps 60] [--threads 1,4] [--features 54]
                                         [--steady-s 15]

Needs a CUDA card; prints the card's name and power limit first and writes
the results to ``chiprun_out/pinned_staging.json`` as well.  Imports neither
jax nor ``repro``, nor the program.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import threading
import time
from pathlib import Path

import numpy as np
import torch

ROWS = 65_536
FEATURES = 54  # the default of --features; 87 for the intreeger-rf forest's rows
RING_ROWS = 6 * ROWS  # 85 MB at 54 features, past the host's last-level cache
WAYS = ("pageable", "alloc_torch", "alloc_numpy", "buffer_torch", "buffer_numpy")


class Lane:
    """One thread's stream, and its kept buffer and event for the buffer ways."""

    def __init__(self, dev, features: int):
        self.stream = torch.cuda.Stream(dev)
        self.buf = torch.empty((ROWS, features), dtype=torch.float32, pin_memory=True)
        self.done = torch.cuda.Event()
        self.done.record(self.stream)


def copy_once(way: str, rows: np.ndarray, lane: Lane, dev) -> tuple:
    """(host ms filling pinned memory, the device tensor, the events around
    the copy)."""
    src = torch.from_numpy(rows)
    t0 = time.perf_counter()
    if way == "pageable":
        fill_ms, pinned = 0.0, src
    elif way.startswith("alloc"):
        if way == "alloc_torch":
            pinned = src.pin_memory()
        else:
            pinned = torch.empty(rows.shape, dtype=torch.float32, pin_memory=True)
            np.copyto(pinned.numpy(), rows)
        fill_ms = (time.perf_counter() - t0) * 1e3
    else:
        lane.done.synchronize()
        pinned = lane.buf
        if way == "buffer_torch":
            pinned.copy_(src)
        else:
            np.copyto(pinned.numpy(), rows)
        fill_ms = (time.perf_counter() - t0) * 1e3
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record(lane.stream)
    x = pinned.to(dev, non_blocking=way != "pageable")
    end.record(lane.stream)
    if way.startswith("buffer"):
        lane.done.record(lane.stream)
    return fill_ms, x, (start, end)


def run(way: str, n_threads: int, reps: int, ring: np.ndarray, dev) -> dict:
    lanes = [Lane(dev, ring.shape[1]) for _ in range(n_threads)]
    fills, calls, device = [], [], []
    lock = threading.Lock()
    go = threading.Barrier(n_threads + 1)

    def worker(i):
        lane, mine = lanes[i], []
        go.wait()
        with torch.cuda.stream(lane.stream):
            for r in range(reps):
                lo = ((i * reps + r) * ROWS) % (RING_ROWS - ROWS)
                t0 = time.perf_counter()
                fill_ms, x, ev = copy_once(way, ring[lo:lo + ROWS], lane, dev)
                lane.stream.synchronize()
                mine.append((fill_ms, (time.perf_counter() - t0) * 1e3, ev))
                del x
        with lock:
            for fill_ms, call_ms, (s, e) in mine[2:]:  # the first two warm the ways
                fills.append(fill_ms)
                calls.append(call_ms)
                device.append(s.elapsed_time(e))

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(n_threads)]
    for th in threads:
        th.start()
    go.wait()
    t0 = time.perf_counter()
    for th in threads:
        th.join(timeout=600)
    wall_s = time.perf_counter() - t0
    if any(th.is_alive() for th in threads):
        raise RuntimeError("a copy thread did not finish")
    nbytes = ROWS * ring.shape[1] * 4
    q = lambda v: [round(x, 4) for x in statistics.quantiles(v, n=4)]
    return dict(way=way, threads=n_threads, calls=len(calls),
                fill_ms_quartiles=q(fills) if any(fills) else [0.0, 0.0, 0.0],
                call_ms_quartiles=q(calls), device_ms_quartiles=q(device),
                aggregate_gb_s=round(n_threads * reps * nbytes / wall_s / 1e9, 3))


def probe_lateness(body) -> dict:
    """The ms by which a probe thread's 0.1 ms sleeps overran while
    ``body()`` ran: median and most, over ``n`` sleeps."""
    stop, late = [], []

    def probe():
        while not stop:
            t0 = time.perf_counter()
            time.sleep(1e-4)
            late.append((time.perf_counter() - t0) * 1e3 - 0.1)

    th = threading.Thread(target=probe)
    th.start()
    body()
    stop.append(1)
    th.join(timeout=60)
    return dict(median=round(statistics.median(late), 4), most=round(max(late), 4),
                n=len(late))


def fill_beside_probe(way: str, reps: int, ring: np.ndarray, dev) -> dict:
    """One thread's fills of pinned memory (no copy to the card) beside the
    sleeping probe: the probe's lateness and the fills' host ms."""
    lane, fills = Lane(dev, ring.shape[1]), []

    def body():
        for r in range(reps):
            lo = (r * ROWS) % (RING_ROWS - ROWS)
            fill_ms, _, _ = copy_once(way, ring[lo:lo + ROWS], lane, dev)
            fills.append(fill_ms)
        torch.cuda.synchronize()

    return dict(way=way, probe_late_ms=probe_lateness(body),
                fill_ms_median=round(statistics.median(fills), 4))


def steady(way: str, n_threads: int, seconds: float, ring: np.ndarray, dev) -> list:
    """``n_threads`` threads copying for ``seconds``: a second at a time, the
    copies' aggregate GB/s and median device ms."""
    lanes = [Lane(dev, ring.shape[1]) for _ in range(n_threads)]
    done, lock = [], threading.Lock()
    go = threading.Barrier(n_threads + 1)
    t_start = []

    def worker(i):
        lane, mine, r = lanes[i], [], 0
        go.wait()
        with torch.cuda.stream(lane.stream):
            while time.perf_counter() < t_start[0] + seconds:
                lo = ((i * 1000 + r) * ROWS) % (RING_ROWS - ROWS)
                _, x, ev = copy_once(way, ring[lo:lo + ROWS], lane, dev)
                lane.stream.synchronize()
                mine.append((time.perf_counter() - t_start[0], ev))
                r += 1
                del x
        with lock:
            done.extend((t, s.elapsed_time(e)) for t, (s, e) in mine)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(n_threads)]
    for th in threads:
        th.start()
    t_start.append(time.perf_counter())
    go.wait()
    for th in threads:
        th.join(timeout=seconds + 120)
    nbytes = ROWS * ring.shape[1] * 4
    per_s = []
    for sec in range(int(seconds)):
        ms = [d for t, d in done if sec <= t < sec + 1]
        if ms:
            per_s.append((round(len(ms) * nbytes / 1e9, 3), round(statistics.median(ms), 4)))
    return per_s


def spread(values: list) -> float:
    q = statistics.quantiles(values, n=4)
    return (q[2] - q[0]) / statistics.median(values)


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        out = "nvidia-smi unavailable"
    return out or torch.cuda.get_device_name(0)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=60)
    ap.add_argument("--threads", default="1,4")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--features", type=int, default=FEATURES)
    ap.add_argument("--steady-s", type=float, default=15.0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    dev = torch.device("cuda")
    print(f"{card_line()} | torch {torch.__version__} | host cores "
          f"{len(os.sched_getaffinity(0))}, torch threads {torch.get_num_threads()}")
    ring = np.random.default_rng(args.seed).standard_normal((RING_ROWS, args.features),
                                                           dtype=np.float32)
    results = []
    for n in (int(t) for t in args.threads.split(",")):
        for way in WAYS:
            results.append(run(way, n, args.reps, ring, dev))
            print(json.dumps(results[-1]))
    alone = probe_lateness(lambda: time.sleep(1.0))
    print(f"probe alone: late ms {alone}")
    locks = [fill_beside_probe(way, args.reps, ring, dev) for way in WAYS[1:]]
    for r in locks:
        print(json.dumps(r))
    rates = {way: steady(way, 4, args.steady_s, ring, dev) for way in ("pageable", "alloc_torch")}
    for way, per_s in rates.items():
        gbs = [g for g, _ in per_s]
        print(f"steady {way}, 4 threads, GB/s a second: {gbs}; spread (quartiles over "
              f"median) {spread(gbs):.4f}; median device ms a copy by second "
              f"{[m for _, m in per_s]}")
    out = Path("chiprun_out")
    out.mkdir(exist_ok=True)
    (out / "pinned_staging.json").write_text(json.dumps(
        {"card": card_line(), "torch": torch.__version__, "results": results,
         "probe_alone_late_ms": alone, "interpreter_lock": locks, "steady": rates,
         "features": args.features}, indent=1))


if __name__ == "__main__":
    main()
