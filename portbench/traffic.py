"""The one traffic generator: reads a mix's parameters, draws from the seed.

Every request is a run of rows of one ring of fresh rows drawn N(0, 1) from the
seed.  A fresh request takes the next ``n`` rows of the ring (back to its start
where fewer are left); a repeat takes again the rows of one fresh request drawn
from those that began within the last ``repeat_window_rows`` fresh rows, so its
rows are still in a cache of ``cache_rows``.  A ring row comes back only after
more fresh rows than the cache, the repeat window and every request in flight
can hold, so fresh rows never repeat within the cache's reach.

The mix's keys: ``sizes`` and ``shares`` (rows a request and their
probabilities), ``repeat_share``, ``repeat_window_rows``, ``ring_rows``,
``keep_share`` (the share of answers kept for the check, drawn per request),
``clients`` and, where a cache serves, ``gateway.cache_rows``.  The sequence of
requests depends on the seed alone, never on timing: clients take the next
request of one shared sequence.  A key that neither this generator
(``KEYS``) nor the mix's driver (its ``KEYS``) reads is refused by
``portbench.catalog``, so a mix never asks for what no code does.
"""
from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass

import numpy as np

from portbench.forest import ROWS_STREAM, SCHEDULE_STREAM, rng_for


# the mix keys that this generator and the harness read, whatever the driver
KEYS = ("driver", "clients", "sizes", "shares", "repeat_share", "repeat_window_rows",
        "ring_rows", "keep_share", "warmup_s")


@dataclass(frozen=True)
class Request:
    start: int   # first ring row
    n: int       # rows
    fresh: bool
    keep: bool   # kept for the check


def check_mix(mix: dict) -> None:
    """Fail loudly on a mix whose fresh rows could repeat within the cache."""
    sizes, shares = mix["sizes"], mix["shares"]
    if len(sizes) != len(shares) or not sizes or abs(sum(shares) - 1.0) > 1e-9:
        raise ValueError(f"sizes {sizes} and shares {shares} do not pair up")
    biggest = max(sizes)
    cache = mix.get("gateway", {}).get("cache_rows", 0)
    reach = cache + mix["repeat_window_rows"] + biggest * (mix["clients"] + 1)
    if mix["ring_rows"] - biggest < reach:
        raise ValueError(f"ring_rows {mix['ring_rows']} lets fresh rows come back within "
                         f"{reach} rows: the cache's reach")


class Traffic:
    """The seeded ring of rows and the request sequence of one mix."""

    def __init__(self, mix: dict, n_features: int, seed: int):
        check_mix(mix)
        self.mix = mix
        self.ring = rng_for(seed, ROWS_STREAM).standard_normal(
            (mix["ring_rows"], n_features), dtype=np.float32)
        self._rng = rng_for(seed, SCHEDULE_STREAM)
        self._sizes = np.asarray(mix["sizes"], np.int64)
        self._shares = np.asarray(mix["shares"], np.float64)
        self._cursor = 0      # next fresh ring row
        self._fresh_rows = 0  # fresh rows handed out so far
        self._recent = deque()  # (fresh rows before it, start, n) of recent fresh requests
        self._lock = threading.Lock()

    def rows(self, req: Request) -> np.ndarray:
        return self.ring[req.start:req.start + req.n]

    def next(self) -> Request:
        with self._lock:
            rng, mix = self._rng, self.mix
            n = int(rng.choice(self._sizes, p=self._shares))
            # four draws a request, whatever the branch, so the sequence is the seed's alone
            repeat = rng.random() < mix["repeat_share"]
            keep = rng.random() < mix["keep_share"]
            pick = rng.random()
            window = self._fresh_rows - mix["repeat_window_rows"]
            while self._recent and self._recent[0][0] < window:
                self._recent.popleft()
            if repeat and self._recent:
                _, start, n = self._recent[int(pick * len(self._recent))]
                return Request(start, n, False, keep)
            if self._cursor + n > len(self.ring):
                self._cursor = 0
            start = self._cursor
            self._recent.append((self._fresh_rows, start, n))
            self._cursor += n
            self._fresh_rows += n
            return Request(start, n, True, keep)
