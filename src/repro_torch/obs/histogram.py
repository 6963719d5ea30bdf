"""Fixed log-scale bucket histograms for serving telemetry.

The serving metrics used to keep every latency sample in a bounded-but-large
reservoir and run ``np.percentile`` over it at read time — O(n) memory per
model and O(n log n) per stats call, and two reservoirs can't be combined
without concatenating their samples.  :class:`LogHistogram` replaces that
with exact counters over a fixed log2-spaced bucket grid:

  * **O(1) record** — one ``log2`` and one list increment per sample, no
    allocation, no lock (int increments are GIL-atomic enough for metrics;
    a torn read costs at most one sample).
  * **Bounded memory** — ``sub`` buckets per octave between ``lo`` and
    ``hi`` (defaults: 1 µs .. 1000 s in ms units, 8 per octave ≈ 9 %
    relative bucket width), plus one underflow and one overflow bucket.
  * **Mergeable** — two histograms over the same grid add counter-wise
    (:meth:`merge`), so per-shard and per-model distributions roll up into
    gateway- or fleet-level ones exactly, something percentile reservoirs
    fundamentally cannot do.
  * **Quantiles within one bucket width** — :meth:`percentile` walks the
    cumulative counts and returns the geometric midpoint of the target
    bucket, clamped to the observed [min, max]; the estimate is within half
    a bucket (≈ 4.5 % at ``sub=8``) of the true sample quantile.
"""
from __future__ import annotations

import math

__all__ = ["LogHistogram"]


class LogHistogram:
    """Exact counters over log2-spaced buckets; values are unitless (the
    serving metrics record milliseconds)."""

    __slots__ = ("lo", "hi", "sub", "counts", "count", "total",
                 "vmin", "vmax", "_log_lo", "_n")

    def __init__(self, lo: float = 1e-3, hi: float = 1e6, sub: int = 8):
        if not (0 < lo < hi) or sub < 1:
            raise ValueError(f"need 0 < lo < hi and sub >= 1, got {lo}, {hi}, {sub}")
        self.lo = float(lo)
        self.hi = float(hi)
        self.sub = int(sub)
        self._log_lo = math.log2(lo)
        # bucket i in 1..n covers (edge(i-1), edge(i)] with
        # edge(i) = lo * 2**(i / sub); counts[0] is underflow (< lo, incl.
        # zero/negative), counts[n + 1] overflow (>= hi)
        self._n = int(math.ceil((math.log2(hi) - self._log_lo) * sub))
        self.counts = [0] * (self._n + 2)
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf

    # ------------------------------------------------------------- recording
    def record(self, v) -> None:
        v = float(v)
        self.count += 1
        self.total += v
        if v < self.vmin:
            self.vmin = v
        if v > self.vmax:
            self.vmax = v
        if v < self.lo:
            i = 0
        else:
            i = 1 + int((math.log2(v) - self._log_lo) * self.sub)
            if i > self._n:
                i = self._n + 1
        self.counts[i] += 1

    def merge(self, other: "LogHistogram") -> "LogHistogram":
        """Fold ``other``'s counters into this histogram (same grid only)."""
        if (self.lo, self.hi, self.sub) != (other.lo, other.hi, other.sub):
            raise ValueError(
                f"cannot merge histograms over different grids: "
                f"{(self.lo, self.hi, self.sub)} vs {(other.lo, other.hi, other.sub)}"
            )
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.count += other.count
        self.total += other.total
        self.vmin = min(self.vmin, other.vmin)
        self.vmax = max(self.vmax, other.vmax)
        return self

    # --------------------------------------------------------------- reading
    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else float("nan")

    def upper_edge(self, i: int) -> float:
        """Inclusive upper bound of bucket ``i`` (1..n); underflow reports
        ``lo``, overflow ``inf``."""
        if i <= 0:
            return self.lo
        if i > self._n:
            return math.inf
        return self.lo * 2.0 ** (i / self.sub)

    def percentile(self, q: float) -> float:
        """The ``q``-th percentile, within one bucket width of the true
        sample quantile (exact when all mass sits in one bucket, because the
        estimate is clamped to the observed [min, max])."""
        if self.count == 0:
            return float("nan")
        target = (q / 100.0) * self.count
        cum = 0
        for i, c in enumerate(self.counts):
            cum += c
            if c and cum >= target:
                if i == 0:
                    v = self.lo
                elif i > self._n:
                    v = self.vmax
                else:
                    # geometric midpoint: halves the worst-case log error
                    v = self.lo * 2.0 ** ((i - 0.5) / self.sub)
                return float(min(max(v, self.vmin), self.vmax))
        return float(self.vmax)

    def snapshot(self) -> dict:
        """A JSON-friendly view: scalar stats + the non-empty buckets as
        ``[upper_edge, count]`` pairs (``None`` edge = overflow/+Inf) — the
        exposition layer renders Prometheus cumulative buckets from this."""
        buckets = []
        for i, c in enumerate(self.counts):
            if c:
                le = self.upper_edge(i)
                buckets.append([None if math.isinf(le) else le, c])
        return {
            "count": self.count,
            "sum": self.total,
            "mean": self.mean,
            "min": self.vmin if self.count else float("nan"),
            "max": self.vmax if self.count else float("nan"),
            "p50": self.percentile(50),
            "p95": self.percentile(95),
            "p99": self.percentile(99),
            "buckets": buckets,
        }

    def __repr__(self) -> str:
        return (f"LogHistogram(n={self.count}, mean={self.mean:.4g}, "
                f"p50={self.percentile(50):.4g}, p99={self.percentile(99):.4g})")
