"""The 95th percentile of every request's latency in the window, timed from
send by the benchmark's client clock: the boosted cell's engine."""
from portbench import stats


def read(records, cfg):
    return stats.p95_ms(records)
