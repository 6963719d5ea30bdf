"""Rows answered over the whole window, cache hits included (host clock)."""
from portbench import stats


def read(records, cfg):
    seconds = stats.window_s(records)
    return stats.rows_answered(records) / seconds if seconds > 0 else None
