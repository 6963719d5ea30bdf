"""The share of the traced window, in %, in which no operation (kernel, copy
or fill) ran on the card."""
from portbench import devtrace, stats


def read(records, cfg):
    events = stats.window_events(records)
    if not events:
        return None
    t0, t1 = records["trace_window"]
    return 100.0 * (1.0 - devtrace.busy_us(events) / (t1 - t0))
