"""The share of the traced window, in %, in which the card is idle and none
of the program's ranges (``portbench.spans``) is open on any thread the trace
records: idle that the program's named stages do not account for, such as the
harness's clients, asyncio's own scheduling and the interpreter lock.  Given to
the gateway's cell alone, whose event loop opens the trace and so has its
ranges recorded; the bulk cells' ranges are on client threads the trace does
not record, and there it would only repeat ``device.idle``.

The program sets what it reads by where it places its ranges: widen a range
and the share falls with no host work gone, so a change to the ranges' places
is read beside ``device.idle`` and the run's breakdown.  With no range of the
program in the trace (the program before its ranges) every idle stretch is
unaccounted for and it reads as ``device.idle`` does; a trace with nothing on
the card is idle all through."""
from portbench import spans, stats


def read(records, cfg):
    if "trace_window" not in records:
        return None
    t0, t1 = records["trace_window"]
    idle_us = spans.idle_unspanned_us(stats.window_events(records), spans.ranges(records), t0, t1)
    return 100.0 * idle_us / (t1 - t0)
