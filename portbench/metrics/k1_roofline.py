"""K1, the bounded walk (``walk_tile<..., Walk::kBounded, ...>``): its counted
least time (by the configuration's family) over its device time in the trace,
in %."""
from portbench import devtrace, stats


def read(records, cfg):
    return stats.kernel_roofline(records, cfg, devtrace.K1)
