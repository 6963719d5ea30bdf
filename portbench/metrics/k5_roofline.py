"""K5, the QuickScorer kernel (``bitvector_tile<...>``): its counted least
time (by the configuration's family) over its device time in the trace, in %."""
from portbench import devtrace, stats


def read(records, cfg):
    return stats.kernel_roofline(records, cfg, devtrace.K5)
