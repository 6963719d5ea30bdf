"""K1, the bounded walk (``walk_tile<..., Walk::kBounded, ...>``), over a
boosted model's trees: its counted least time (by the configuration's
family, ``gbt``: a scalar leaf and one add a tree) over its device time in
the trace, in %."""
from portbench import devtrace, stats


def read(records, cfg):
    return stats.kernel_roofline(records, cfg, devtrace.K1)
