"""The averaged forest, the family of every configuration file without a
``"family"`` key: complete trees whose leaves hold class distributions
(``portbench.forest``), uint32 leaves at the scale ``floor((2**32 - 1) / T)``
whose sums are the scores (``portbench.reference``), and the work a batch
needs counted from the forest's shape (``portbench.work``).  It hands out the
benchmark's own pieces as they are."""
from portbench.forest import make_forest
from portbench.reference import Reference
from portbench.system import program_forest as program_model
from portbench.work import batch_bytes, batch_ops, bound_s

__all__ = ["make_forest", "Reference", "batch_bytes", "batch_ops", "bound_s", "program_model"]
