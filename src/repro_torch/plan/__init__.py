"""Execution plans: engine -> plan -> backend partials -> merge -> finalize.

The integer-only accumulation makes ensemble aggregation an exact,
associative uint32 sum, so a forest can be split across backends and the
partial scores merged with no loss.  Plans carve the forest
(``ForestIR.subset`` tree shards, ``tree_parallel``) or the batch (row
shards, ``row_parallel``), drive ``TreeBackend.predict_partials`` on each
piece, merge, and run the finalize step once; ``remote_tree_parallel``
runs the tree shards in worker processes over the ITRG wire protocol.
Every plan is bit-identical to the ``single`` plan in the deterministic
modes.
"""
from repro_torch.plan.base import (
    ExecutionPlan,
    as_ir,
    available_plans,
    build_backend,
    create_plan,
    plan_class,
    register_plan,
    select_plan,
)
from repro_torch.plan.remote import RemoteTreeParallelPlan, WorkerError
from repro_torch.plan.row_parallel import RowParallelPlan
from repro_torch.plan.single import SingleShardPlan
from repro_torch.plan.tree_parallel import (
    TreeParallelPlan,
    thread_shard_cap,
    tree_ranges,
)

__all__ = [
    "ExecutionPlan",
    "RemoteTreeParallelPlan",
    "RowParallelPlan",
    "SingleShardPlan",
    "TreeParallelPlan",
    "as_ir",
    "available_plans",
    "build_backend",
    "create_plan",
    "plan_class",
    "register_plan",
    "select_plan",
    "thread_shard_cap",
    "tree_ranges",
    "WorkerError",
]
