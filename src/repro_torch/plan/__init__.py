"""Execution plans: engine -> plan -> backend partials -> merge -> finalize.

Only the ``single`` plan is ported so far.
"""
from repro_torch.plan.base import (
    ExecutionPlan,
    available_plans,
    build_backend,
    create_plan,
    plan_class,
    register_plan,
    select_plan,
)
from repro_torch.plan.single import SingleShardPlan

__all__ = [
    "ExecutionPlan",
    "SingleShardPlan",
    "available_plans",
    "build_backend",
    "create_plan",
    "plan_class",
    "register_plan",
    "select_plan",
]
