"""Fault-tolerance runtime pieces: step watchdog (straggler detection),
crash-restart training loop, elastic re-mesh on degraded device counts.
The JAX package's ``checkpoint/fault_tolerance.py`` over the port's
checkpoint manager (pure Python).

Failures are *injected* in tests and examples (a step raises mid-run); the
control flow — detect, checkpoint-restore, re-mesh, continue — is the code
path a real cluster deployment would execute.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.launch.mesh import elastic_mesh_shape


@dataclass
class StepWatchdog:
    """Flags straggling steps: step time > factor x rolling median.

    At pod scale a straggler usually means a failing host or thermal
    throttle; the runner responds by checkpointing early so a restart loses
    minimal work.  (Wall-clock based; works identically on device.)
    """

    factor: float = 3.0
    window: int = 20
    history: List[float] = field(default_factory=list)
    stragglers: int = 0

    def observe(self, dt: float) -> bool:
        self.history = (self.history + [dt])[-self.window :]
        med = sorted(self.history)[len(self.history) // 2]
        is_straggler = len(self.history) >= 5 and dt > self.factor * med
        if is_straggler:
            self.stragglers += 1
        return is_straggler


@dataclass
class RestartableLoop:
    """Checkpoint/restart training driver.

    ``run`` executes up to ``total_steps`` steps, checkpointing every
    ``ckpt_every``; any exception from ``step_fn`` triggers restore from the
    latest committed checkpoint and continuation.  ``max_restarts`` bounds
    crash loops (a real deployment would page ops instead).
    """

    manager: CheckpointManager
    ckpt_every: int = 10
    max_restarts: int = 3

    def run(self, state, step_fn: Callable, total_steps: int, *, watchdog=None,
            on_restart: Optional[Callable] = None):
        restarts = 0
        step = 0
        latest = self.manager.latest_step()
        if latest is not None:
            state = self.manager.restore(latest, state)
            step = latest
        while step < total_steps:
            try:
                t0 = time.time()
                state = step_fn(state, step)
                if watchdog is not None and watchdog.observe(time.time() - t0):
                    self.manager.save(step + 1, state)  # straggler: early ckpt
                step += 1
                if step % self.ckpt_every == 0:
                    self.manager.save(step, state)
            except Exception:
                restarts += 1
                if restarts > self.max_restarts:
                    raise
                latest = self.manager.latest_step()
                if latest is None:
                    step = 0
                else:
                    state = self.manager.restore(latest, state)
                    step = latest
                if on_restart is not None:
                    state = on_restart(state, step)
        self.manager.save(step, state)
        return state, {"restarts": restarts, "steps": step}


def plan_elastic_remesh(healthy_devices: int, model_axis: int = 16):
    """After failures, pick the next mesh; returns (shape, axis_names)."""
    return elastic_mesh_shape(healthy_devices, model=model_axis)
