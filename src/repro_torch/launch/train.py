"""Runnable training driver: the PyTorch counterpart of
``repro.launch.train``, on one device per process.

Composes the stack: config -> parameters drawn on the device -> data
pipeline -> train step (microbatching, or the integer data-parallel reduce)
-> checkpoint manager + watchdog.  Runs on ``--device`` (default ``cuda``;
without a card it raises).  ``--integer-allreduce`` trains through
``make_integer_dp_train_step`` over a gloo process group of this process
alone.  The production mesh and launches of several ranks are not here yet:
they need the sharding slice (ROADMAP item 13c).

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --arch starcoder2-3b --smoke \
      --steps 50 --batch 8 --seq 128
  PYTHONPATH=src python -m repro_torch.launch.train --arch olmoe-1b-7b --smoke \
      --steps 20 --integer-allreduce
  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b --smoke --device cpu
"""
from __future__ import annotations

import argparse
import contextlib
import os
import tempfile
import time


@contextlib.contextmanager
def process_group():
    """A gloo process group of this process alone, made through a temporary
    file (no TCP port), destroyed on exit."""
    import torch.distributed as dist

    with tempfile.TemporaryDirectory(prefix="repro_torch_pg_") as tmp:
        dist.init_process_group("gloo", store=dist.FileStore(os.path.join(tmp, "store"), 1),
                                rank=0, world_size=1)
        try:
            yield
        finally:
            dist.destroy_process_group()


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--production-mesh", action="store_true")
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--integer-allreduce", action="store_true",
                    help="reduce gradients with the fixed-point integer all-reduce (over a "
                         "process group of this process alone)")
    ap.add_argument("--device", default="cuda",
                    help="where the model trains (default cuda; cpu runs on the host)")
    args = ap.parse_args(argv)
    if args.production_mesh:
        raise SystemExit("--production-mesh: the device mesh is not ported yet; it comes "
                         "with the sharding slice (ROADMAP item 13c)")

    from repro_torch.checkpoint.fault_tolerance import StepWatchdog
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.data.tokens import pipeline_for
    from repro_torch.device import resolve_device
    from repro_torch.models import transformer as tfm
    from repro_torch.train import optimizer as opt
    from repro_torch.train.step import make_integer_dp_train_step, make_train_step

    device = resolve_device(args.device)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    opt_cfg = opt.AdamWConfig(lr=args.lr, warmup_steps=10, total_steps=args.steps)

    with process_group() if args.integer_allreduce else contextlib.nullcontext():
        step_fn = (make_integer_dp_train_step(cfg, opt_cfg=opt_cfg) if args.integer_allreduce
                   else make_train_step(cfg, opt_cfg))
        params = tfm.init_params(cfg, 0, device=device)
        opt_state = opt.init_opt_state(params)
        pipe = pipeline_for(cfg, args.batch, args.seq)

        manager = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
        watchdog = StepWatchdog()
        losses = []
        t_start = time.time()
        for step in range(args.steps):
            batch = pipe.batch_at(step)
            t0 = time.time()
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            losses.append(float(metrics["loss"]))
            dt = time.time() - t0
            watchdog.observe(dt)
            if step % args.log_every == 0 or step == args.steps - 1:
                print(
                    f"step {step:4d} loss {losses[-1]:.4f} "
                    f"lr {float(metrics['lr']):.2e} gnorm {float(metrics['grad_norm']):.3f} "
                    f"dt {dt*1e3:.0f}ms",
                    flush=True,
                )
            if manager and (step + 1) % args.ckpt_every == 0:
                manager.save(step + 1, {"params": params, "opt": opt_state}, blocking=False)
        if manager:
            manager.wait()
        print(
            f"done: {args.steps} steps in {time.time()-t_start:.1f}s; "
            f"loss {losses[0]:.4f} -> {losses[-1]:.4f}; stragglers={watchdog.stragglers}"
        )
        return losses


if __name__ == "__main__":
    main()
