"""Runnable training driver: the PyTorch counterpart of
``repro.launch.train`` (CPU smoke scale to the production mesh, one code
path).

Composes the stack: config -> mesh -> parameters drawn on the device and
placed by the sharding rules -> data pipeline -> train step (microbatching,
or the integer data-parallel reduce) -> checkpoint manager + watchdog.  It
always runs under a mesh: ``make_host_mesh()`` (1 x 1, a process group of
this process alone) by default, ``make_production_mesh()`` with
``--production-mesh``, which needs a process group of 256 ranks (one rank
per card) and raises with the count it finds otherwise.  Runs on
``--device`` (default ``cuda``; without a card it raises).
``--integer-allreduce`` trains through ``make_integer_dp_train_step`` over
the mesh's ``data`` axis, with the parameters replicated, as that mode
keeps them.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --arch starcoder2-3b --smoke \
      --steps 50 --batch 8 --seq 128
  PYTHONPATH=src python -m repro_torch.launch.train --arch olmoe-1b-7b --smoke \
      --steps 20 --integer-allreduce
  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b --smoke --device cpu
"""
from __future__ import annotations

import argparse
import time


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
                    help="reduce gradients with the fixed-point integer all-reduce over the "
                         "mesh's data axis")
    ap.add_argument("--device", default="cuda",
                    help="where the model trains (default cuda; cpu runs on the host)")
    args = ap.parse_args(argv)

    from repro_torch.checkpoint.fault_tolerance import StepWatchdog
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.data.tokens import pipeline_for
    from repro_torch.device import resolve_device
    from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
    from repro_torch.models import transformer as tfm
    from repro_torch.sharding import rules
    from repro_torch.sharding.ops import use_mesh
    from repro_torch.train import optimizer as opt
    from repro_torch.train.step import make_integer_dp_train_step, make_train_step

    device = resolve_device(args.device)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    mesh = (make_production_mesh(device=device) if args.production_mesh
            else make_host_mesh(device=device))
    opt_cfg = opt.AdamWConfig(lr=args.lr, warmup_steps=10, total_steps=args.steps)

    with mesh, use_mesh(mesh):
        step_fn = (make_integer_dp_train_step(cfg, mesh, opt_cfg) if args.integer_allreduce
                   else make_train_step(cfg, opt_cfg))
        params = tfm.init_params(cfg, 0, device=device)
        if not args.integer_allreduce:
            params = rules.place(params, rules.params_shardings(params, mesh))
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
