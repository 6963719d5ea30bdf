"""End-to-end LM training driver (smoke-scale): trains a reduced starcoder2
for a few hundred steps with checkpointing and an injected crash halfway,
demonstrating loss descent and crash recovery.  The PyTorch counterpart of
the JAX package's ``examples/train_lm.py``.

    PYTHONPATH=src python -m repro_torch.examples.train_lm [--steps 300] [--device cpu]

Runs on ``--device`` (default ``cuda``; without a card it raises).  The
checkpoints go to a temporary directory, removed at the end.
"""
from __future__ import annotations

import argparse
import tempfile


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples.train_lm")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--arch", default="starcoder2-3b")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from repro_torch.checkpoint.fault_tolerance import RestartableLoop, StepWatchdog
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import smoke_config
    from repro_torch.data.tokens import pipeline_for
    from repro_torch.device import resolve_device
    from repro_torch.models import transformer as tfm
    from repro_torch.train import optimizer as opt
    from repro_torch.train.step import make_train_step

    cfg = smoke_config(args.arch)
    params = tfm.init_params(cfg, 0, device=resolve_device(args.device))
    ostate = opt.init_opt_state(params)
    opt_cfg = opt.AdamWConfig(lr=3e-3, warmup_steps=20, total_steps=args.steps)
    train_step = make_train_step(cfg, opt_cfg)
    pipe = pipeline_for(cfg, args.batch, args.seq)

    watchdog = StepWatchdog()
    crash = {"armed": True}
    losses = []

    def step_fn(state, step):
        if step == args.steps // 2 and crash["armed"]:
            crash["armed"] = False
            raise RuntimeError("injected mid-run failure (recovered from checkpoint)")
        p, o, m = train_step(state["params"], state["opt"], pipe.batch_at(step))
        losses.append(float(m["loss"]))
        if step % 25 == 0:
            print(f"step {step:4d} loss {losses[-1]:.4f} lr {float(m['lr']):.2e}")
        return {"params": p, "opt": o}

    with tempfile.TemporaryDirectory(prefix="repro_ckpt_") as ckpt_dir:
        loop = RestartableLoop(CheckpointManager(ckpt_dir), ckpt_every=50)
        state, info = loop.run(
            {"params": params, "opt": ostate}, step_fn, args.steps, watchdog=watchdog
        )
    print(
        f"done: loss {losses[0]:.3f} -> {losses[-1]:.3f} over {info['steps']} steps "
        f"with {info['restarts']} recovered crash(es)"
    )
    assert losses[-1] < losses[0] - 0.3, "loss should clearly descend"


if __name__ == "__main__":
    main()
