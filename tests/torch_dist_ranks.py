"""Rank programs for the port's process-group tests (``test_torch_distributed``
on the CPU, ``test_torch_cuda`` on the card): each runs in its own process
of a gloo group initialized through a file (no TCP port), and writes what it
computed under ``out_dir`` for the test to read.  No JAX here, so a spawned
rank starts fast and the card tests can use it too; the parameters' digest
is ``chip_smoke.params_digest``, the one the smoke run compares ranks by."""
import os
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import params_digest  # noqa: E402  (numpy only at import)


def _entry(rank, fn, n, store, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, n), rank=rank, world_size=n)
    try:
        fn(rank, n, *args)
    finally:
        dist.destroy_process_group()


def run_ranks(fn, n: int, *args) -> None:
    """``fn(rank, n, *args)`` in ``n`` spawned processes of one gloo group."""
    with tempfile.TemporaryDirectory(prefix="repro_torch_pg_") as tmp:
        mp.spawn(_entry, args=(fn, n, os.path.join(tmp, "store"), args), nprocs=n)


def _psums(rank, data, orders, device, group=None) -> np.ndarray:
    """``integer_psum`` over ``group`` of row ``order[rank]`` of ``data``,
    for each order, stacked."""
    from repro_torch.train.intreeger_allreduce import integer_psum

    return np.stack([integer_psum(torch.from_numpy(data[order[rank]]).to(device),
                                  group).cpu().numpy() for order in orders])


def psum_rank(rank, n, data_path, out_dir, device, orders):
    """Rank r saves its ``integer_psum`` of row ``order[rank]`` of the (n,
    ...) float32 array in ``data_path``, for each order, as ``psum_<r>.npy``
    (orders stacked), on ``device``."""
    np.save(os.path.join(out_dir, f"psum_{rank}.npy"),
            _psums(rank, np.load(data_path), orders, device))


def cases_rank(rank, n, out_dir, psum_cases, train_args):
    """Several cases in one group of ranks: each ``(tag, m, data_path,
    orders)`` of ``psum_cases`` runs on the group of the first m ranks,
    whose rank r saves ``<tag>_<r>.npy`` (as ``psum_rank``); then every rank
    trains (``dp_train_rank`` with ``train_args``) on the whole group."""
    for tag, m, data_path, orders in psum_cases:
        group = dist.new_group(list(range(m)))  # every rank takes part in making it
        if rank < m:
            np.save(os.path.join(out_dir, f"{tag}_{rank}.npy"),
                    _psums(rank, np.load(data_path), orders, "cpu", group))
    dp_train_rank(rank, n, out_dir, *train_args)


def dp_train_rank(rank, n, out_dir, arch, batch, seq, steps, lr, device):
    """``steps`` of ``make_integer_dp_train_step`` on ``arch``'s smoke model
    (seed 0) and the token pipeline's batches; rank r saves its losses and
    the digest of its parameters after each step as ``dp_<r>.npz``."""
    from repro_torch.configs import smoke_config
    from repro_torch.data.tokens import pipeline_for
    from repro_torch.models import transformer as tfm
    from repro_torch.train import optimizer as opt
    from repro_torch.train.step import make_integer_dp_train_step

    cfg = smoke_config(arch)
    params = tfm.init_params(cfg, 0, device=device)
    ostate = opt.init_opt_state(params)
    step = make_integer_dp_train_step(
        cfg, opt_cfg=opt.AdamWConfig(lr=lr, warmup_steps=5, total_steps=steps))
    pipe = pipeline_for(cfg, batch, seq)
    losses, digests = [], []
    for s in range(steps):
        params, ostate, m = step(params, ostate, pipe.batch_at(s))
        losses.append(float(m["loss"]))
        digests.append(params_digest(params))
    np.savez(os.path.join(out_dir, f"dp_{rank}.npz"), losses=np.array(losses),
             digests=np.array(digests))
