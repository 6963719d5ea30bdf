"""The paper's fixed-point math applied to distributed training: integer
all-reduce demo on 8 ranks.  The PyTorch counterpart of the JAX package's
``examples/integer_allreduce_demo.py``, with 8 processes in a gloo process
group (initialized through a file, no TCP port) in place of 8 placeholder
devices.

Shows (1) the error stays within the paper-style bound, (2) the integer
reduction is bit-identical when the replicas are permuted, while float sums
depend on operand order.

    PYTHONPATH=src python -m repro_torch.examples.integer_allreduce_demo [--device cpu]

Each rank's tensors live on ``--device`` (default ``cuda``; every rank on
card 0; without a card it raises); gloo reduces CUDA tensors too.
"""
from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np

N_RANKS = 8
PERMUTATION = (7, 3, 1, 5, 0, 6, 2, 4)


def replicas() -> np.ndarray:
    """8 replicas' gradients, float32 (8, 4096)."""
    return np.random.default_rng(0).normal(size=(N_RANKS, 4096)).astype(np.float32)


def _rank(rank: int, device: str, tmp: str) -> None:
    import torch
    import torch.distributed as dist

    from repro_torch.train.intreeger_allreduce import integer_psum

    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(tmp, "store"), N_RANKS),
                            rank=rank, world_size=N_RANKS)
    try:
        g = replicas()
        sums = []
        for order in (range(N_RANKS), PERMUTATION):
            x = torch.from_numpy(g[list(order)[rank]]).to(device)
            sums.append(integer_psum(x).cpu().numpy())
        if rank == 0:
            np.save(os.path.join(tmp, "sums.npy"), np.stack(sums))
    finally:
        dist.destroy_process_group()


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples.integer_allreduce_demo")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch.multiprocessing as mp

    # the ranks take ``_rank`` by this module's name, also when it runs as
    # ``__main__``
    from repro_torch.examples import integer_allreduce_demo as demo
    from repro_torch.device import resolve_device
    from repro_torch.train.intreeger_allreduce import quantization_error_bound

    device = str(resolve_device(args.device))
    g = replicas()
    with tempfile.TemporaryDirectory(prefix="repro_torch_pg_") as tmp:
        mp.spawn(demo._rank, args=(device, tmp), nprocs=N_RANKS)
        int_sum, permuted = np.load(os.path.join(tmp, "sums.npy"))

    exact = g.astype(np.float64).sum(axis=0)
    bound = quantization_error_bound(N_RANKS, float(np.abs(g).max()))
    err = np.abs(int_sum - exact).max()
    print(f"integer psum max error: {err:.3e}  (bound {bound:.3e}) on {device}")
    assert err <= bound * 1.01

    # order-independence: permuting the replicas changes float sums, not integer
    a, b = (g[list(p)].astype(np.float32).sum(axis=0) for p in (range(N_RANKS), PERMUTATION))
    print(f"float32 order-dependent deltas: {np.abs(a - b).max():.3e}")
    same = np.array_equal(int_sum.view(np.uint32), permuted.view(np.uint32))
    print(f"integer psum with the replicas permuted: bit-identical {same}")
    assert same
    print("integer fixed-point accumulation is exactly order-independent "
          "(int addition is associative) -> bit-reproducible at any rank count")


if __name__ == "__main__":
    main()
