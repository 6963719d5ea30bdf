"""The dry run: what each rank of the production meshes holds and moves,
for every (architecture x input shape) cell, with no device behind it.
The PyTorch counterpart of the JAX package's ``launch/dryrun.py``.

The reference lowers and compiles each cell on 512 placeholder host
devices.  Here the world is a fake process group of 256 or 512 ranks in
this one process (``torch.testing._internal.distributed.fake_pg``: its
collectives return at once), ``launch.mesh.make_production_mesh`` builds
the 16 x 16 or 2 x 16 x 16 mesh on it, and rank 0's eager program runs on
``meta`` tensors (``launch.specs``): every tensor has its shape, dtype and
placement and no memory, and each aten operation runs its meta kernel.
(``FakeTensorMode`` gives the same operations and counts at several
times the host time: its dispatch is Python.)  While it runs, ``op_cost``
counts its flops and byte bound, ``comm_analysis`` its collectives' bytes
and its memory (``MemTracker``), and ``FlopCounterMode`` the library's own
flop count (``cost_xla_reference``, where the reference records the
compiler's).
Per-rank flops and bytes are multiplied by the ranks for the global
record, so ``roofline.terms`` divides them as the reference does.

Train cells run the sharded ``make_train_step`` (each layer's parameters
gathered over the batch axes inside its block into the rank's ``model``
blocks, the layers split over ``model``, gradients reduce-scattered into
blocks), so a train cell's useful ratio (model flops over the ranks'
flops) counts rematerialization and the pieces every ``model`` rank
computes alike (a vocabulary or head count that does not divide
``model`` and the SSM's (Q x Q) scores, as the reference's program
repeats them); prefill,
decode and the tree cells run
``tfm.prefill`` (or ``forward_logits`` for an encoder), ``decode_step``
over a cache placed by ``rules.cache_shardings`` and
``core.serving.tree_serve_step``, the parameters as blocks gathered a
layer at a time into the same split layers, each rank on its rows of the
batch as ``specs`` places it (over ``pod`` x ``data`` where the batch
divides them, as the reference's partitioned program computes each
device's rows; long_500k's one row whole on every rank).

Usage (no card needed):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3-27b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes [--out build/dryrun]
"""
from __future__ import annotations

import argparse
import contextlib
import json
import pathlib
import time
import traceback

from repro_torch.configs.base import ARCHS, get_config
from repro_torch.launch.shapes import SHAPES, applicable_shapes


@contextlib.contextmanager
def fake_world(n: int):
    """A fake process group of ``n`` ranks in this process, as rank 0; its
    collectives do nothing.  Destroyed on exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("the dry run makes its own fake process group; one exists")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def lower_cell(cfg, shape_name: str, mesh):
    """(the rank's program, its abstract arguments, whether it trains) for
    the cell, on ``meta`` tensors."""
    from repro_torch.launch import specs as sp
    from repro_torch.models import transformer as tfm
    from repro_torch.sharding import ops, rules
    from repro_torch.train import optimizer as opt
    from repro_torch.train.step import make_train_step

    if cfg.family == "trees":
        from repro_torch.core.serving import tree_serve_step

        tables = sp.tree_table_specs(cfg, mesh)
        x = sp.tree_input_specs(cfg, shape_name, mesh)

        def serve_trees(tables, x_keys):
            return tree_serve_step(tables, x_keys, cfg.tree_depth, device="meta")

        return serve_trees, (tables, x), False

    mode = SHAPES[shape_name]["mode"]
    params = sp.params_specs(cfg, mesh)
    if mode == "train":
        batch = sp.batch_specs(cfg, shape_name, mesh, with_labels=True)
        return make_train_step(cfg, opt.AdamWConfig()), \
            (params, sp.opt_state_specs(cfg, mesh), batch), True
    # serving: the parameters as blocks, a layer gathered at a time; the
    # batch and the decode tokens as ``specs`` places them, so each rank
    # takes its rows where the batch splits over the batch axes (and the
    # whole batch, replicated, where it does not: long_500k's one row)
    blocks = ops.blocks(params, rules.params_shardings(params, mesh))
    if mode == "prefill":
        batch = sp.batch_specs(cfg, shape_name, mesh, with_labels=False)
        if cfg.encoder_only:
            return (lambda p, b: tfm.forward_logits(cfg, p, b)), (blocks, batch), False
        seq = SHAPES[shape_name]["seq"]
        return (lambda p, b: tfm.prefill(cfg, p, b, max_seq=seq)), (blocks, batch), False
    cache, _ = sp.cache_specs(cfg, shape_name, mesh)
    pos = cache.pop("pos")
    cache = {**ops.blocks(cache, rules.cache_shardings(
        mesh, cache, shard_seq=shape_name == "long_500k")), "pos": pos}
    tokens = sp.decode_token_specs(cfg, shape_name, mesh)
    return (lambda p, c, t: tfm.decode_step(cfg, p, c, t)), (blocks, cache, tokens), False


def measure(fn, args, *, trains: bool, chips: int) -> dict:
    """Run ``fn(*args)`` (this rank's program on ``meta`` tensors, under the
    caller's mesh) once, with every analysis on: the record's
    ``jaxpr_cost`` (global: this rank's times ``chips``),
    ``cost_xla_reference``, ``memory``, ``collectives`` and ``run_s``."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch import comm_analysis, op_cost

    cost, comms = op_cost.OpCost(), comm_analysis.CollectiveBytes()
    flop_counter = FlopCounterMode(display=False)

    def run():
        with torch.set_grad_enabled(trains), flop_counter, comms, cost:
            return fn(*args)

    t0 = time.time()
    out, peak = comm_analysis.tracked_peak(run, args)
    per_rank = cost.result()
    per_rank["bytes_lb"] += op_cost.boundary_bytes(args, out)
    jc = op_cost.scaled(per_rank, chips)
    jc["by_op"] = {k: v * chips for k, v in sorted(cost.by_op.items(), key=lambda kv: -kv[1])}
    return {
        "run_s": round(time.time() - t0, 1),
        "jaxpr_cost": jc,
        "cost_xla_reference": {
            "flops": float(flop_counter.get_total_flops()), "bytes_accessed": 0.0,
            "transcendentals": 0.0, "source": "torch.utils.flop_counter.FlopCounterMode, one rank"},
        "memory": comm_analysis.memory_stats(args, out, peak),
        "collectives": comms.result(),
    }


def run_cell(arch: str, shape_name: str, *, multi_pod: bool, out_dir=None) -> dict:
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.roofline import model_flops, terms
    from repro_torch.sharding.ops import use_mesh

    cfg = get_config(arch)
    mesh_name = "2x16x16" if multi_pod else "16x16"
    chips = 512 if multi_pod else 256
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name, "chips": chips, "ok": False}
    t0 = time.time()
    try:
        with fake_world(chips), make_production_mesh(multi_pod=multi_pod, device="cpu") as mesh, \
                use_mesh(mesh):
            fn, args, trains = lower_cell(cfg, shape_name, mesh)
            rec.update(measure(fn, args, trains=trains, chips=chips))
            rec["model_flops"] = model_flops(cfg, shape_name)
            rec["roofline"] = terms(rec)
            rec["ok"] = True
    except Exception as e:  # noqa: BLE001 — record the failure, keep sweeping
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    rec["total_s"] = round(time.time() - t0, 1)
    if out_dir:
        out_dir = pathlib.Path(out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / f"{arch}__{shape_name}__{mesh_name}.json").write_text(json.dumps(rec, indent=1))
    return rec


def summary(rec: dict) -> str:
    """One line of a cell's record."""
    head = f"{rec['arch']:20s} {rec['shape']:12s} {rec['mesh']:8s}"
    if not rec["ok"]:
        return f"[FAIL] {head}: {rec['error']}"
    r, m = rec["roofline"], rec["memory"]
    return (f"[ok]  {head} run={rec['run_s']}s "
            f"argument={m['argument_size_in_bytes'] / 2**30:.3f}GiB "
            f"peak={m['peak_bytes'] / 2**30:.3f}GiB dom={r['dominant']:10s} "
            f"c/m/x={r['compute_s']:.2e}/{r['memory_s']:.2e}/{r['collective_s']:.2e}s "
            f"useful={r['useful_ratio']:.3f}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    if args.all:
        cells = [(arch, shape) for arch in ARCHS for shape in applicable_shapes(get_config(arch))]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape (or --all)")
        cells = [(args.arch, args.shape)]

    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    failures = 0
    for arch, shape in cells:
        for mp in meshes:
            mesh_name = "2x16x16" if mp else "16x16"
            out = pathlib.Path(args.out) / f"{arch}__{shape}__{mesh_name}.json"
            if args.skip_existing and out.exists() and json.loads(out.read_text()).get("ok"):
                print(f"[skip] {arch} {shape} {mesh_name}")
                continue
            rec = run_cell(arch, shape, multi_pod=mp, out_dir=args.out)
            failures += not rec["ok"]
            print(summary(rec), flush=True)
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
