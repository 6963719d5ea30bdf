"""Rank programs for the port's process-group tests (``test_torch_distributed``
on the CPU, ``test_torch_cuda`` on the card): each runs in its own process
of a gloo group initialized through a file (no TCP port), and writes what it
computed under ``out_dir`` for the test to read.  No JAX here, so a spawned
rank starts fast and the card tests can use it too; the parameters' digest
is ``chip_smoke.params_digest``, the one the smoke run compares ranks by."""
import contextlib
import math
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


# ---------------------------------------------------------------------------
# the mesh branches (test_torch_mesh on the CPU, test_torch_cuda on the card)
# ---------------------------------------------------------------------------

ATTN_CASES = {
    # name: (q shape, kv shape, _attn_core keywords); the first three are
    # tests/test_distributed.py's, the last two the merged-head split and
    # the MQA fallback of a prefill whose kv heads do not divide `model`
    "train_gqa": ((4, 32, 4, 2, 16), (4, 32, 4, 16), dict(causal=True, window=0, q_chunk=8)),
    "decode_mqa_seqshard": ((4, 1, 1, 8, 16), (4, 64, 1, 16),
                            dict(causal=True, window=0, q_chunk=8, q_offset=40, kv_len=41)),
    "decode_long_batch1": ((1, 1, 4, 2, 16), (1, 128, 4, 16),
                           dict(causal=True, window=24, q_chunk=8, q_offset=100, kv_len=101)),
    "prefill_merged_heads": ((4, 16, 2, 4, 16), (4, 16, 2, 16),
                             dict(causal=True, window=0, q_chunk=8)),
    "prefill_mqa_fallback": ((2, 16, 1, 2, 16), (2, 16, 1, 16),
                             dict(causal=True, window=5, q_chunk=8)),
}
MOE_CAPACITY = (4.0, 1.0)  # the smoke model's (dropless), and one that drops
MOE_SHAPE = (4, 16)  # batch, seq of the olmoe smoke block's input
# the train step's smoke models: a dense model whose kv heads do not divide
# the model axis (the merged-head split, K/V gathered from the ranks'
# columns), an MoE model (the experts over model), a hybrid (the SSM blocks
# and the shared attention and MLP split) and an SSM model (its heads and
# its share of B and C over model, the in-projection's and conv's pieces
# gathered from the ranks' blocks)
TRAIN_ARCHS = ("granite-3-2b", "olmoe-1b-7b", "zamba2-2.7b", "mamba2-370m")
# the train case's AdamW: with eps 1, no warmup and no weight decay, the
# first step moves each parameter by g / (|g| + 1) of the clipped gradient g
# (the default config's first step is about lr * sign(g), which hides the
# gradient's scale), so the updated parameters show the gradients
TRAIN_OPT = dict(lr=1.0, eps=1.0, weight_decay=0.0, warmup_steps=1)


def comm_count(fn):
    """(fn(), the collectives it ran by ``CommDebugMode``'s count)."""
    from torch.distributed.tensor.debug import CommDebugMode

    with CommDebugMode() as cm:
        out = fn()
    return out, cm.get_total_counts()


def mesh_cases(data_dir: str, mesh, device: str) -> dict:
    """The mesh branches on the inputs in ``data_dir`` (written by the JAX
    side of ``test_torch_mesh``): each ``_attn_core`` case, the MoE block of
    the olmoe smoke model with its dispatch tables, the tree serving step and
    one train step of each ``TRAIN_ARCHS`` smoke model (``_train_case``),
    under ``mesh`` (or without one, for ``mesh=None``).  Returns numpy
    results; ``*_comms`` count the collectives each ran."""
    from repro_torch.configs import smoke_config
    from repro_torch.core.serving import tree_serve_step
    from repro_torch.models.layers import _attn_core
    from repro_torch.models.moe import ep_dispatch, moe_block, route
    from repro_torch.sharding.ops import (P, constrain, from_local, gather, local_block, use_mesh,
                                          use_rows, use_tp)

    d = Path(data_dir)
    bf16 = lambda a: torch.from_numpy(a).to(device, torch.bfloat16)
    out = {}
    with use_mesh(mesh):
        # constrain: a DTensor moved to its logical names' placements, a
        # plain tensor left as it is
        full = torch.arange(8 * 12, dtype=torch.float32, device=device).reshape(8, 12)
        out["constrain_plain_kept"] = constrain(full, "batch", "tp") is full
        if mesh is not None:
            rows = P(("data", "model"))
            x = from_local(local_block(full, mesh, rows).contiguous(), mesh, rows)
            (y, comms) = comm_count(lambda: constrain(x, "batch", "tp"))
            out["constrain_placements"] = repr(tuple(y.placements))
            out["constrain_same"] = torch.equal(gather(y), full)
            out["constrain_comms"] = comms
        for name, (_, _, kw) in ATTN_CASES.items():
            a = np.load(d / f"attn_{name}.npz")
            got, comms = comm_count(lambda: _attn_core(bf16(a["q"]), bf16(a["k"]), bf16(a["v"]),
                                                       mesh=mesh, **kw))
            out[f"attn_{name}"] = got.float().cpu().numpy()
            out[f"attn_{name}_comms"] = comms

        cfg = smoke_config("olmoe-1b-7b")
        moe = np.load(d / "moe.npz")
        mp_ = {k: torch.from_numpy(moe[k]).to(device) for k in
               ("w_router", "w_gate_e", "w_up_e", "w_down_e")}
        x = bf16(moe["x"])
        for cf in MOE_CAPACITY:
            (y, aux), comms = comm_count(lambda: moe_block(
                mp_, x, n_experts=cfg.n_experts, k=cfg.experts_per_token, act=cfg.act,
                capacity_factor=cf))
            out[f"moe_y_{cf}"] = y.float().cpu().numpy()
            out[f"moe_aux_{cf}"] = float(aux)
            out[f"moe_comms_{cf}"] = comms
            if mesh is None:
                continue
            # this rank's dispatch table: its data shard's tokens, its experts
            e_loc = cfg.n_experts // mesh.shape["model"]
            xt = local_block(x, mesh, P("data")).reshape(-1, cfg.d_model)
            _, gates, ids = route(mp_, xt, cfg.experts_per_token)
            capacity = int(max(1, (xt.shape[0] * cfg.experts_per_token * cf) // cfg.n_experts))
            src_tok, _ = ep_dispatch(ids, gates, mesh.axis_index("model") * e_loc, e_loc,
                                     capacity)
            out[f"moe_ids_{cf}"] = ids.cpu().numpy()
            out[f"moe_src_tok_{cf}"] = src_tok.cpu().numpy()
            # serving on each rank's rows: the block on this rank's data
            # shard of the tokens, its experts its ``model`` block, for the
            # prefill's tokens and a decode step's (one a row)
            experts = {k: v if k == "w_router" else local_block(v, mesh, P("model"))
                       for k, v in mp_.items()}
            for tag, xs in (("prefill", x), ("decode", x[:, :1])):
                with use_mesh(None), use_tp(mesh), use_rows(mesh, ("data",)):
                    y, _ = moe_block(experts, local_block(xs, mesh, P("data")),
                                     n_experts=cfg.n_experts, k=cfg.experts_per_token,
                                     act=cfg.act, capacity_factor=cf)
                out[f"moe_rows_{tag}_{cf}"] = y.float().cpu().numpy()

        t = np.load(d / "trees.npz")
        tables = {k: t[k] for k in ("feature", "threshold_key", "left", "right", "leaf_fixed")}
        (acc, preds), comms = comm_count(lambda: tree_serve_step(
            tables, t["keys"], int(t["depth"]), device=device))
        out["tree_comms"] = comms
        out["tree_local_rows"] = (acc if mesh is None else acc.to_local()).shape[0]
        out["tree_acc"] = gather(acc).view(torch.int32).cpu().numpy()
        out["tree_preds"] = gather(preds).cpu().numpy()

        for arch in TRAIN_ARCHS:
            params = _train_case(arch, d, mesh, device, out)
            if arch == TRAIN_ARCHS[0]:
                first = params
    if mesh is not None:
        out.update(_remesh_restore(d / f"ckpt_{dist.get_rank()}", first, mesh, device))
    return out


def _train_case(arch: str, d: Path, mesh, device, out: dict):
    """One train step of ``arch``'s smoke model on the weights and batch in
    ``train_<arch>.npz``, under ``mesh`` (or none), into ``out`` under
    ``train[<arch>]_`` keys: the loss, the gradient norm, every parameter
    after the step, the step's contraction flops on this rank, and under a
    mesh the blocks' bytes and each parameter gather's record
    (``_gather_records``).  Returns the parameters."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import smoke_config
    from repro_torch.models import transformer as tfm
    from repro_torch.sharding import rules
    from repro_torch.sharding.ops import gather
    from repro_torch.train import optimizer as opt
    from repro_torch.train.step import make_train_step
    from repro_torch.train.tree import flatten_with_paths, path_key, tree_leaves

    key = f"train[{arch}]_"
    cfg = smoke_config(arch)
    tr = np.load(d / f"train_{arch}.npz")
    params = tfm.params_from_numpy(
        cfg, _unflatten({k[2:]: tr[k] for k in tr.files if k.startswith("p:")}), device=device)
    if mesh is not None:
        params = rules.place(params, rules.params_shardings(params, mesh))
    ostate = opt.init_opt_state(params)
    batch = {k: tr[k] for k in ("tokens", "labels")}
    grad_shapes = []  # (a gradient's shape, its block's), as each is accumulated
    if mesh is not None:
        with torch.no_grad():  # each DTensor's own local tensor
            hooks = [t.to_local().requires_grad_(True).register_post_accumulate_grad_hook(
                lambda p: grad_shapes.append((tuple(p.grad.shape), tuple(p.shape))))
                for t in tree_leaves(params)]
    step = make_train_step(cfg, opt.AdamWConfig(**TRAIN_OPT))
    flops = FlopCounterMode(display=False)
    with _gather_records(params, mesh) as gathers, flops:
        params, ostate, m = step(params, ostate, batch)
    if mesh is not None:
        for h in hooks:
            h.remove()
        out.update({key + k: v for k, v in _block_bytes(params, ostate, mesh, grad_shapes).items()})
        out.update({key + k: v for k, v in gathers.items()})
    out[key + "flops"] = float(flops.get_total_flops())
    out[key + "loss"] = float(m["loss"])
    out[key + "grad_norm"] = float(m["grad_norm"])
    out[key + "step"] = int(ostate["step"])
    for path, p in flatten_with_paths(params):
        out[f"{key}p:{path_key(path)}"] = gather(p).detach().cpu().numpy()
    return params


@contextlib.contextmanager
def _gather_records(params, mesh):
    """While the step runs, each parameter gather (``ops.gather_block``) by
    leaf: ``whole_over_model``, the leaves gathered whole with a dimension
    split over ``model`` (a gather over ``model``); ``split_shapes_ok``,
    whether every leaf gathered into its ``model`` block (or into its
    pieces, ``Block.model_pieces``) came out whole along every dimension but
    the one its spec splits over ``model``, that one cut by the ``model``
    size; ``split_leaves``, the leaves gathered so."""
    from repro_torch.sharding import ops
    from repro_torch.train.tree import flatten_with_paths, path_key

    rec = {}
    if mesh is None:
        yield rec
        return
    where = {}
    for path, t in flatten_with_paths(params):
        local = t.to_local()
        where[local.untyped_storage().data_ptr()] = (path_key(path), tuple(t.shape))
    real = ops.gather_block
    seen = []

    def spy(local, spec, mesh_, *, whole=True, sum_over_model=False, pieces=None):
        got = real(local, spec, mesh_, whole=whole, sum_over_model=sum_over_model, pieces=pieces)
        name, shape = where[local.untyped_storage().data_ptr()]
        seen.append((name, shape[len(shape) - got.dim():], tuple(spec), whole, tuple(got.shape)))
        return got

    ops.gather_block = spy
    try:
        yield rec
    finally:
        ops.gather_block = real
    over_model, ok, split = set(), True, set()
    tp = mesh.shape["model"]
    for name, shape, spec, whole, got in seen:
        model_dims = [i for i, e in enumerate(spec) if "model" in ops.entry_axes(e)]
        if not model_dims:
            continue
        if whole:
            over_model.add(name)
            continue
        split.add(name)
        want = tuple(n // tp if i in model_dims else n for i, n in enumerate(shape))
        ok &= got == want
    rec.update(whole_over_model=np.array(sorted(over_model)), split_shapes_ok=ok,
               split_leaves=np.array(sorted(split)))


def _block_bytes(params, ostate, mesh, grad_shapes) -> dict:
    """After a sharded step: the bytes this rank holds of the parameters
    and both moments, against the blocks their specs give; the gradients
    seen while they were accumulated, each against its block's shape; and
    whether any gradient outlived the step."""
    from repro_torch.launch.specs import local_shape
    from repro_torch.sharding import rules
    from repro_torch.train.tree import tree_leaves

    with torch.no_grad():
        held = sum(t.to_local().numel() * t.to_local().element_size()
                   for tree in (params, ostate["m"], ostate["v"]) for t in tree_leaves(tree))
        left = [t.to_local().grad is not None for t in tree_leaves(params)]
    want = 3 * sum(math.prod(local_shape(t.shape, mesh, s.spec)) * 4 for t, s in
                   zip(tree_leaves(params), tree_leaves(rules.params_shardings(params, mesh))))
    return {"block_bytes_held": held, "block_bytes_want": want,
            "block_grads_seen": len(grad_shapes),
            "block_grads_match": all(g == b for g, b in grad_shapes),
            "block_grads_left": any(left)}


def _remesh_restore(directory, params, mesh, device) -> dict:
    """The sharded parameters saved (gathered whole) and restored onto a
    mesh of another shape, every rank on ``data`` (the elastic re-mesh
    path): each leaf comes back placed by that mesh's rule, its value the
    saved one."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.launch.mesh import compat_make_mesh
    from repro_torch.sharding import rules
    from repro_torch.sharding.ops import gather
    from repro_torch.train.tree import tree_leaves

    mgr = CheckpointManager(directory)
    mgr.save(1, {"params": params})
    other = compat_make_mesh((mesh.size, 1), ("data", "model"), device=device)
    shardings = rules.params_shardings(params, other)
    back = mgr.restore(1, {"params": params}, shardings={"params": shardings})["params"]
    pairs = list(zip(tree_leaves(back), tree_leaves(params), tree_leaves(shardings)))
    return {"remesh_placed": all(b.device_mesh is other.device_mesh
                                 and tuple(b.placements) == s.placements for b, _, s in pairs),
            "remesh_same": all(torch.equal(gather(b), gather(p).detach()) for b, p, _ in pairs),
            "remesh_sharded": sum(any(e is not None for e in s.spec) for _, _, s in pairs)}


def _unflatten(flat: dict) -> dict:
    """{"a/b": x} -> {"a": {"b": x}}."""
    tree: dict = {}
    for key, v in flat.items():
        node = tree
        *head, last = key.split("/")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = v
    return tree


def mesh_rank(rank, n, data_dir, out_dir, shape, axes, device="cpu"):
    """Rank r of a ``shape`` mesh over ``axes`` on ``device``:
    ``mesh_cases``, and the collectives staged through the host, saved as
    ``mesh_<r>.npz``."""
    from repro_torch.launch.mesh import compat_make_mesh
    from repro_torch.sharding.ops import STAGED

    mesh = compat_make_mesh(shape, axes, device=device)
    out = mesh_cases(data_dir, mesh, device)
    np.savez(os.path.join(out_dir, f"mesh_{rank}.npz"), staged=sum(STAGED.values()), **out)


def write_mesh_inputs(data_dir, seed: int = 0) -> None:
    """``mesh_cases``' inputs made by this package alone (numpy and the
    port; no JAX): random bf16 attention inputs, the olmoe smoke block's
    drawn weights, a small forest's packed tables and keys, and the granite
    smoke models' drawn weights with a token batch each (``TRAIN_ARCHS``)."""
    from repro_torch.configs import smoke_config
    from repro_torch.core.flint import float_to_key
    from repro_torch.core.packing import pack_forest
    from repro_torch.data.tabular import make_shuttle_like
    from repro_torch.data.tokens import pipeline_for
    from repro_torch.models import transformer as tfm
    from repro_torch.models.layers import Init
    from repro_torch.models.moe import moe_params
    from repro_torch.train.tree import flatten_with_paths, path_key
    from repro_torch.trees.forest import RandomForestClassifier

    d = Path(data_dir)
    d.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    bf16 = lambda shape: torch.from_numpy(rng.normal(size=shape)).to(torch.bfloat16).float().numpy()
    for name, (qs, ks, _) in ATTN_CASES.items():
        np.savez(d / f"attn_{name}.npz", q=bf16(qs), k=bf16(ks), v=bf16(ks))
    cfg = smoke_config("olmoe-1b-7b")
    init = Init(torch.Generator().manual_seed(seed), torch.device("cpu"))
    mp_ = moe_params(init, cfg.d_model, cfg.n_experts, cfg.d_ff)
    np.savez(d / "moe.npz", x=bf16(MOE_SHAPE + (cfg.d_model,)),
             **{k: v.numpy() for k, v in mp_.items()})
    X, y = make_shuttle_like(n=3000, seed=1)
    packed = pack_forest(RandomForestClassifier(n_estimators=8, max_depth=5, seed=0).fit(X, y))
    np.savez(d / "trees.npz", keys=float_to_key(torch.from_numpy(X[:1024])).numpy(),
             depth=packed.max_depth, **{k: getattr(packed, k) for k in
                                        ("feature", "threshold_key", "left", "right",
                                         "leaf_fixed")})
    for arch in TRAIN_ARCHS:
        cfg = smoke_config(arch)
        params = tfm.init_params(cfg, seed, device="cpu")
        np.savez(d / f"train_{arch}.npz", **pipeline_for(cfg, 8, 64).batch_at(0),
                 **{"p:" + path_key(p): t.numpy() for p, t in flatten_with_paths(params)})


def microbatch_rank(rank, n, out_dir, arch, microbatches, batch, seq):
    """One ``make_train_step`` step of ``arch``'s smoke model with
    ``microbatches`` in a process group without a mesh, the microbatch
    count recorded where ``accumulate_grads`` is called; saved as
    ``micro_<r>.npz``."""
    import dataclasses

    from repro_torch.configs import smoke_config
    from repro_torch.data.tokens import pipeline_for
    from repro_torch.models import transformer as tfm
    from repro_torch.train import optimizer as opt
    from repro_torch.train import step as step_mod

    counts = []
    real = step_mod.accumulate_grads

    def spy(cfg, params, b, n_micro=1):
        counts.append(n_micro)
        return real(cfg, params, b, n_micro)

    step_mod.accumulate_grads = spy
    cfg = dataclasses.replace(smoke_config(arch), microbatches=microbatches)
    params = tfm.init_params(cfg, 0, device="cpu")
    _, _, m = step_mod.make_train_step(cfg, opt.AdamWConfig())(
        params, opt.init_opt_state(params), pipeline_for(cfg, batch, seq).batch_at(0))
    np.savez(os.path.join(out_dir, f"micro_{rank}.npz"), counts=np.array(counts),
             loss=float(m["loss"]), world=dist.get_world_size())


# the tensor-parallel step against ``chip_smoke.split_control``: a (data 1,
# model 2) mesh, 8 rows of 64 tokens in microbatches of one row, and a
# vocabulary of an odd size, so the head stays whole (as granite-3-2b's
# 49,155 rows do on the card's two ranks)
TP_CONTROL = dict(shape=(1, 2), rows=8, seq=64, vocab=257)


def tp_control_config(arch: str, vocab: int = TP_CONTROL["vocab"]):
    """``arch``'s smoke model with ``TP_CONTROL``'s vocabulary (or
    ``vocab``) and microbatches."""
    import dataclasses

    from repro_torch.configs import smoke_config

    return dataclasses.replace(smoke_config(arch), vocab_size=vocab,
                               microbatches=TP_CONTROL["rows"])


def tp_control_rank(rank, n, out_dir, arch, vocab=TP_CONTROL["vocab"]):
    """One tensor-parallel step of ``tp_control_config(arch, vocab)`` from
    seed 0's weights on the ``TP_CONTROL`` mesh with ``TRAIN_OPT``; rank 0
    saves the gathered parameters, loss and gradient norm as
    ``tp_control.npz``."""
    from repro_torch.data.tokens import pipeline_for
    from repro_torch.launch.mesh import compat_make_mesh
    from repro_torch.models import transformer as tfm
    from repro_torch.sharding import rules
    from repro_torch.sharding.ops import gather, use_mesh
    from repro_torch.train import optimizer as opt
    from repro_torch.train.step import make_train_step
    from repro_torch.train.tree import flatten_with_paths, path_key

    cfg = tp_control_config(arch, vocab)
    mesh = compat_make_mesh(TP_CONTROL["shape"], ("data", "model"), device="cpu")
    params = tfm.init_params(cfg, 0, device="cpu")
    params = rules.place(params, rules.params_shardings(params, mesh))
    with use_mesh(mesh):
        params, _, m = make_train_step(cfg, opt.AdamWConfig(**TRAIN_OPT))(
            params, opt.init_opt_state(params),
            pipeline_for(cfg, TP_CONTROL["rows"], TP_CONTROL["seq"]).batch_at(0))
    whole = {path_key(k): gather(v).detach().numpy() for k, v in flatten_with_paths(params)}
    if rank == 0:
        np.savez(os.path.join(out_dir, "tp_control.npz"), loss=float(m["loss"]),
                 grad_norm=float(m["grad_norm"]), **{"p:" + k: v for k, v in whole.items()})


# serving with the parameters as blocks on a (data 2, model 2) mesh: name ->
# (architecture, its smoke config's overrides, batch, shard the cache's
# positions over data).  At batch 4 each rank serves its 2 rows (the batch
# over data), the layers split over model: the smoke granite's 2 kv heads
# split over model, or with 1 kv head its positions split over model; the
# smoke olmoe's experts split over model; the smoke mamba2's and zamba2's 4
# SSM heads split over model (a block cache holds its rank's rows and heads
# of the state, its rows and a contiguous share of the conv history's
# channels); the smoke llava's heads split, its patches cut to the rank's
# rows.  At batch 1 (positions_over_data) the rows stay whole on every rank
# and the cache's positions split over data (a flash decode over data).
TP_SERVE_CASES = {"heads_split": ("granite-3-2b", {}, 4, False),
                  "positions_over_data": ("granite-3-2b", {}, 1, True),
                  "positions_over_model": ("granite-3-2b", {"n_kv_heads": 1}, 4, False),
                  "ssm_heads_split": ("mamba2-370m", {}, 4, False),
                  "hybrid_heads_split": ("zamba2-2.7b", {}, 4, False),
                  "moe_experts_split": ("olmoe-1b-7b", {}, 4, False),
                  "vlm_heads_split": ("llava-next-34b", {}, 4, False)}
TP_SERVE = dict(shape=(2, 2), prompt=16, max_seq=32, steps=2)
# serving on each rank's rows against the reference's program jitted on its
# (data 2, model 2) mesh: the batch-4 cases above, and the smoke olmoe at a
# capacity factor of 1, where both programs drop pairs (per data shard at
# the prefill, over the whole batch at the decode step), so its rows leave
# whole weights and are held to the reference's mesh program only
REF_SERVE_CASES = {**{k: v for k, v in TP_SERVE_CASES.items() if v[2] == 4},
                   "moe_drops": ("olmoe-1b-7b", {"moe_capacity_factor": 1.0}, 4, False)}


def serve_config(arch: str, overrides: dict):
    """``arch``'s smoke model with ``overrides``."""
    import dataclasses

    from repro_torch.configs import smoke_config

    return dataclasses.replace(smoke_config(arch), **overrides)


def serve_max_seq(cfg) -> int:
    """The cache's positions: ``TP_SERVE["max_seq"]``, after a vision
    model's patches."""
    return TP_SERVE["max_seq"] + (cfg.vision_patches if cfg.family == "vlm" else 0)


def serve_inputs(cfg, b: int, seed: int = 1):
    """(the prompt's batch, the decode steps' tokens) as numpy, from a
    seeded generator: ``TP_SERVE["prompt"]`` tokens a row, and a vision
    model's patches."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, TP_SERVE["prompt"])).astype(np.int32)}
    if cfg.family == "vlm":
        batch["patches"] = rng.normal(size=(b, cfg.vision_patches, cfg.frontend_dim)
                                      ).astype(np.float32)
    steps = [rng.integers(0, cfg.vocab_size, (b, 1)).astype(np.int32)
             for _ in range(TP_SERVE["steps"])]
    return batch, steps


def serve_run(cfg, params, batch: dict, steps: list, place=lambda cache: cache) -> list:
    """The prefill's and each decode step's logits, the cache placed by
    ``place`` after the prefill; each as this rank's rows where the logits
    come back as a ``DTensor`` (float32 numpy)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.models import transformer as tfm

    local = lambda t: (t.to_local() if isinstance(t, DTensor) else t).float().numpy()
    logits, cache = tfm.prefill(cfg, params, batch, max_seq=serve_max_seq(cfg))
    got = [local(logits)]
    cache = place(cache)
    for t in steps:
        got.append(local(tfm.decode_step(cfg, params, cache, t)[0]))
    return got


def _placed_inputs(batch: dict, steps: list, mesh):
    """The batch and the decode tokens as ``DTensor``s, each placed over
    the batch axes by ``rules.batch_shardings``."""
    from repro_torch.sharding import rules

    place = lambda tree: rules.place(tree, rules.batch_shardings(mesh, tree))
    return place(batch), [place({"t": t})["t"] for t in steps]


def tp_serve_rank(rank, n, out_dir):
    """For each ``TP_SERVE_CASES`` model: ``prefill`` and ``TP_SERVE["steps"]``
    ``decode_step``s with the parameters as blocks under the mesh, on plain
    whole inputs, decoding over the prefill's cache and over that cache
    placed again by ``rules.cache_shardings`` as blocks, then on inputs
    placed as ``DTensor``s over the batch axes (each rank's rows come back);
    rank 0 also runs them with whole parameters and no mesh.  Every run's
    contraction flops are counted.  Rank 0 saves every last-token logits
    of the plain inputs as ``tp_serve.npz``; each rank saves its rows of
    the ``DTensor`` run and its flops as ``tp_serve_<r>.npz``."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch.mesh import compat_make_mesh
    from repro_torch.models import transformer as tfm
    from repro_torch.sharding import ops, rules

    mesh = compat_make_mesh(TP_SERVE["shape"], ("data", "model"), device="cpu")
    out, mine = {}, {}
    for name, (arch, overrides, b, shard_seq) in TP_SERVE_CASES.items():
        cfg = serve_config(arch, overrides)
        params = tfm.init_params(cfg, 0, device="cpu")
        batch, steps = serve_inputs(cfg, b)
        batch = {k: torch.from_numpy(v) for k, v in batch.items()}
        steps = [torch.from_numpy(t) for t in steps]

        def as_blocks(cache):
            pos = cache.pop("pos")
            sh = rules.cache_shardings(mesh, cache, shard_seq=shard_seq)
            return {**ops.blocks(rules.place(cache, sh), sh), "pos": pos}

        sh = rules.params_shardings(params, mesh)
        blocks = ops.blocks(rules.place(params, sh), sh)
        with torch.no_grad(), ops.use_mesh(mesh):
            for tag, place in (("plain_cache", lambda c: c), ("block_cache", as_blocks)):
                with FlopCounterMode(display=False) as flops:
                    got = serve_run(cfg, blocks, batch, steps, place)
                for i, g in enumerate(got):
                    out[f"{name}_{tag}_{i}"] = g
                mine[f"{name}_{tag}_flops"] = float(flops.get_total_flops())
            for i, g in enumerate(serve_run(cfg, blocks, *_placed_inputs(batch, steps, mesh))):
                mine[f"{name}_dtensor_{i}"] = g
        if rank == 0:
            with torch.no_grad(), FlopCounterMode(display=False) as flops:
                got = serve_run(cfg, params, batch, steps)
            for i, g in enumerate(got):
                out[f"{name}_single_{i}"] = g
            out[f"{name}_single_flops"] = float(flops.get_total_flops())
    mine["coords"] = np.array([mesh.axis_index(a) for a in mesh.axis_names])
    np.savez(os.path.join(out_dir, f"tp_serve_{rank}.npz"), **mine)
    if rank == 0:
        np.savez(os.path.join(out_dir, "tp_serve.npz"), **out)


def ref_serve_rank(rank, n, data_dir, out_dir):
    """Each ``REF_SERVE_CASES`` model on the weights, prompt and decode
    tokens the reference wrote to ``serve_<name>.npz`` (its parameters drawn
    by its ``init_params``): ``prefill`` and one ``decode_step`` with the
    parameters as blocks of the (data 2, model 2) mesh and the inputs as
    ``DTensor``s placed over the batch axes by ``rules.batch_pspec``; each
    rank saves its rows of both logits as ``ref_serve_<r>.npz``."""
    from repro_torch.launch.mesh import compat_make_mesh
    from repro_torch.models import transformer as tfm
    from repro_torch.sharding import ops, rules

    mesh = compat_make_mesh(TP_SERVE["shape"], ("data", "model"), device="cpu")
    out = {}
    for name, (arch, overrides, b, _) in REF_SERVE_CASES.items():
        cfg = serve_config(arch, overrides)
        d = np.load(Path(data_dir) / f"serve_{name}.npz")
        params = tfm.params_from_numpy(
            cfg, _unflatten({k[2:]: d[k] for k in d.files if k.startswith("p:")}), device="cpu")
        batch = {k: torch.from_numpy(d[k]) for k in ("tokens", "patches") if k in d.files}
        sh = rules.params_shardings(params, mesh)
        blocks = ops.blocks(rules.place(params, sh), sh)
        with torch.no_grad(), ops.use_mesh(mesh):
            got = serve_run(cfg, blocks, *_placed_inputs(batch, [torch.from_numpy(d["step"])],
                                                          mesh))
        for i, g in enumerate(got):
            out[f"{name}_{i}"] = g
    out["coords"] = np.array([mesh.axis_index(a) for a in mesh.axis_names])
    np.savez(os.path.join(out_dir, f"ref_serve_{rank}.npz"), **out)


# serving against the split control on a (data 1, model 2) mesh: the smoke
# mamba2 (3 layers, 4 SSM heads, a vocabulary of 256 that divides the ranks),
# a prompt that is no multiple of its chunk of 32, then decode steps
TP_SERVE_CONTROL = dict(arch="mamba2-370m", shape=(1, 2), batch=2, prompt=40, steps=3)


def tp_serve_control_rank(rank, n, out_dir):
    """``prefill`` and ``TP_SERVE_CONTROL["steps"]`` ``decode_step``s of
    its model from seed 0's weights, the parameters as blocks of its mesh,
    decoding over the prefill's plain cache and over the same cache placed
    as blocks; rank 0 saves every last-token logits as
    ``tp_serve_control.npz``."""
    from repro_torch.configs import smoke_config
    from repro_torch.launch.mesh import compat_make_mesh
    from repro_torch.models import transformer as tfm
    from repro_torch.sharding import ops, rules

    c = TP_SERVE_CONTROL
    cfg = smoke_config(c["arch"])
    mesh = compat_make_mesh(c["shape"], ("data", "model"), device="cpu")
    params = tfm.init_params(cfg, 0, device="cpu")
    prompt, steps = tp_serve_control_tokens(cfg)
    sh = rules.params_shardings(params, mesh)
    blocks = ops.blocks(rules.place(params, sh), sh)

    def as_blocks(cache):
        pos = cache.pop("pos")
        csh = rules.cache_shardings(mesh, cache)
        return {**ops.blocks(rules.place(cache, csh), csh), "pos": pos}

    out = {}
    with torch.no_grad(), ops.use_mesh(mesh):
        for tag, place in (("plain_cache", lambda cache: cache), ("block_cache", as_blocks)):
            for i, g in enumerate(tp_serve_control_run(cfg, blocks, prompt, steps, place)):
                out[f"{tag}_{i}"] = g
    if rank == 0:
        np.savez(os.path.join(out_dir, "tp_serve_control.npz"), **out)


def tp_serve_control_tokens(cfg):
    """(prompt, decode tokens) of ``TP_SERVE_CONTROL``, from a seeded
    generator."""
    c = TP_SERVE_CONTROL
    rng = np.random.default_rng(2)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (c["batch"], c["prompt"])))
    return prompt, [torch.from_numpy(rng.integers(0, cfg.vocab_size, (c["batch"], 1)))
                    for _ in range(c["steps"])]


def tp_serve_control_run(cfg, params, prompt, steps, place) -> list:
    """The prefill's and each decode step's logits (float32 numpy), the
    cache placed by ``place`` after the prefill."""
    from repro_torch.models import transformer as tfm

    logits, cache = tfm.prefill(cfg, params, {"tokens": prompt},
                                max_seq=prompt.shape[1] + len(steps))
    got = [logits]
    cache = place(cache)
    for t in steps:
        got.append(tfm.decode_step(cfg, params, cache, t)[0])
    return [g.float().numpy() for g in got]


# the gated norm split over model: (batch, seq, channels a rank) of the
# gated product on each of 2 ranks
GATED_NORM_SHAPE = (2, 8, 64)


def gated_norm_rank(rank, n, out_dir):
    """``ssm.gated_norm_tp`` on a (data 1, model ``n``) mesh: rank r takes
    channels [r c, (r + 1) c) of one seeded float32 gated product and of
    gamma, and saves its output and the gradients of its channels and of
    its gamma share, under a loss that weights each output channel
    differently, as ``gated_norm_<r>.npz``."""
    from repro_torch.launch.mesh import compat_make_mesh
    from repro_torch.models.ssm import gated_norm_tp

    mesh = compat_make_mesh((1, n), ("data", "model"), device="cpu")
    b, s, c = GATED_NORM_SHAPE
    rng = np.random.default_rng(3)
    g = torch.from_numpy(rng.normal(size=(b, s, n * c)).astype(np.float32))
    gamma = torch.from_numpy(rng.normal(size=(n * c,)).astype(np.float32))
    weight = torch.from_numpy(rng.normal(size=(n * c,)).astype(np.float32))
    share = lambda t: t[..., rank * c:(rank + 1) * c]
    gl = share(g).clone().requires_grad_(True)
    gam = share(gamma).clone().requires_grad_(True)
    y = gated_norm_tp(gl, gam, mesh, n * c, torch.float32)
    (y * share(weight)).sum().backward()
    np.savez(os.path.join(out_dir, f"gated_norm_{rank}.npz"), y=y.detach().numpy(),
             g_grad=gl.grad.numpy(), gamma_grad=gam.grad.numpy(),
             g=g.numpy(), gamma=gamma.numpy(), weight=weight.numpy())


# ``Block.model_pieces`` on a (data 2, model 2) mesh: each case is (the
# global shape, the spec, the dimension, the model ranks' pieces along it)
PIECES_CASES = {
    "columns_split": ((6, 12), ("data", "model"), 1,
                      (((0, 2), (5, 3), (10, 1)), ((2, 3), (8, 2), (11, 1)))),
    "rows_split": ((12, 3), ("model", None), 0, (((1, 4), (9, 3)), ((0, 1), (5, 4)))),
}


def pieces_weight(shape, dim: int, n: int, rank: int) -> np.ndarray:
    """The loss weight of rank ``rank``'s ``n`` pieced entries: a seeded
    normal array of the gathered shape, one for each rank."""
    size = list(shape)
    size[dim] = n
    return np.random.default_rng(10 + rank).normal(size=size).astype(np.float32)


def pieces_rank(rank, n, out_dir):
    """For each ``PIECES_CASES`` case: this rank's ``Block`` of one seeded
    float32 tensor, its pieces gathered by ``model_pieces`` and, under the
    loss sum(pieces * ``pieces_weight``), the gradient of its block;
    saved as ``pieces_<r>.npz``."""
    from repro_torch.launch.mesh import compat_make_mesh
    from repro_torch.sharding.ops import Block, P, local_block

    mesh = compat_make_mesh((2, 2), ("data", "model"), device="cpu")
    out = {}
    for name, (shape, spec, dim, table) in PIECES_CASES.items():
        whole = torch.from_numpy(np.random.default_rng(5).normal(size=shape).astype(np.float32))
        local = local_block(whole, mesh, P(*spec)).clone().requires_grad_(True)
        got = Block(local, spec, mesh).model_pieces(dim, table)
        weight = pieces_weight(shape, dim, got.shape[dim], rank)
        (got * torch.from_numpy(weight)).sum().backward()
        out[f"{name}_got"] = got.detach().numpy()
        out[f"{name}_grad"] = local.grad.numpy()
        out[f"{name}_model"] = mesh.axis_index("model")
        out[f"{name}_data"] = mesh.axis_index("data")
    np.savez(os.path.join(out_dir, f"pieces_{rank}.npz"), **out)
