"""The device mesh, activation sharding with logical axis names, and
per-rank bodies: the PyTorch counterpart of the JAX package's
``sharding/ops.py``.

Model code calls ``constrain(x, "batch", None, "tp")``, mesh-agnostic
logical names resolved against the ambient mesh (set by ``use_mesh``):

  * "batch" -> ("pod", "data") (whichever exist; divisibility-checked),
  * "tp"    -> "model",
  * "seq"   -> "data" (sequence parallelism),
  * None    -> replicated.

How the port runs a mesh.  Every rank runs the same program.  A plain
tensor is a global value held whole, and alike, on every rank; a
``DTensor`` is a global value sharded over the mesh.  ``constrain``
redistributes a ``DTensor`` to the placements its logical names resolve to
and leaves a plain tensor as it is; outside ``use_mesh`` it is a no-op, so
the same model code runs everywhere.  The mesh branches of the models and
of the serving step are explicit per-rank bodies, as the reference's
``shard_map`` bodies are: ``shard_map`` cuts each rank's block of every
input by its spec (no communication for a plain tensor), runs the body on
the blocks, and returns the outputs as ``DTensor``s with the out specs'
placements (no communication).  A body names its collectives itself
(``psum``, ``pmax``, ``pmean`` over mesh axes, ``axis_index``), and
``gather`` makes a ``DTensor`` whole again.

A spec is a ``P``, a tuple with one entry per tensor dimension (trailing
dimensions left out replicate): ``None``, a mesh axis name, or a tuple of
names, the first the most significant, as ``jax.sharding.PartitionSpec``
entries are.

A ``Block`` is this rank's block of a parameter (or cache) under its spec.
The sharded train step hands the model ``Block``s, and the model gathers
one layer's parameters at a time, over the batch axes only
(``Block.model_block``): FSDP over ``data``, the backward summing the
gradient over the batch axes into this rank's block, as the reference's
partitioned program gathers a layer inside the scanned block and
reduce-scatters its gradients.  What stays split is the parameter's
``model`` block, and the layers split their work over ``model`` with it
(tensor parallelism; ``use_tp``): each ``model`` rank computes its share
from its block, as the reference's partitioner splits each layer's
matmuls.  Three autograd-aware collectives over ``model`` join the shares
(``copy_to_model``, ``reduce_from_model``, ``gather_from_model``); a value
that all ``model`` ranks hold alike keeps a gradient that they hold
alike.  A layer that does not split (attention whose query heads do not
divide ``model``, an SSM whose heads or state do not) gathers its
parameters whole (``Block.whole``); the ``model`` ranks then compute the
same gradient, and each keeps its block's share of it.  A layer whose
ranks use parts of a parameter that its rule cuts otherwise gathers those
parts: disjoint pieces (the SSM's packed in-projection and conv) with
``Block.model_pieces``, each piece from the ``model`` rank whose block
holds it (an all-to-all, its gradient sent back the same way); parts of
a parameter the rule leaves whole over ``model`` (the SSM's per-head
leaves) as the whole with ``sum_over_model``: the backward sums the
ranks' gradients over ``model`` (an all-reduce).

Every collective goes through ``_collective``.  gloo carries CPU tensors;
a CUDA tensor on a gloo group (several ranks on one card, where NCCL
refuses a second rank) is copied to the host, reduced or gathered there
and copied back, and ``STAGED`` counts those calls by collective, those
over ``model`` of the tensor-parallel layers under ``model_`` names.
"""
from __future__ import annotations

import contextlib
import math
from collections import Counter
from typing import Optional

import torch
import torch.distributed as dist

_ACTIVE: list = []
_TP: list = []
_ROWS: list = []

_LOGICAL = {
    "batch": ("pod", "data"),
    "tp": ("model",),
    "seq": ("data",),
    "expert": ("model",),
    "rows": ("pod", "data", "model"),  # tabular serving: rows over everything
}

# host-staged collectives by name ("all_reduce", "all_gather",
# "reduce_scatter"; "model_all_reduce", "model_all_gather",
# "model_reduce_scatter" and "model_all_to_all" for the tensor-parallel
# layers' collectives over ``model``) in this process, and the bytes each
# name brought back to the card (its results'); read by the smoke run,
# reset by the caller
STAGED: Counter = Counter()
STAGED_BYTES: Counter = Counter()
# the mesh axes a batch splits over (pure data parallelism over pods, FSDP
# over data); every other axis sees the same rows
BATCH_AXES = ("pod", "data")


class P(tuple):
    """A partition spec: ``P(None, "data", ("pod", "data"))``, a tuple of
    its entries (``PartitionSpec``'s counterpart).  As there, an entry of
    one axis is that axis's name and an empty entry is ``None``."""

    def __new__(cls, *entries):
        def canonical(e):
            if isinstance(e, (tuple, list)):
                return None if not e else e[0] if len(e) == 1 else tuple(e)
            return e

        return super().__new__(cls, (canonical(e) for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


class Mesh:
    """A ``torch.distributed.device_mesh.DeviceMesh`` with named axes.

    ``shape`` maps each axis name to its size, in mesh order, as a JAX
    mesh's ``shape`` does, so the sharding rules read a ``Mesh`` and a
    duck-typed mesh alike.  A mesh that made its process's group (a world
    of one, ``launch.mesh.compat_make_mesh``) destroys it in ``close``;
    ``with mesh:`` closes it on exit.
    """

    def __init__(self, device_mesh, *, owns_world: bool = False):
        self.device_mesh = device_mesh
        self.axis_names = tuple(device_mesh.mesh_dim_names)
        self.shape = {a: int(n) for a, n in zip(self.axis_names, device_mesh.mesh.shape)}
        self.device_type = device_mesh.device_type
        self._owns_world = owns_world

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def axis_index(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        return self.device_mesh.get_local_rank(mesh_dim=axis)

    def group(self, axis: str):
        """The process group of the ranks that differ from this one only
        along ``axis``."""
        return self.device_mesh.get_group(mesh_dim=axis)

    def close(self) -> None:
        if self._owns_world and dist.is_initialized():
            dist.destroy_process_group()
        self._owns_world = False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {self.device_type})"


@contextlib.contextmanager
def use_mesh(mesh: Optional[Mesh]):
    _ACTIVE.append(mesh)
    try:
        yield
    finally:
        _ACTIVE.pop()


def current_mesh() -> Optional[Mesh]:
    return _ACTIVE[-1] if _ACTIVE else None


@contextlib.contextmanager
def use_tp(mesh: Optional[Mesh]):
    """The mesh whose ``model`` axis the layers split their work over,
    where their weights come as ``model`` blocks (``Block.model_block``).
    The model's entry points set it when they are handed ``Block``s."""
    _TP.append(mesh)
    try:
        yield
    finally:
        _TP.pop()


def tp_mesh() -> Optional[Mesh]:
    """The ``use_tp`` mesh, where its ``model`` axis has more than one
    rank; else None (the layers then run whole)."""
    mesh = _TP[-1] if _TP else None
    return mesh if mesh is not None and mesh.shape.get("model", 1) > 1 else None


@contextlib.contextmanager
def use_rows(mesh: Optional[Mesh], axes: tuple = ()):
    """The batch the model is given is this rank's share of the rows, split
    over the mesh ``axes`` (the batch axes ``rules.batch_pspec`` gives): the
    serving entry points set it when they run on each rank's rows.  A layer
    whose result depends on the other ranks' rows (the MoE's capacity and
    slots) reads it (``rows_split``)."""
    _ROWS.append((mesh, tuple(axes)) if mesh is not None else None)
    try:
        yield
    finally:
        _ROWS.pop()


def rows_split() -> Optional[tuple]:
    """(mesh, axes) of the ``use_rows`` split, or None where the model has
    the whole batch."""
    return _ROWS[-1] if _ROWS else None


def rows_index(mesh: Mesh, axes: tuple) -> int:
    """This rank's position among the ranks that split the rows over
    ``axes`` (the first axis the most significant, as in a spec entry)."""
    idx = 0
    for a in axes:
        idx = idx * mesh.shape[a] + mesh.axis_index(a)
    return idx


def gather_rows(x: torch.Tensor, mesh: Mesh, axes: tuple, dim: int = 0) -> torch.Tensor:
    """Every rank's rows ``x`` along ``dim``, concatenated in the order of
    ``rows_index`` (no gradient): the whole batch from each rank's rows."""
    return _gather_local(x, P(*([None] * dim), tuple(axes)), mesh)


def is_trivial(mesh) -> bool:
    """No mesh, or one whose every axis has size 1 (the local path runs)."""
    return mesh is None or all(n <= 1 for n in mesh.shape.values())


# ---------------------------------------------------------------------------
# specs and placements
# ---------------------------------------------------------------------------

def entry_axes(entry) -> tuple:
    """The mesh axes of one spec entry, most significant first."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def resolve(mesh, shape, logical) -> tuple:
    """The spec of logical names ``logical`` for a tensor of ``shape`` on
    ``mesh``: each name's axes kept while the dimension divides their
    running product (the reference's ``constrain`` rule)."""
    spec = []
    for dim, item in zip(shape, logical):
        if item is None:
            spec.append(None)
            continue
        axes, total = [], 1
        for ax in _LOGICAL.get(item, (item,)):
            size = mesh.shape.get(ax, 1)
            if size > 1 and dim % (total * size) == 0:
                axes.append(ax)
                total *= size
        spec.append(tuple(axes) if len(axes) > 1 else (axes[0] if axes else None))
    return P(*spec)


def placements(mesh: Mesh, spec) -> tuple:
    """DTensor placements of ``spec``, one per mesh axis: ``Shard(d)`` where
    the axis shards dimension d, else ``Replicate()``.  Two axes on one
    dimension shard it in mesh order (the outer axis the most significant),
    which is the order a spec entry must list them in."""
    from torch.distributed.tensor import Replicate, Shard

    out = {a: Replicate() for a in mesh.axis_names}
    for d, entry in enumerate(spec):
        axes = entry_axes(entry)
        order = [mesh.axis_names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(f"spec entry {entry!r} lists mesh axes out of the mesh's order "
                             f"{mesh.axis_names}")
        for a in axes:
            out[a] = Shard(d)
    return tuple(out[a] for a in mesh.axis_names)


def local_shape(shape, mesh, spec) -> tuple:
    """The shape of one rank's block of a ``shape`` tensor under ``spec``."""
    out = list(shape)
    for d, entry in enumerate(spec):
        n = math.prod(mesh.shape[a] for a in entry_axes(entry))
        if out[d] % n:
            raise ValueError(f"dimension {d} of {tuple(shape)} does not split over {entry!r}")
        out[d] //= n
    return tuple(out)


def local_block(x: torch.Tensor, mesh: Mesh, spec) -> torch.Tensor:
    """This rank's block of the global tensor ``x`` under ``spec`` (a view;
    no communication).  Each sharded dimension must divide evenly."""
    for d, entry in enumerate(spec):
        axes = entry_axes(entry)
        if not axes:
            continue
        n = math.prod(mesh.shape[a] for a in axes)
        if x.shape[d] % n:
            raise ValueError(f"dimension {d} of {tuple(x.shape)} does not split over "
                             f"{axes} ({n} shards)")
        idx = 0
        for a in axes:
            idx = idx * mesh.shape[a] + mesh.axis_index(a)
        size = x.shape[d] // n
        x = x.narrow(d, idx * size, size)
    return x


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

_SIGNED = {torch.uint16: torch.int16, torch.uint32: torch.int32, torch.uint64: torch.int64}


def _staged(t: torch.Tensor, group) -> bool:
    return t.is_cuda and "nccl" not in str(dist.get_backend(group))


def _collective(name: str, t: torch.Tensor, group, *, tag: str = "", **kw):
    """``all_reduce`` (``op=``), ``reduce_scatter`` (the sum, this rank's
    share of dimension 0), ``all_gather`` (every rank's tensor in rank
    order, concatenated along ``dim=``) or ``all_to_all`` (``t`` cut along
    ``dim=`` into ``send=`` sizes, the i-th to rank i; the pieces received,
    ``recv=`` sizes, concatenated in rank order) of ``t`` over ``group``, on
    a copy.  A CUDA tensor on a group without NCCL is staged through the
    host and counted in ``STAGED`` (and its result's bytes in
    ``STAGED_BYTES``) under ``tag`` + ``name``."""
    staged = _staged(t, group)
    out = _run_collective(name, t, group, staged, **kw)
    if staged:
        STAGED[tag + name] += 1
        STAGED_BYTES[tag + name] += out.numel() * out.element_size()
    return out


def _run_collective(name: str, t: torch.Tensor, group, staged: bool, **kw):
    if name == "all_reduce":
        work = t.detach().to("cpu", copy=True) if staged else t.detach().clone()
        dist.all_reduce(work, op=kw["op"], group=group)
        return work.to(t.device) if staged else work
    if name == "reduce_scatter":
        work = (t.detach().cpu() if staged else t.detach()).contiguous()
        n = dist.get_world_size(group)
        out = work.new_empty((work.shape[0] // n,) + tuple(work.shape[1:]))
        # torch 2.13 renames the single-tensor collectives; the card's 2.11
        # has only the old names
        getattr(dist, "reduce_scatter_single", dist.reduce_scatter_tensor)(out, work,
                                                                           group=group)
        return out.to(t.device) if staged else out
    if name == "all_to_all":
        dim, send, recv = kw["dim"], list(kw["send"]), list(kw["recv"])
        work = (t.detach().cpu() if staged else t.detach()).movedim(dim, 0).contiguous()
        out = work.new_empty((sum(recv),) + tuple(work.shape[1:]))
        dist.all_to_all_single(out, work, recv, send, group=group)
        return out.movedim(0, dim).contiguous().to(t.device)
    # gloo has no unsigned type wider than a byte: gather the bits as the
    # signed type of their width
    dim = kw["dim"]
    work = (t.detach().cpu() if staged else t.detach()).movedim(dim, 0).contiguous()
    work = work.view(_SIGNED.get(work.dtype, work.dtype))
    out = work.new_empty((work.shape[0] * dist.get_world_size(group),) + tuple(work.shape[1:]))
    getattr(dist, "all_gather_single", dist.all_gather_into_tensor)(out, work, group=group)
    return out.view(t.dtype).movedim(0, dim).contiguous().to(t.device)


def _reduce(x, axes, op, mesh):
    mesh = mesh or current_mesh()
    for a in entry_axes(axes):
        if mesh.shape.get(a, 1) > 1:
            x = _collective("all_reduce", x, mesh.group(a), op=op)
    return x


def psum(x, axes, mesh: Optional[Mesh] = None):
    """The sum of ``x`` over the ranks along mesh ``axes`` (``lax.psum``)."""
    return _reduce(x, axes, dist.ReduceOp.SUM, mesh)


def pmax(x, axes, mesh: Optional[Mesh] = None):
    """The elementwise max of ``x`` over mesh ``axes`` (``lax.pmax``)."""
    return _reduce(x, axes, dist.ReduceOp.MAX, mesh)


def pmean(x, axes, mesh: Optional[Mesh] = None):
    """The mean of ``x`` over mesh ``axes`` (``lax.pmean``)."""
    mesh = mesh or current_mesh()
    n = math.prod(mesh.shape.get(a, 1) for a in entry_axes(axes))
    return psum(x, axes, mesh) / n


def axis_index(axis: str, mesh: Optional[Mesh] = None) -> int:
    """This rank's coordinate along ``axis`` (``lax.axis_index``)."""
    return (mesh or current_mesh()).axis_index(axis)


def gather(x) -> torch.Tensor:
    """A ``DTensor`` as a plain global tensor, gathered along every sharded
    mesh axis, the innermost first; a plain tensor as it is."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(x, DTensor):
        return x
    dm = x.device_mesh
    out = x.to_local()
    for i in reversed(range(dm.ndim)):
        p = x.placements[i]
        if isinstance(p, Shard):
            out = _collective("all_gather", out, dm.get_group(i), dim=p.dim)
        elif not isinstance(p, Replicate):
            raise ValueError(f"cannot gather a DTensor placed {x.placements}")
    return out


def to_local(x, mesh: Mesh, spec) -> torch.Tensor:
    """This rank's block of ``x`` under ``spec``: a plain global tensor is
    cut (no communication), a ``DTensor`` or ``Block`` already placed so
    gives its local tensor, any other is gathered and cut."""
    from torch.distributed.tensor import DTensor

    if isinstance(x, Block):
        if x.spec == P(*spec) and x.mesh is mesh:
            return x.local
        x = x.whole()
    if isinstance(x, DTensor):
        if tuple(x.placements) == placements(mesh, spec):
            return x.to_local()
        x = gather(x)
    return local_block(x, mesh, spec)


def from_local(x: torch.Tensor, mesh: Mesh, spec):
    """A ``DTensor`` of this rank's block ``x`` placed by ``spec`` (every
    rank's block of one shape; no communication)."""
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(x, mesh.device_mesh, placements(mesh, spec), run_check=False)


def _tree(fn, tree, spec):
    if isinstance(tree, dict):
        return {k: _tree(fn, v, spec) for k, v in tree.items()}
    return fn(tree, spec) if torch.is_tensor(tree) or isinstance(tree, Block) else tree


def _out_tree(fn, tree, spec):
    if not isinstance(spec, P):  # a tuple of specs for a tuple of outputs
        return tuple(_out_tree(fn, t, s) for t, s in zip(tree, spec))
    return _tree(fn, tree, spec)


def shard_map(f, *, mesh: Mesh, in_specs: tuple, out_specs):
    """``compat_shard_map``'s counterpart: ``f`` runs on each rank's blocks.

    ``in_specs`` holds one ``P`` per argument, applied to every tensor of a
    dict argument; other arguments (Python scalars) pass as they are.
    ``out_specs`` is one ``P``, or a tuple of them for a tuple of outputs;
    the outputs come back as ``DTensor``s (``from_local``).  Blocks are cut
    by ``to_local``: no communication for plain tensors or for ``DTensor``s
    already placed by their spec.
    """
    def run(*args):
        if len(args) != len(in_specs):
            raise TypeError(f"{len(args)} arguments for {len(in_specs)} in_specs")
        blocks = [_tree(lambda t, s: to_local(t, mesh, s), a, s)
                  for a, s in zip(args, in_specs)]
        out = f(*blocks)
        return _out_tree(lambda t, s: from_local(t, mesh, s), out, out_specs)

    return run


def constrain(x, *logical):
    """Place a ``DTensor`` by logical names; a plain tensor, or any tensor
    outside a mesh, is returned as it is."""
    from torch.distributed.tensor import DTensor

    mesh = current_mesh()
    if mesh is None or not isinstance(x, DTensor):
        return x
    spec = resolve(mesh, x.shape, logical)  # trailing unlisted dims replicate
    if tuple(x.placements) == placements(mesh, spec):
        return x
    return from_local(local_block(gather(x), mesh, spec), mesh, spec)


# ---------------------------------------------------------------------------
# tensor parallelism: autograd-aware collectives over ``model``
# ---------------------------------------------------------------------------
#
# Between layers an activation is held alike by every ``model`` rank, and so
# is its gradient.  A layer's share on one rank starts where such a value
# enters work that differs by rank (``copy_to_model``: the backward sums the
# ranks' gradients) and ends where the ranks' shares are summed
# (``reduce_from_model``) or concatenated (``gather_from_model``) into a
# value held alike again.

def sum_over_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of ``x`` over ``model`` (no gradient)."""
    return _collective("all_reduce", x, mesh.group("model"), tag="model_",
                       op=dist.ReduceOp.SUM)


class _CopyToModel(torch.autograd.Function):
    """Forward: the value as it is.  Backward: the ``model`` ranks'
    gradients summed (each rank's share used the value differently), in
    float32 and rounded once to the gradient's type."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return sum_over_model(grad.float(), ctx.mesh).to(grad.dtype), None


class _ReduceFromModel(torch.autograd.Function):
    """Forward: the ``model`` ranks' partial values summed.  Backward: the
    gradient, held alike, reaches each rank's part as it is."""

    @staticmethod
    def forward(ctx, x, mesh):
        return sum_over_model(x, mesh)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFromModel(torch.autograd.Function):
    """Forward: the ``model`` ranks' pieces concatenated along ``dim``.
    Backward: this rank's piece of the gradient (held alike), or
    (``summed``: each rank's gradient is its own) this rank's piece of the
    ranks' float32 gradients summed, rounded once to the gradient's type
    (a reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, dim, mesh, summed):
        ctx.dim, ctx.mesh, ctx.summed = dim, mesh, summed
        return _collective("all_gather", x, mesh.group("model"), tag="model_", dim=dim)

    @staticmethod
    def backward(ctx, grad):
        if ctx.summed:
            piece = _collective("reduce_scatter", grad.float().movedim(ctx.dim, 0),
                                ctx.mesh.group("model"), tag="model_")
            return piece.movedim(0, ctx.dim).to(grad.dtype).contiguous(), None, None, None
        n = grad.shape[ctx.dim] // ctx.mesh.shape["model"]
        piece = grad.narrow(ctx.dim, ctx.mesh.axis_index("model") * n, n)
        return piece.contiguous(), None, None, None


def max_over_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The elementwise max of ``x`` over ``model`` (no gradient)."""
    return _collective("all_reduce", x, mesh.group("model"), tag="model_", op=dist.ReduceOp.MAX)


def copy_to_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``x``, held alike by the ``model`` ranks, as the input of work that
    differs by rank (a column-parallel matmul): the backward all-reduces
    its gradient over ``model``."""
    return _CopyToModel.apply(x, mesh)


def reduce_from_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum over ``model`` of each rank's partial ``x`` (a row-parallel
    matmul's output): an all-reduce forward, the identity backward."""
    return _ReduceFromModel.apply(x, mesh)


def gather_from_model(x: torch.Tensor, dim: int, mesh: Mesh, *,
                      summed: bool = False) -> torch.Tensor:
    """Each ``model`` rank's piece ``x`` concatenated along ``dim`` in rank
    order: an all-gather forward, this rank's piece of the gradient
    backward; with ``summed`` (the ranks use the whole differently) of the
    ranks' gradients summed (a reduce-scatter)."""
    return _GatherFromModel.apply(x, dim, mesh, summed)


# ---------------------------------------------------------------------------
# blocks: one rank's share of a parameter, gathered a layer at a time
# ---------------------------------------------------------------------------

def _block_entries(spec) -> list:
    """[(dimension, its mesh axes, most significant first)] of a spec's
    sharded dimensions."""
    return [(d, entry_axes(e)) for d, e in enumerate(spec) if entry_axes(e)]


def _gather_local(local: torch.Tensor, spec, mesh: Mesh, axes=None) -> torch.Tensor:
    """The block gathered along the mesh axes of its spec (only those in
    ``axes``, where given)."""
    out = local
    for d, dim_axes in _block_entries(spec):
        for a in reversed(dim_axes):  # the innermost axis first
            if mesh.shape[a] > 1 and (axes is None or a in axes):
                out = _collective("all_gather", out, mesh.group(a), dim=d)
    return out.clone() if out is local else out


def _reduce_to_block(grad: torch.Tensor, spec, mesh: Mesh, whole: bool = True,
                     sum_over_model: bool = False) -> torch.Tensor:
    """The gradient of the gathered tensor on this rank's rows -> its sum
    over the batch axes, this rank's block.  For a tensor gathered whole
    (``whole``), ranks along a non-batch axis (``model``) computed the same
    gradient, so their share is cut, not summed; with ``sum_over_model``
    they computed different parts of it, so it is summed over ``model``
    first (reduce-scattered into the block, or all-reduced where the spec
    leaves ``model`` out).  A ``model`` block's gradient is already this
    rank's share."""
    dims = {}
    for d, axes in _block_entries(spec):
        if len(axes) > 1:
            raise ValueError(f"a parameter's dimension is sharded over one mesh axis, "
                             f"not {axes}")
        dims[axes[0]] = d
    g = grad
    if whole and sum_over_model and mesh.shape.get("model", 1) > 1:
        group = mesh.group("model")
        if "model" in dims:
            d = dims.pop("model")
            g = _collective("reduce_scatter", g.movedim(d, 0), group,
                            tag="model_").movedim(0, d)
        else:
            g = _collective("all_reduce", g, group, tag="model_", op=dist.ReduceOp.SUM)
    for a, d in dims.items():
        if whole and a not in BATCH_AXES and mesh.shape[a] > 1:
            size = g.shape[d] // mesh.shape[a]
            g = g.narrow(d, mesh.axis_index(a) * size, size)
    for a in BATCH_AXES:
        if mesh.shape.get(a, 1) <= 1:
            continue
        if a in dims:  # sharded along a: each rank keeps the sum of its share
            d = dims[a]
            g = _collective("reduce_scatter", g.movedim(d, 0), mesh.group(a)).movedim(0, d)
        else:  # replicated along a (a dimension that does not divide): the whole sum
            g = _collective("all_reduce", g, mesh.group(a), op=dist.ReduceOp.SUM)
    return g.contiguous()


def _pieces_plan(table, size: int, n: int) -> list:
    """``plan[r][s]``: the (start in rank r's block, length) ranges that
    ``model`` rank r holds of the pieces ``table[s]`` ((start, length), ...)
    that rank s takes of a dimension of ``size`` cut into n contiguous
    blocks, in s's order.  Each rank's pieces ascend and do not overlap, so
    the ranges it receives, concatenated in rank order, are its pieces in
    order."""
    m = size // n
    plan = [[[] for _ in range(n)] for _ in range(n)]
    for s, pieces in enumerate(table):
        end = 0
        for start, length in pieces:
            if start < end:
                raise ValueError(f"model rank {s}'s pieces {pieces} do not ascend")
            end = start + length
            while length:
                r = start // m
                take = min(length, (r + 1) * m - start)
                plan[r][s].append((start - r * m, take))
                start, length = start + take, length - take
    return plan


def _plan_of(spec, mesh: Mesh, dim: int, table, block: int):
    """(the ``model`` size, this rank's index along it, the exchange's
    ``_pieces_plan`` for ``model`` blocks of ``block`` entries along
    ``dim``, which ``spec`` must split over ``model``)."""
    if [d for d, axes in _block_entries(spec) if "model" in axes] != [dim]:
        raise ValueError(f"pieces along dimension {dim} of a block placed {spec}: only the "
                         f"dimension split over model is taken in pieces")
    n = mesh.shape["model"]
    return n, mesh.axis_index("model"), _pieces_plan(table, block * n, n)


def _take_pieces(t: torch.Tensor, spec, mesh: Mesh, dim: int, table) -> torch.Tensor:
    """This rank's pieces ``table[model index]`` of ``t`` (its ``model``
    block, gathered over the batch axes) along ``dim``, each from the
    ``model`` rank whose block holds it: one all-to-all."""
    n, me, plan = _plan_of(spec, mesh, dim, table, t.shape[dim])
    parts = [t.narrow(dim, a, l) for s in range(n) for a, l in plan[me][s]]
    send = [sum(l for _, l in plan[me][s]) for s in range(n)]
    recv = [sum(l for _, l in plan[r][me]) for r in range(n)]
    return _collective("all_to_all", torch.cat(parts, dim) if parts else t.narrow(dim, 0, 0),
                       mesh.group("model"), tag="model_", dim=dim, send=send, recv=recv)


def _pieces_grad(grad: torch.Tensor, shape, spec, mesh: Mesh, dim: int, table) -> torch.Tensor:
    """``_take_pieces``' backward: the gradient of this rank's pieces ->
    that of its ``model`` block (``shape``), each piece's gradient sent
    back to the rank whose block holds it (the reverse all-to-all)."""
    n, me, plan = _plan_of(spec, mesh, dim, table, shape[dim])
    send = [sum(l for _, l in plan[me][s]) for s in range(n)]
    recv = [sum(l for _, l in plan[r][me]) for r in range(n)]
    got = _collective("all_to_all", grad, mesh.group("model"), tag="model_", dim=dim,
                      send=recv, recv=send)
    g, off = grad.new_zeros(shape), 0
    for ranges in plan[me]:
        for a, l in ranges:
            g.narrow(dim, a, l).add_(got.narrow(dim, off, l))
            off += l
    return g


class _GatherBlock(torch.autograd.Function):
    """Forward: the whole tensor from every rank's block, or (``whole``
    False) its ``model`` block, gathered over the batch axes only, or
    (``pieces``) this rank's pieces of it (``_take_pieces``).  Backward:
    the gradient reduced to this rank's block (``_reduce_to_block``, after
    ``_pieces_grad``).  Nothing is saved, so under
    ``torch.utils.checkpoint`` the gather runs again in the backward pass,
    and a tensor gathered once serves several backward passes
    (microbatches)."""

    @staticmethod
    def forward(ctx, local, spec, mesh, whole, sum_over_model, pieces):
        ctx.spec, ctx.mesh, ctx.whole, ctx.sum_over_model = spec, mesh, whole, sum_over_model
        ctx.pieces = pieces
        t = _gather_local(local, spec, mesh, None if whole else BATCH_AXES)
        if pieces is None:
            return t
        ctx.shape = tuple(t.shape)
        return _take_pieces(t, spec, mesh, *pieces)

    @staticmethod
    def backward(ctx, grad):
        if ctx.pieces is not None:
            grad = _pieces_grad(grad, ctx.shape, ctx.spec, ctx.mesh, *ctx.pieces)
        g = _reduce_to_block(grad, ctx.spec, ctx.mesh, ctx.whole, ctx.sum_over_model)
        return g, None, None, None, None, None


def gather_block(local: torch.Tensor, spec, mesh: Mesh, *, whole: bool = True,
                 sum_over_model: bool = False, pieces=None) -> torch.Tensor:
    """The whole tensor whose block on this rank is ``local`` under
    ``spec`` (or, ``whole`` False, its ``model`` block: gathered over the
    batch axes only; with ``pieces``, (dim, table), this rank's pieces
    ``table[model index]`` of it along dim); its gradient flows back to
    ``local`` summed over the batch axes, and with ``sum_over_model`` over
    ``model`` too (the ``model`` ranks used different parts of the whole
    tensor)."""
    return _GatherBlock.apply(local, spec, mesh, whole, sum_over_model, pieces)


class Block:
    """This rank's block (``local``) of a global tensor under ``spec`` on
    ``mesh``.  A stacked leaf's leading (layer) dimension is never sharded:
    ``block[l]`` and ``block.unbind(0)`` give layer blocks with no
    communication, ``whole()`` gathers one (``gather_block``; with
    ``sum_over_model`` its backward sums the ``model`` ranks' gradients),
    ``model_block()`` gathers it over the batch axes only, and
    ``block[l] = value`` / ``put`` write this rank's share of a global
    value (a cache's layer, or positions of one)."""

    __slots__ = ("local", "spec", "mesh")

    def __init__(self, local: torch.Tensor, spec, mesh: Mesh):
        self.local, self.spec, self.mesh = local, P(*spec), mesh

    @property
    def shape(self) -> torch.Size:
        shape = list(self.local.shape)
        for d, axes in _block_entries(self.spec):
            shape[d] *= math.prod(self.mesh.shape[a] for a in axes)
        return torch.Size(shape)

    @property
    def dtype(self):
        return self.local.dtype

    def _inner(self) -> P:
        if entry_axes(self.spec[0] if self.spec else None):
            raise ValueError(f"the leading dimension of a Block placed {self.spec} is sharded")
        return P(*self.spec[1:])

    def __getitem__(self, i: int) -> "Block":
        return Block(self.local[i], self._inner(), self.mesh)

    def __setitem__(self, i: int, value: torch.Tensor) -> None:
        self.local[i] = local_block(value, self.mesh, self._inner())

    def unbind(self, dim: int = 0) -> tuple:
        if dim:
            raise ValueError("a Block unbinds its leading dimension only")
        inner = self._inner()
        return tuple(Block(t, inner, self.mesh) for t in self.local.unbind(0))

    def whole(self, *, sum_over_model: bool = False) -> torch.Tensor:
        return gather_block(self.local, self.spec, self.mesh, sum_over_model=sum_over_model)

    def model_block(self) -> torch.Tensor:
        """This rank's ``model`` block of the tensor: whole along every
        dimension but the one its spec splits over ``model``."""
        return gather_block(self.local, self.spec, self.mesh, whole=False)

    def model_pieces(self, dim: int, table) -> torch.Tensor:
        """This rank's pieces ``table[r]`` ((start, length), ..., ascending;
        r its ``model`` index) of the tensor along ``dim``, the dimension
        its spec splits over ``model``, concatenated, whole along every
        other dimension: gathered over the batch axes, each piece from the
        ``model`` rank whose block holds it.  ``table`` lists every
        ``model`` rank's pieces, which do not overlap; each piece's gradient
        goes back to its block."""
        return gather_block(self.local, self.spec, self.mesh, whole=False, pieces=(dim, table))

    def put(self, dim: int, start: int, value: torch.Tensor) -> None:
        """Write ``value``, global along every dimension but ``dim``, where
        it covers [start, start + value.shape[dim]), into this block: its
        share of the other dimensions, the positions that fall inside this
        rank's range of ``dim``."""
        spec = P(*(None if d == dim else e for d, e in enumerate(self.spec)))
        value = local_block(value, self.mesh, spec)
        n = self.local.shape[dim]
        idx = 0
        for a in entry_axes(self.spec[dim] if dim < len(self.spec) else None):
            idx = idx * self.mesh.shape[a] + self.mesh.axis_index(a)
        lo = idx * n
        a, b = max(start, lo), min(start + value.shape[dim], lo + n)
        if a < b:
            self.local.narrow(dim, a - lo, b - a).copy_(value.narrow(dim, a - start, b - a))


def blocks(tree, shardings):
    """Each leaf of ``tree`` (``DTensor``s placed by ``shardings``, or plain
    local tensors) as a ``Block`` of its local tensor under its
    ``NamedSharding``'s spec."""
    from torch.distributed.tensor import DTensor

    if isinstance(tree, dict):
        return {k: blocks(v, shardings[k]) for k, v in tree.items()}
    with torch.no_grad():  # the DTensor's own local tensor, not a view
        local = tree.to_local() if isinstance(tree, DTensor) else tree
    return Block(local, shardings.spec, shardings.mesh)
