"""The SSM's split over ``model`` (fault F): the columns and channels each
``model`` rank takes (``ssm.in_columns``, ``ssm.conv_channels``) and the
gather that brings them from the ranks whose blocks hold them
(``sharding.ops.Block.model_pieces``), on the CPU.  The split against the
reference's compiled program is held in ``tests/test_torch_dryrun.py``, and
the split layers bit for bit against the split control in
``tests/test_torch_mesh.py``.

Tolerances: none; a gather moves values and a piece's gradient is the one
rank's that used it, summed over ``data`` (float32 sums of two, exact as
numpy's)."""
import numpy as np
import pytest

from repro_torch.configs import get_config, smoke_config
from repro_torch.models import ssm
from torch_dist_ranks import PIECES_CASES, pieces_rank, pieces_weight, run_ranks

ARCHS = ("mamba2-370m", "zamba2-2.7b")


def _dims(cfg) -> dict:
    return dict(d_model=cfg.d_model, expand=cfg.ssm_expand, state=cfg.ssm_state)


# (arch, full or smoke config, a model axis its SSM splits over)
SPLITS = [(a, "full", n) for a in ARCHS for n in (2, 4, 8, 16)] + \
    [(a, "smoke", n) for a in ARCHS for n in (2, 4)]


@pytest.mark.parametrize("arch,config,n", SPLITS)
def test_ranks_take_each_column_and_channel_once(arch, config, n):
    """On a ``model`` axis of ``n`` that the layer splits over, the ranks'
    pieces of ``w_in`` (its heads' z, x and dt columns and a share of B's
    and C's) and of ``conv_w`` (x, B and C channels) ascend, are each an
    ``n``-th of the whole, and together take every column and channel
    once, as the reference's compiled program splits them (274 of
    mamba2-370m's 4,384 columns a device on 16)."""
    dims = _dims((get_config if config == "full" else smoke_config)(arch))
    assert ssm.splits_over(n, **dims)
    d_inner, h, conv_dim = ssm.ssm_dims(**dims)
    width = 2 * d_inner + 2 * dims["state"] + h
    for pieces, total in ((ssm.in_columns, width), (ssm.conv_channels, conv_dim)):
        taken = []
        for r in range(n):
            ranges = pieces(r, n, **dims)
            starts = [a for a, _ in ranges]
            assert starts == sorted(starts)
            assert sum(l for _, l in ranges) * n == total
            taken += [c for a, l in ranges for c in range(a, a + l)]
        assert sorted(taken) == list(range(total))
    if (arch, config, n) == ("mamba2-370m", "full", 16):
        assert sum(l for _, l in ssm.in_columns(0, n, **dims)) == 274


@pytest.fixture(scope="module")
def pieces(tmp_path_factory):
    out = tmp_path_factory.mktemp("pieces")
    run_ranks(pieces_rank, 4, str(out))
    return [dict(np.load(out / f"pieces_{r}.npz")) for r in range(4)]


@pytest.mark.parametrize("case", list(PIECES_CASES))
def test_model_pieces_gathers_each_rank_its_pieces(case, pieces):
    """``Block.model_pieces`` on four gloo ranks, (data 2, model 2): each
    rank gets its pieces of the whole tensor from the blocks split over
    ``model`` along their dimension (an all-to-all), and its block's
    gradient is that block of the whole's gradient: each rank's pieces'
    gradients summed over the ranks (over ``data``; the ``model`` ranks'
    pieces do not overlap)."""
    shape, spec, dim, table = PIECES_CASES[case]
    whole = np.random.default_rng(5).normal(size=shape).astype(np.float32)
    grad = np.zeros(shape, np.float32)
    for r, got in enumerate(pieces):
        cols = [c for a, l in table[int(got[f"{case}_model"])] for c in range(a, a + l)]
        np.testing.assert_array_equal(got[f"{case}_got"], np.take(whole, cols, axis=dim))
        weight = pieces_weight(shape, dim, len(cols), r)
        np.add.at(grad, (slice(None),) * dim + (cols,), weight)
    for got in pieces:
        index = []
        for d, entry in enumerate(spec):
            axis = {"data": f"{case}_data", "model": f"{case}_model"}.get(entry)
            size = shape[d] // 2 if axis else shape[d]
            start = int(got[axis]) * size if axis else 0
            index.append(slice(start, start + size))
        np.testing.assert_array_equal(got[f"{case}_grad"], grad[tuple(index)])
