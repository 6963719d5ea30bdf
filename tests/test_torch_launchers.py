"""The port's drivers on the CPU (``--device cpu``), at the sizes of the
reference's ``tests/test_launchers.py``: ``repro_torch.launch.serve``'s
``--trees``, ``--trees --gateway`` and LM modes beside the JAX driver's, the
two examples, ``tree_serve_step`` bit for bit against the JAX one, and the
drivers raising without a card unless asked for the CPU."""
import re
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

TREES_ARGS = ["--trees", "--rows", "4000", "--n-trees", "8", "--depth", "5", "--reps", "1"]
GATEWAY_ARGS = ["--trees", "--gateway", "--rows", "3000", "--gw-requests", "60",
                "--gw-rate", "600", "--gw-batch-rows", "16"]
LM_ARGS = ["--arch", "granite-3-2b", "--smoke", "--batch", "2", "--prompt", "16",
           "--tokens", "4"]
ROW = re.compile(r"^(\S+)\s+acc=(\S+) agree_with_float=(\S+)", re.M)


def _rows(out: str) -> dict:
    return {name.replace("integer-pallas", "integer-cuda"): (acc, agree)
            for name, acc, agree in ROW.findall(out)}


def test_serve_driver_trees_matches_jax(capsys):
    from repro.launch.serve import main as jax_main
    from repro_torch.launch.serve import main

    main(TREES_ARGS + ["--device", "cpu"])
    got = _rows(capsys.readouterr().out)
    jax_main(TREES_ARGS)
    want = _rows(capsys.readouterr().out)
    # float (self), flint, integer, integer-leafmajor, integer-cuda — plus
    # the two native-C flavors (if-else + table-walk) when gcc exists
    expected = 7 if shutil.which("gcc") else 5
    assert len(got) == expected
    assert all(agree == "1.000000" for _, agree in got.values())
    for name in ("integer", "integer-leafmajor", "integer-cuda", "integer-c-table"):
        if name in want:
            assert got[name] == want[name], name
    assert got == want


def test_serve_driver_gateway(capsys):
    from repro_torch.launch.serve import main

    main(GATEWAY_ARGS + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert "gateway == direct engine (bit-identical): True" in out
    assert "hot-swapped shuttle-rf -> v2" in out
    assert "hit_rate" in out and "queue_ms" in out  # metrics table rendered


def test_serve_driver_gateway_on_the_cuda_route(capsys):
    """``--gw-spec integer:cuda`` (K1's and K2's plain versions here)."""
    from repro_torch.launch.serve import main

    main(GATEWAY_ARGS + ["--gw-spec", "integer:cuda", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "gateway route: integer:cuda" in out
    assert "gateway == direct engine (bit-identical): True" in out


def test_serve_driver_lm(capsys):
    from repro_torch.launch.serve import main

    main(LM_ARGS + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert "generated (2, 4) tokens" in out
    assert "peak device memory: not measured on cpu" in out


def test_serve_driver_lm_encoder_only_raises_like_jax():
    from repro_torch.launch.serve import main

    with pytest.raises(KeyError, match="embed"):
        main(["--arch", "hubert-xlarge", "--smoke", "--batch", "2", "--prompt", "8",
              "--tokens", "2", "--device", "cpu"])


@pytest.mark.parametrize("argv", [TREES_ARGS, GATEWAY_ARGS, LM_ARGS])
def test_serve_driver_needs_a_card_unless_asked_for_the_cpu(argv, monkeypatch):
    from repro_torch.launch.serve import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(argv)


def test_quickstart_example(capsys, tmp_path):
    from repro_torch.examples.quickstart import main

    out_c = tmp_path / "model.c"
    main(["--device", "cpu", "--out", str(out_c)])
    out = capsys.readouterr().out
    assert "float == flint == integer predictions on every test row (on cpu)" in out
    assert "bit-identical uint32 scores across" in out and "cuda/leaf_major" in out
    assert out_c.read_text().count("\n") > 100


def test_serve_trees_scaled_example(capsys):
    from repro_torch.examples.serve_trees_scaled import main

    main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "integer+cuda" in out
    assert "tree_serve_step (one cpu device) matches: 10000 rows" in out


def test_tree_serve_step_bit_identical_to_jax(small_packed, shuttle_small):
    from repro.core.flint import float_to_key as jax_float_to_key
    from repro.core.serving import tree_serve_step as jax_tree_serve_step
    from repro_torch.core.flint import float_to_key
    from repro_torch.core.serving import tree_serve_step

    _, _, Xte, _ = shuttle_small
    names = ("feature", "threshold_key", "left", "right", "leaf_fixed")
    tables = {k: getattr(small_packed, k) for k in names}
    acc_j, preds_j = jax_tree_serve_step({k: jnp.asarray(v) for k, v in tables.items()},
                                         jax_float_to_key(jnp.asarray(Xte)),
                                         small_packed.max_depth)
    acc_t, preds_t = tree_serve_step(tables, float_to_key(torch.from_numpy(Xte)),
                                     small_packed.max_depth, device="cpu")
    assert acc_t.dtype == torch.uint32 and preds_t.dtype == torch.int32
    np.testing.assert_array_equal(acc_t.view(torch.int32).numpy().view(np.uint32),
                                  np.asarray(acc_j))
    np.testing.assert_array_equal(preds_t.numpy(), np.asarray(preds_j))
