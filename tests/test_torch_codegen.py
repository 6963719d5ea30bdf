"""The port's C emitters against the JAX package's, byte for byte.

For the same forest, quantized once by the JAX ``ForestIR`` and carried
across as numpy (so both packages materialize from the same arrays), each
emitter of ``repro_torch.codegen`` must produce the very text of its
``repro.codegen`` counterpart: ``emit_c`` in all three modes,
``emit_batch_entry``, ``emit_test_harness``, ``emit_table_walk_c`` scalar
and row-blocked at 1, 4, 8 and 16 rows, and ``emit_bitvector_c`` at
interleave 1, 4 and 8, on a trained forest and on the degenerate forests of
``tests/forest_cases.py``, and ``emit_c`` on a chain deeper than the
recursion limit.  The structural cases of ``tests/test_codegen_c.py`` run
on the port's emitters, and where gcc is present (``requires_gcc``) the
compiled harness binaries and the Sec. IV-D timing harness are held
against the port's reference walk and the JAX package's binaries.
"""
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest

from forest_cases import DEGENERATE_FORESTS
from repro.codegen import bitvector_emitter as jbv
from repro.codegen import c_emitter as jc
from repro.codegen import native_bench as jbench
from repro.codegen import table_emitter as jtable
from repro.ir import ForestIR as JForestIR
from repro_torch.codegen import bitvector_emitter as pbv
from repro_torch.codegen import c_emitter as pc
from repro_torch.codegen import native_bench as pbench
from repro_torch.codegen import table_emitter as ptable
from repro_torch.core.flint import float_to_key_np
from repro_torch.ir import ForestIR
from repro_torch.ir.forest_ir import ARRAY_DTYPES
from repro_torch.serve import TreeEngine

FORESTS = ["trained", *sorted(DEGENERATE_FORESTS)]
MODES = ("integer", "flint", "float")


def _port_ir(jir):
    return ForestIR.from_numpy({k: getattr(jir, k) for k in ARRAY_DTYPES},
                               n_trees=jir.n_trees, n_classes=jir.n_classes,
                               n_features=jir.n_features, quant_scale=jir.quant_scale)


@pytest.fixture(scope="module", params=FORESTS)
def irs(request, small_forest):
    """(JAX IR, the port's IR from the same arrays) for one forest."""
    forest = (small_forest if request.param == "trained"
              else DEGENERATE_FORESTS[request.param]())
    jir = JForestIR.from_forest(forest)
    return jir, _port_ir(jir)


@pytest.fixture(scope="module")
def packed(small_forest):
    """The port's padded tables of the trained forest."""
    return _port_ir(JForestIR.from_forest(small_forest)).materialize("padded")


# ------------------------------------------------------------ byte identity

@pytest.mark.parametrize("mode", MODES)
def test_emit_c_is_the_jax_text(irs, mode):
    jir, pir = irs
    for layout in ("padded", "leaf_major"):
        jp, pp = jir.materialize(layout), pir.materialize(layout)
        assert pc.emit_c(pp, mode=mode) == jc.emit_c(jp, mode=mode), layout
        assert pc.emit_batch_entry(pp, mode=mode) == jc.emit_batch_entry(jp, mode=mode)
        for n in (1, 7):
            assert pc.emit_test_harness(pp, n, mode=mode) == \
                jc.emit_test_harness(jp, n, mode=mode)


@pytest.mark.parametrize("block_rows", [None, 1, 4, 8, 16])
def test_emit_table_walk_c_is_the_jax_text(irs, block_rows):
    jir, pir = irs
    jr, pr = jir.materialize("ragged"), pir.materialize("ragged")
    for mode in ("integer", "flint"):
        assert ptable.emit_table_walk_c(pr, mode=mode, block_rows=block_rows) == \
            jtable.emit_table_walk_c(jr, mode=mode, block_rows=block_rows), mode


@pytest.mark.parametrize("interleave", [1, 4, 8])
def test_emit_bitvector_c_is_the_jax_text(irs, interleave):
    jir, pir = irs
    got = pbv.emit_bitvector_c(pir.materialize("bitvector"), mode="integer",
                               interleave=interleave)
    assert got == jbv.emit_bitvector_c(jir.materialize("bitvector"), mode="integer",
                                       interleave=interleave)


def test_deep_chain_beyond_the_recursion_limit_is_the_jax_text():
    """A chain ``sys.getrecursionlimit()`` levels deep emits through the
    work stack in both packages, with one branch per level."""
    from forest_cases import chain_tree, forest_from_trees

    depth = sys.getrecursionlimit()
    jir = JForestIR.from_forest(forest_from_trees([chain_tree(depth, 2)], 2, 1))
    pp = _port_ir(jir).materialize("padded")
    src = pc.emit_c(pp, mode="integer")
    assert src == jc.emit_c(jir.materialize("padded"), mode="integer")
    assert src.count("{") == src.count("}")
    assert src.count("if (data[") == depth


def test_emitters_refuse_what_the_jax_emitters_refuse(packed):
    ragged = packed.ir.materialize("ragged")
    with pytest.raises(AssertionError):
        ptable.emit_table_walk_c(ragged, mode="float")
    with pytest.raises(AssertionError):
        pc.emit_c(packed, mode="double")
    with pytest.raises(AssertionError):
        pbv.emit_bitvector_c(packed.ir.materialize("bitvector"), mode="flint")


# ---------------------------------------------------------------- structure

def test_emit_integer_c_structure(packed):
    src = pc.emit_c(packed, mode="integer")
    assert "#include <stdint.h>" in src
    assert "float" not in src  # integer-only: no float type anywhere
    assert "result[0] +=" in src and "u;" in src
    assert src.count("if (") > packed.n_trees
    assert "const float* data" in pc.emit_c(packed, mode="float")


def test_harness_matches_mode_data_type(packed):
    f = packed.n_features
    for mode in ("integer", "flint"):
        src = pc.emit_test_harness(packed, 4, mode=mode)
        assert f"static int32_t row[{f}]" in src and "sizeof(int32_t)" in src
    src = pc.emit_test_harness(packed, 4, mode="float")
    assert f"static float row[{f}]" in src and "sizeof(float)" in src


def test_table_walk_structure(packed):
    rg = packed.ir.materialize("ragged")
    src = ptable.emit_table_walk_c(rg, mode="integer")
    assert "float" not in src
    assert f"tree_root[{rg.n_trees}]" in src
    assert src.count("while (f >= 0)") == 1  # one walk loop, not per-tree code
    blocked = ptable.emit_table_walk_c(rg, mode="integer", block_rows=4)
    assert f"node_quad[{rg.total_nodes * 4}]" in blocked and "node_feature" not in blocked
    for k in range(4):
        assert f"int32_t n{k} = root;" in blocked
    assert "(f0 & f1 & f2 & f3) < 0" in blocked
    walk = blocked[blocked.index("walk_block_full"):blocked.index("void predict_batch")]
    assert "go0" in walk and "?" not in walk  # arithmetic selects, no ternary


# ------------------------------------------------------------------ compiled

def _run_harness(src: str, payload: bytes) -> np.ndarray:
    with tempfile.TemporaryDirectory() as d:
        c_file, binary = Path(d) / "m.c", Path(d) / "m"
        c_file.write_text(src)
        subprocess.run(["gcc", "-O2", "-o", str(binary), str(c_file)],
                       check=True, capture_output=True)
        out = subprocess.run([str(binary)], input=payload, capture_output=True, check=True)
    return np.array([int(v) for v in out.stdout.split()])


@pytest.mark.requires_gcc
@pytest.mark.parametrize("mode", MODES)
def test_compiled_if_else_harness_matches_the_reference_walk(packed, shuttle_small, mode):
    """The paper's artifact as a stdin binary: its argmax per row equals the
    port's reference walk in every mode (float mode reads float32 rows)."""
    rows = shuttle_small[2][:300].astype(np.float32)
    payload = (rows.astype("<f4") if mode == "float"
               else float_to_key_np(rows).astype("<i4")).tobytes()
    src = pc.emit_c(packed, mode=mode) + pc.emit_test_harness(packed, len(rows), mode=mode)
    got = _run_harness(src, payload)
    want = TreeEngine(packed.ir, spec=f"{mode}:reference", device="cpu").predict(rows)
    np.testing.assert_array_equal(got, want)


@pytest.mark.requires_gcc
def test_compiled_table_walk_harness_matches_if_else(packed, shuttle_small):
    rows = shuttle_small[2][:300].astype(np.float32)
    payload = float_to_key_np(rows).astype("<i4").tobytes()
    harness = pc.emit_test_harness(packed, len(rows), mode="integer")
    table = _run_harness(ptable.emit_table_walk_c(packed.ir.materialize("ragged"))
                         + harness, payload)
    if_else = _run_harness(pc.emit_c(packed) + harness, payload)
    np.testing.assert_array_equal(table, if_else)


@pytest.mark.requires_gcc
def test_timing_harness_checksum_is_the_jax_packages(small_forest, shuttle_small):
    """``native_bench.compile_and_time`` (-O3, the clock inside the binary):
    the port's binary sums the same predictions as the JAX package's."""
    rows = shuttle_small[2][:64].astype(np.float32)
    jir = JForestIR.from_forest(small_forest)
    pp = _port_ir(jir).materialize("padded")
    for mode in ("integer", "float"):
        got = pbench.compile_and_time(pp, rows, mode, reps=3)
        want = jbench.compile_and_time(jir.materialize("padded"), rows, mode, reps=3)
        assert got["checksum"] == want["checksum"], mode
        assert got["ns_per_row"] > 0 and got["binary_bytes"] > 0
