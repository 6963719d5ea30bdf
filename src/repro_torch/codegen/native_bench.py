"""Native-C benchmarking of the emitted if-else trees — the paper's actual
experiment (Sec. IV-D): compile with -O3, run many inferences, read a
monotonic clock inside the binary.  x86 here; the paper also covers ARMv7 and
RISC-V (single-ISA container — noted in EXPERIMENTS.md)."""
from __future__ import annotations

import subprocess
import tempfile
from pathlib import Path

import numpy as np

from repro_torch.codegen.c_emitter import emit_c
from repro_torch.core.flint import float_to_key_np
from repro_torch.core.packing import PackedEnsemble


def _timing_harness(packed: PackedEnsemble, n_rows: int, reps: int, mode: str) -> str:
    f = packed.n_features
    data_t = "float" if mode == "float" else "int32_t"
    return "\n".join(
        [
            "#include <stdio.h>",
            "#include <stdint.h>",
            "#include <time.h>",
            f"int predict_class(const {data_t}*);",
            "int main(void) {",
            f"  static {data_t} rows[{n_rows}][{f}];",
            f"  if (fread(rows, sizeof({data_t}), {n_rows * f}, stdin) != {n_rows * f}) return 2;",
            "  struct timespec t0, t1;",
            "  volatile long sink = 0;",
            "  clock_gettime(CLOCK_MONOTONIC, &t0);",
            f"  for (int r = 0; r < {reps}; ++r)",
            f"    for (int i = 0; i < {n_rows}; ++i) sink += predict_class(rows[i]);",
            "  clock_gettime(CLOCK_MONOTONIC, &t1);",
            "  long ns = (t1.tv_sec - t0.tv_sec) * 1000000000L + (t1.tv_nsec - t0.tv_nsec);",
            '  printf("%ld %ld\\n", ns, (long)sink);',
            "  return 0;",
            "}",
            "",
        ]
    )


def compile_and_time(packed: PackedEnsemble, X: np.ndarray, mode: str, *,
                     reps: int = 200) -> dict:
    """Returns {ns_per_row, checksum, binary_bytes} for one implementation."""
    n_rows = X.shape[0]
    src = emit_c(packed, mode=mode) + _timing_harness(packed, n_rows, reps, mode)
    if mode == "float":
        payload = X.astype("<f4").tobytes()
    else:
        payload = float_to_key_np(X.astype(np.float32)).astype("<i4").tobytes()
    with tempfile.TemporaryDirectory() as d:
        c_file = Path(d) / "m.c"
        binary = Path(d) / "m"
        c_file.write_text(src)
        subprocess.run(
            ["gcc", "-O3", "-o", str(binary), str(c_file)],
            check=True, capture_output=True,
        )
        size = binary.stat().st_size
        out = subprocess.run([str(binary)], input=payload, capture_output=True, check=True)
    ns, checksum = (int(v) for v in out.stdout.split())
    return {
        "ns_per_row": ns / (reps * n_rows),
        "checksum": checksum,
        "binary_bytes": size,
    }
