"""NativeCTableBackend: the ragged layout compiled as a vectorized table walk.

The consumer of the ``ragged`` ForestIR layout, on the host CPU:
``codegen/table_emitter.emit_table_walk_c`` compiles the ragged ensemble's
CSR node arrays as static data plus a generic branch-free-select walk loop,
into the same ``predict_batch`` shared-library contract as ``native_c``.
Where the if-else backend puts the forest in the instruction stream (ideal
for MCU single-row latency), this one keeps the code O(1) and streams node
*data* — the layout trade the ARM tree-ensemble literature shows dominates
throughput at batch.

Row-blocked by default: ``block_rows=R`` (default 8, the capability's
``preferred_block_rows``) emits a batch entry that walks R rows per tree in
lockstep through fixed-size state arrays and an exact ``max_depth`` select
trip count — tree-major memory order, branch-free inner loop, vectorizable.
``block_rows=1`` keeps the scalar per-row while-loop walk (the baseline the
blocked variant is measured against).

Deterministic modes only (integer + flint), and since the partials/finalize
split both compile the *same* integer translation unit: the library emits
uint32 partial accumulators (``predict_partials``) and the shared numpy
finalize produces the mode's scores.  Thresholds stay FlInt int32 keys, so
partials are bit-identical to every other backend — the conformance suite
holds across the layout axis AND every block size, since blocking only
reorders *which rows* walk when, never any row's own accumulation order.
"""
from __future__ import annotations

from repro_torch.backends.base import BackendCapabilities, register_backend
from repro_torch.backends.native_c import CompiledCBackend

_DEFAULT_BLOCK_ROWS = 8


@register_backend
class NativeCTableBackend(CompiledCBackend):
    name = "native_c_table"
    capabilities = BackendCapabilities(
        modes=("flint", "integer"),
        deterministic_modes=("flint", "integer"),
        preferred_block_rows=_DEFAULT_BLOCK_ROWS,
        compiles_per_shape=False,
        supported_layouts=("ragged",),
        preferred_layout="ragged",
    )

    def __init__(self, packed, mode: str = "integer", *,
                 block_rows: int = None, simd: bool = True, **kwargs):
        super().__init__(packed, mode, **kwargs)
        self.block_rows = (_DEFAULT_BLOCK_ROWS if block_rows is None
                           else int(block_rows))
        if self.block_rows < 1:
            raise ValueError(f"block_rows must be >= 1, got {block_rows}")
        # simd=False pins the scalar blocked walk per *instance* (the SIMD
        # blocks compile but the dispatcher is forced off via the same macro
        # the degradation CI job sets process-wide) — what lets one bench
        # process measure avx2-vs-scalar on identical artifacts
        self.simd = bool(simd)
        if not self.simd:
            self._cflags = self._cflags + ("-DREPRO_NO_SIMD",)

    def _emit_source(self) -> str:
        from repro_torch.codegen.c_emitter import emit_batch_entry
        from repro_torch.codegen.table_emitter import emit_table_walk_c

        mode = self._exec_mode  # flint and integer share the integer unit
        if self.block_rows == 1:  # scalar per-row walk, the pre-blocking path
            return emit_table_walk_c(self.packed, mode=mode) + \
                emit_batch_entry(self.packed, mode=mode)
        return emit_table_walk_c(
            self.packed, mode=mode, block_rows=self.block_rows
        )
