"""PyTorch/CUDA port of ``repro``: integer-only tree-ensemble serving on an
NVIDIA H100.

Mirrors the layout of ``src/repro`` module for module (``repro_torch.ir.
layouts`` is the counterpart of ``repro.ir.layouts``) and imports nothing of
it, nor JAX.  The serving path is

    float32 rows -> FlInt int32 keys (core.flint)
      -> ForestIR quantized once (ir.forest_ir) -> leaf_major / padded /
         bitvector tables
      -> TreeEngine (serve.engine) -> single, tree_parallel or row_parallel
         plan -> cuda or bitvector backend (one per tree shard)
      -> hand-written CUDA kernels (kernels/, csrc/): the tree walks K1, K2,
         K3 and the QuickScorer scorer K5 -> uint32 partials (merged)
      -> numpy finalize (core.ensemble.finalize_partials) -> (scores, preds)

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; with
no card they raise instead of carrying on on the CPU.
"""
