"""The LM scaffold in PyTorch: shared layers (attention, MLP, norms,
rotary), the Mamba2 SSD layer, the FlInt-routed MoE layer and the unified
model (``transformer``: init, forward, the chunked-CE loss, prefill,
decode)."""
