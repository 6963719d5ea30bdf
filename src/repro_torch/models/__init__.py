"""The LM scaffold's serving half in PyTorch: shared layers (attention, MLP,
norms, rotary), the Mamba2 SSD layer, the FlInt-routed MoE layer and the
unified model (``transformer``: init, forward, prefill, decode)."""
