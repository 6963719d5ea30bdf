"""Runnable drivers: ``python -m repro_torch.launch.serve`` (tree serving,
the async gateway, LM generation)."""
