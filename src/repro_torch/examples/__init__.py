"""Runnable examples of the port (``python -m repro_torch.examples.<name>``):
``quickstart`` (the pipeline end to end) and ``serve_trees_scaled`` (batched
serving across the implementations, and the one-device serving step)."""
