"""Runnable examples of the port (``python -m repro_torch.examples.<name>``):
``quickstart`` (the pipeline end to end), ``serve_trees_scaled`` (batched
serving across the implementations, and the one-device serving step),
``train_lm`` (LM training with a crash recovered from a checkpoint) and
``integer_allreduce_demo`` (the fixed-point all-reduce on 8 ranks)."""
