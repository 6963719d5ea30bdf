"""Checkpoints and restarts: the async, atomically committed checkpoint
manager (the JAX package's on-disk protocol) and the fault-tolerance
runtime (straggler watchdog, crash-restart loop, elastic re-mesh plan)."""
