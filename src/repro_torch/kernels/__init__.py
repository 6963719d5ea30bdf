"""Hand-written CUDA kernels of the serving path, their plain PyTorch
versions, and the host wrapper that pads, blocks and dispatches."""
