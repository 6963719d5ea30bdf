"""Synthetic tabular datasets (numpy only) shaped like the paper's benchmarks."""
