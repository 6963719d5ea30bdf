"""Synthetic datasets (numpy only): tabular rows shaped like the paper's
benchmarks (``tabular``) and the LM token pipeline (``tokens``)."""
