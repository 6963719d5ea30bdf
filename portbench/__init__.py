"""The benchmark of the PyTorch/CUDA port of InTreeger (``repro_torch``).

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once on one NVIDIA card
and prints one JSON line.  Everything that defines the yardstick lives here:
the seeded forest and traffic generators, the plain reference that decides
``correct``, the layout-free work counts and peaks, and one reader per metric.
"""
