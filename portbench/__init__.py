"""The benchmark of the PyTorch/CUDA port of InTreeger (``repro_torch``).

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once on one NVIDIA card
and prints one JSON line.  Everything that defines the yardstick lives here:
for each family of models (``families/``) the seeded model, the plain
reference that decides ``correct`` and the layout-free work counts; the
traffic generator, the peaks, and one reader per metric.
"""
