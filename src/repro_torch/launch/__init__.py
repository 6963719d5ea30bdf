"""Runnable drivers: ``python -m repro_torch.launch.serve`` (tree serving,
the async gateway, LM generation) and ``python -m repro_torch.launch.train``
(LM training); ``mesh`` builds the device meshes (and plans the elastic
re-mesh after failures), ``shapes`` and ``roofline`` hold the assigned
input shapes and each cell's analytic work, and ``python -m
repro_torch.launch.dryrun`` runs each cell's rank program on the
production meshes with no device (``specs``, ``op_cost``,
``comm_analysis``)."""
