"""Runnable drivers: ``python -m repro_torch.launch.serve`` (tree serving,
the async gateway, LM generation) and ``python -m repro_torch.launch.train``
(LM training); ``mesh`` plans the elastic re-mesh after failures."""
