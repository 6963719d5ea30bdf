"""The device mesh and the sharding rules: ``ops`` (``Mesh``, ``use_mesh``,
``constrain``, ``shard_map`` and the collectives over named mesh axes) and
``rules`` (the path-based parameter, batch and cache specs)."""
