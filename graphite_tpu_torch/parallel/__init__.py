"""Tile sharding of the port over ``torch.distributed``.

  * ``mesh.py`` — the counterpart of ``graphite_tpu/parallel/mesh.py`` for
    the replicated path (``tpu/tile_shards`` = S > 1, ``tpu/shard_state =
    replicated``): the explicit :class:`~mesh.ShardGroup` the engine is
    handed, its two collectives (the tiled gather of the sharded walks'
    outputs and the quantum barrier's MIN), the device-count check, and
    :func:`~mesh.launch`, which starts S ranks and returns what each one
    computed.
"""
