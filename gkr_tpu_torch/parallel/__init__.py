from .sharding import ShardedBackend, ShardedSumcheck, make_mesh  # noqa: F401
