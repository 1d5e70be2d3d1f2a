from .sharding import HostMesh, ShardedBackend, ShardedSumcheck, make_mesh  # noqa: F401
