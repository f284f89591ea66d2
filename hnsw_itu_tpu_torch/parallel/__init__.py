"""Index and query sharding over a mesh of devices (port of
hnsw_itu_tpu/parallel/)."""

from .mesh import AXIS, make_mesh, replicate, shard_leading
from .sharded import (ShardedHNSW, ShardedNSW, knns_query_sharded,
                      sharded_build_step)

__all__ = [
    "AXIS",
    "make_mesh",
    "replicate",
    "shard_leading",
    "ShardedNSW",
    "ShardedHNSW",
    "knns_query_sharded",
    "sharded_build_step",
]
