"""Execution over a device mesh (reference: frostdb_tpu/parallel).

The reference's concurrency story is goroutine fan-out over a row-group
channel with synchronizer fan-in (SURVEY.md §2.8; physicalplan.go:22
GOMAXPROCS). Here, as in the JAX package, one controller drives a mesh of
shards:

- tables row-sharded, by position or by a key's hash, across the shards
  (``PartitionedTable``; parts' own mirrors ``Part.device_sharded``)
- per-shard filter + partial aggregation (the reference's per-goroutine
  HashAggregate stage, aggregate.go:124 finalStage=false)
- the Synchronizer barrier becomes a collective (collectives.py):
  ``psum``/``pmin``/``pmax`` for dense group tables, an ``all_to_all``
  exchange for row repartitioning and large key spaces
- the distributed hash join (absent in the reference — north-star
  extension)

``mesh_exec`` holds the engine's single-device ``dense`` tier and the
``mesh`` tier built on it.
"""

from .mesh import Mesh, PartitionedTable, make_mesh  # noqa: F401
from .distributed import (  # noqa: F401
    distributed_filter_aggregate,
    distributed_distinct,
)
from .join import distributed_hash_join  # noqa: F401
from .shuffle import (  # noqa: F401
    ShuffleOverflow,
    shuffle_by_key,
    shuffle_by_key_auto,
)
