"""Multi-device SPMD execution: mesh, hash-shuffle exchange, distributed join.

Replaces the reference's pthread pool (scheduler.c) with SPMD programs over
a `jax.sharding.Mesh` — see dist.py for the design notes.
"""

from .dist import (
    AXIS,
    exchange_multi,
    exchange,
    local_join_checksum,
    make_dist_checksum,
    make_dist_join_checksum,
    make_dist_join_checksum_skew,
    make_exchange_counts,
    make_mesh,
    partition_for_exchange,
    row_sharding,
)

from .multihost import flat_mesh_host_major, hier_mesh, init_distributed

__all__ = [
    "AXIS",
    "exchange_multi",
    "flat_mesh_host_major",
    "hier_mesh",
    "init_distributed",
    "exchange",
    "local_join_checksum",
    "make_dist_checksum",
    "make_dist_join_checksum",
    "make_dist_join_checksum_skew",
    "make_exchange_counts",
    "make_mesh",
    "partition_for_exchange",
    "row_sharding",
]
