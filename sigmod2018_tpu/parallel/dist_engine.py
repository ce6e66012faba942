"""Distributed full-query engine: row-sharded tables + GSPMD.

Two multi-device layers exist by design (SURVEY §2.3):

- `dist.py` — hand-written shard_map programs for the hot path (hash
  shuffle + chip-local join + psum), where the collective schedule is
  chosen by us;
- this module — FULL query coverage on a mesh with minimal divergence
  from the single-chip executor: base columns are `device_put` with
  `NamedSharding(mesh, P('shards'))` and every operator program runs
  under jit with sharding propagation, letting the XLA SPMD partitioner
  insert the collectives (gathers across shards, psums for reductions).
  Correct for every query the single-chip engine handles; the planner's
  fused final join stays fused.

The executor logic is inherited unchanged — the only override is where
arrays land on devices.  This is the jax-native scaling story: same
program, different sharding.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import EngineConfig
from ..engine.executor import JaxEngine
from ..storage.catalog import Catalog
from ..utils.padding import pad_to, size_class
from .dist import AXIS, make_mesh


class DistJaxEngine(JaxEngine):
    """JaxEngine with row-sharded base columns over a 1-D mesh."""

    # the shuffle join's packed contract is view-slot aligned
    _fused_slot_padded = True
    prep_join_artifacts = False  # shuffle re-partitions the build side

    def __init__(self, catalog: Catalog, config: EngineConfig,
                 mesh: Optional[Mesh] = None):
        super().__init__(catalog, config)
        self.mesh = mesh if mesh is not None else make_mesh(
            config.mesh_devices if config.mesh_devices > 1 else None
        )
        self._row_sharding = NamedSharding(self.mesh, P(AXIS))

    def device_column(self, rid: int, cid: int) -> Tuple[jax.Array, int]:
        key = (rid, cid)
        hit = self._columns.get(key)
        if hit is not None:
            return hit
        col = np.asarray(self.catalog.column(rid, cid), dtype=np.uint64)
        n = col.shape[0]
        # Pad to a multiple of the mesh size so the row shards are equal.
        ndev = self.mesh.devices.size
        P_len = size_class(max(n, 1), self.config.min_pad * ndev)
        dev = jax.device_put(pad_to(col, P_len), self._row_sharding)
        self._columns[key] = (dev, n)
        return dev, n

    def _zeros_u64(self, P_len: int) -> jax.Array:
        key = ("__zeros__", P_len)
        z = self._columns.get(key)
        if z is None:
            z = (jax.device_put(np.zeros(P_len, dtype=np.uint64),
                                self._row_sharding), 0)
            self._columns[key] = z
        return z[0]

    # ---- distributed fused final join --------------------------------

    def _fused_join_packed(self, keys_b, bcols, n_b, keys_p, pcols, n_p,
                           key32: bool = False, presorted=None, table=None,
                           table_prefs=None):
        # `presorted`/`table`/`table_prefs` (single-device prep
        # artifacts) do not apply: the build side re-partitions
        # across chips in the shuffle below (prep_join_artifacts=False
        # keeps them None).
        """Route the fused final join through the hand-written shard_map
        hash-shuffle (dist.py) instead of GSPMD propagation: each chip
        buckets its rows by key, all_to_all exchanges them between devices, the
        join runs chip-local, and the packed result psums back."""
        from .dist import make_fused_shuffle_join, make_shuffle_caps

        caps_fn = self._program(("caps", keys_b.shape[0], keys_p.shape[0]),
                                lambda: make_shuffle_caps(self.mesh))
        hints = np.asarray(caps_fn(keys_b, n_b, keys_p, n_p))
        cap = size_class(max(int(hints[0]), int(hints[1]), 1),
                         self.config.min_pad)
        V = bcols.shape[0]
        key = ("fused", cap, V, keys_b.shape[0], keys_p.shape[0])
        join_fn = self._program(
            key, lambda: make_fused_shuffle_join(self.mesh, cap, V))
        return join_fn(keys_b, bcols, n_b, keys_p, pcols, n_p)

    def _program(self, key, build):
        progs = self.__dict__.setdefault("_dist_programs", {})
        fn = progs.get(key)
        if fn is None:
            fn = progs[key] = build()
        return fn
