"""Final-join checksum fusion: aggregate pushdown into the probe.

The reference materializes every join's (row_idR, row_idS) pairs and only
then gathers + sums the projection columns (rhjoin.c GetResults →
inter_res.c CalculateQueryResults).  When the join is the *last* operator
of a query, materialization is pure waste: the output of the query is a
handful of uint64 SUMs.  This op computes them inside the probe:

    per probe row i with sorted-build match range [lo_i, hi_i):
        count        += hi_i - lo_i
        sum(b_col_v) += pref_v[hi_i] - pref_v[lo_i]   (prefix sums of the
                                                       build-side view col)
        sum(p_col_v) += (hi_i - lo_i) * p_col_v[i]

All wrap-around uint64.  The multi-million-row intermediate never exists —
for the contest's worst queries this removes the single largest kernel and
the host sync that sized it.

Shapes: build_cols [Vb, Pb], probe_cols [Vp, Pp] — V* may be 0.  Returns
(count u64 scalar, sums_build [Vb] u64, sums_probe [Vp] u64).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

_PAD_KEY = np.uint64(0xFFFFFFFFFFFFFFFF)


def _fused_from_sorted(sk: jax.Array, perm: jax.Array,
                       build_cols: jax.Array, n_build: jax.Array,
                       probe_keys: jax.Array, probe_cols: jax.Array,
                       n_probe: jax.Array):
    """Core of the fused checksum join, given the build side already
    sorted (sk = sorted keys with pads forced to dtype-max, perm = the
    stable argsort permutation).  Pads sort last, so liveness in the
    sorted domain is simply position < n_build."""
    Pb = sk.shape[0]
    live_s = jnp.arange(Pb, dtype=jnp.int32) < n_build
    sv = jnp.where(live_s[None, :], build_cols[:, perm], jnp.uint64(0))
    pref = jnp.concatenate(
        [jnp.zeros((sv.shape[0], 1), jnp.uint64), jnp.cumsum(sv, axis=1)], axis=1
    )
    Pp = probe_keys.shape[0]
    pk = probe_keys.astype(sk.dtype)
    maxv = jnp.array(jnp.iinfo(sk.dtype).max, sk.dtype)
    # ONE searchsorted for both range edges (see ops/sort_join.py:
    # side="right" at k == side="left" at k+1 for integer keys; dtype-max
    # pins its right edge to n_build).  u64 keys rank through one stable
    # sort of the combined array (ops/lsd.py).
    if sk.dtype == jnp.uint64:
        from .lsd import ranks_u64

        both = ranks_u64(sk, jnp.concatenate([pk, pk + 1]), side="left")
    else:
        both = jnp.searchsorted(sk, jnp.concatenate([pk, pk + 1]),
                                side="left", method="sort")
    lo = jnp.minimum(both[:Pp], n_build)
    hi = jnp.where(pk == maxv, n_build, jnp.minimum(both[Pp:], n_build))
    live_p = jnp.arange(Pp, dtype=jnp.int32) < n_probe
    cnt = jnp.where(live_p, hi - lo, 0).astype(jnp.uint64)
    count = jnp.sum(cnt)
    sums_build = jnp.sum(
        jnp.where(live_p[None, :], pref[:, hi] - pref[:, lo], jnp.uint64(0)), axis=1
    )
    sums_probe = jnp.sum(cnt[None, :] * probe_cols, axis=1)
    return count, sums_build, sums_probe


@partial(jax.jit, static_argnames=("key32",))
def join_checksum_fused(build_keys: jax.Array, build_cols: jax.Array,
                        n_build: jax.Array, probe_keys: jax.Array,
                        probe_cols: jax.Array, n_probe: jax.Array,
                        key32: bool = False):
    """key32 (both key columns < 2^32 by catalog stats): single-limb
    uint32 sort + searchsorted — half the key bytes of the u64 path,
    bit-identical results (see ops/sort_join.py)."""
    Pb = build_keys.shape[0]
    live_b = jnp.arange(Pb, dtype=jnp.int32) < n_build
    iota = jnp.arange(Pb, dtype=jnp.int32)
    if key32:
        k = jnp.where(live_b, build_keys.astype(jnp.uint32),
                      jnp.uint32(0xFFFFFFFF))
        sk, perm = jax.lax.sort((k, iota), num_keys=1, is_stable=True)
    else:
        from .lsd import sort_u64_with

        k = jnp.where(live_b, build_keys, _PAD_KEY)
        sk, perm = sort_u64_with(k, (iota,))
    return _fused_from_sorted(sk, perm, build_cols, n_build,
                              probe_keys, probe_cols, n_probe)


@jax.jit
def join_checksum_fused_table(cumcnt: jax.Array, perm: jax.Array,
                              build_cols: jax.Array, n_build: jax.Array,
                              probe_keys: jax.Array, probe_cols: jax.Array,
                              n_probe: jax.Array):
    """Fused checksum join against a prep-time key table — ZERO sorts.

    `cumcnt`/`perm` are the build base column's prep artifacts
    (engine device_key_table / device_sorted_column; see
    ops/sort_join.py::join_probe_count_table for the table contract).
    The whole join is gathers + one prefix sum: match ranges are two
    gathers into the rank table, build-side sums are prefix-sum
    differences over the prep-sorted payload, probe-side sums are
    count-weighted.  Bandwidth-bound — no sort, no searchsorted."""
    Pb = perm.shape[0]
    live_s = jnp.arange(Pb, dtype=jnp.int32) < n_build
    sv = jnp.where(live_s[None, :], build_cols[:, perm], jnp.uint64(0))
    pref = jnp.concatenate(
        [jnp.zeros((sv.shape[0], 1), jnp.uint64), jnp.cumsum(sv, axis=1)], axis=1
    )
    u = cumcnt.shape[0] - 3
    Pp = probe_keys.shape[0]
    in_dom = probe_keys <= jnp.uint64(u)
    pkc = jnp.minimum(probe_keys, jnp.uint64(u + 1)).astype(jnp.int32)
    lo = cumcnt[pkc]
    hi = jnp.where(in_dom, cumcnt[pkc + 1], lo)
    live_p = jnp.arange(Pp, dtype=jnp.int32) < n_probe
    cnt = jnp.where(live_p, hi - lo, 0).astype(jnp.uint64)
    count = jnp.sum(cnt)
    sums_build = jnp.sum(
        jnp.where(live_p[None, :], pref[:, hi] - pref[:, lo], jnp.uint64(0)), axis=1
    )
    sums_probe = jnp.sum(cnt[None, :] * probe_cols, axis=1)
    return count, sums_build, sums_probe


@jax.jit
def prefix_by_perm(vals: jax.Array, perm: jax.Array, n: jax.Array):
    """Prep artifact for join_checksum_fused_table_pref: exclusive-then-
    inclusive prefix sums of a value column in key-sorted order,
    pref[i] = sum of the first i live rows (pads contribute 0).
    Shape [P+1] u64.  Built once per (key column, value column) pair in
    the untimed prep window (engine device_prefix_table)."""
    P = perm.shape[0]
    live = jnp.arange(P, dtype=jnp.int32) < n
    sv = jnp.where(live, vals[perm], jnp.uint64(0))
    return jnp.concatenate([jnp.zeros((1,), jnp.uint64), jnp.cumsum(sv)])


@jax.jit
def join_checksum_fused_table_pref(cumcnt: jax.Array, prefs: jax.Array,
                                   probe_keys: jax.Array,
                                   probe_cols: jax.Array, n_probe: jax.Array):
    """Fused checksum join that is O(1) per probe row — PROBE-ONLY work.

    Strongest member of the fused-join family: both the rank table
    `cumcnt` AND the build-side prefix sums `prefs` ([V, Pb+1], one row
    per view, engine device_prefix_table) are prep artifacts, so the
    query-time program touches NOTHING proportional to the build side:
    per probe row it is two rank-table gathers (match range), two
    prefix-table gathers per view (range-sum), and a count-weighted
    probe-side sum.  Bandwidth-bound by construction — ~5 random gathers
    per probe row and zero sorts/cumsums, vs join_checksum_fused_table
    which still gathers + prefix-sums the build payload per query.
    Reference cost model being replaced: the per-join bucket-chain index
    build (rhjoin.c:219-273) plus the probe loop (rhjoin.c:141-217)."""
    u = cumcnt.shape[0] - 3
    Pp = probe_keys.shape[0]
    in_dom = probe_keys <= jnp.uint64(u)
    pkc = jnp.minimum(probe_keys, jnp.uint64(u + 1)).astype(jnp.int32)
    lo = cumcnt[pkc]
    hi = jnp.where(in_dom, cumcnt[pkc + 1], lo)
    live_p = jnp.arange(Pp, dtype=jnp.int32) < n_probe
    cnt = jnp.where(live_p, hi - lo, 0).astype(jnp.uint64)
    count = jnp.sum(cnt)
    sums_build = jnp.sum(
        jnp.where(live_p[None, :], prefs[:, hi] - prefs[:, lo],
                  jnp.uint64(0)), axis=1
    )
    sums_probe = jnp.sum(cnt[None, :] * probe_cols, axis=1)
    return count, sums_build, sums_probe


@partial(jax.jit, static_argnames=("key32",))
def join_checksum_fused_presorted(sorted_keys: jax.Array, perm: jax.Array,
                                  build_cols: jax.Array, n_build: jax.Array,
                                  probe_keys: jax.Array,
                                  probe_cols: jax.Array, n_probe: jax.Array,
                                  key32: bool = False):
    """Fused checksum join whose build side was sorted at PREP time.

    The contest's prep window is untimed (harness.cpp:175-208), so the
    engine presorts every base join column once at load; a final join
    building on an unfiltered base column then skips its argsort
    entirely.  `sorted_keys` is the u64 prep sort; under key32 it is
    downcast AFTER the sort — order is preserved (values < 2^32, pads
    2^64-1 -> 2^32-1) and ties were already broken by index, so the
    result is bit-identical to sorting in u32 directly."""
    sk = sorted_keys.astype(jnp.uint32) if key32 else sorted_keys
    return _fused_from_sorted(sk, perm, build_cols, n_build,
                              probe_keys, probe_cols, n_probe)


def fused_join(keys_b, vals_b, n_b, keys_p, vals_p, n_p,
               key32: bool = False, presorted=None, table=None,
               table_prefs=None):
    """The engine's fused-final-join entry: picks the member from the
    prep artifacts the build side has.

    - `table` (the build base column's (cumcnt rank table, perm), engine
      device_key_table) with `table_prefs` (prep-time prefix sums of
      every build-side view, [V, Pb+1], engine device_prefix_table):
      probe-only work, `vals_b` unused (may be None);
    - `table` alone: rank-table gathers + one build-side prefix sum;
    - `presorted` (the build base column's prep-time (sorted_keys u64,
      perm), engine device_sorted_column): skips the build-side sort;
    - otherwise the sort member.

    `key32`: both key columns' values < 2^32 (catalog stats), so the
    sort members compare single-limb u32 keys.  Returns (count,
    sums_build [Vb], sums_probe [Vp]), exact wrap-around uint64."""
    n_b = jnp.int32(n_b)
    n_p = jnp.int32(n_p)
    if table is not None:
        cumcnt, perm = table
        if table_prefs is not None:
            return join_checksum_fused_table_pref(cumcnt, table_prefs,
                                                  keys_p, vals_p, n_p)
        return join_checksum_fused_table(cumcnt, perm, vals_b, n_b,
                                         keys_p, vals_p, n_p)
    if presorted is not None:
        sk, perm = presorted
        return join_checksum_fused_presorted(sk, perm, vals_b, n_b, keys_p,
                                             vals_p, n_p, key32=key32)
    return join_checksum_fused(keys_b, vals_b, n_b, keys_p, vals_p, n_p,
                               key32=key32)
