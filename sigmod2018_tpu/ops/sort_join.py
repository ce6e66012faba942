"""Equi-join: sort-build + searchsorted-probe + cumsum-expand.

The reference joins by radix-partitioning both sides on the low key bits and
pointer-chasing a per-bucket bucket-chain hash index (rhjoin.c:141-309).
The data-parallel restatement, with no per-row control flow, is:

  build:  sort the smaller side's keys once (XLA sort, O(n log n) on device)
  probe:  two vectorized binary searches per probe key give the contiguous
          match range [lo, hi) — every lane independent, no chains
  emit:   expand variable-length ranges into a dense (build_pos, probe_pos)
          pair list via cumsum + one more searchsorted (the classic
          segment-expand trick), into a statically-sized padded output

Output cardinality is data-dependent; the probe phase returns the exact
total so the host picks a power-of-two output class and calls `join_emit`
(two-phase kernels, SURVEY §7.1).  Padding slots carry key 2^64-1 on the
build side and are excluded by clamping match ranges to `n_build`; padded
probe rows get count 0.  A *valid* key equal to 2^64-1 still joins
correctly: its valid copies sort immediately before the padding and the
clamp keeps exactly them.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

_PAD_KEY = np.uint64(0xFFFFFFFFFFFFFFFF)
_PAD_KEY32 = np.uint32(0xFFFFFFFF)


def _ccum_total(cnt: jax.Array):
    """(ccum i32, total i64) from per-row i32 match counts.

    `total` is exact (i64 tree-sum — it sizes output classes and feeds
    overflow validation).  `ccum` deliberately stays i32: it only
    positions pairs inside a ≤ spec_max-sized emit, and a query whose
    true total overflows the guessed class is discarded and re-run by
    the caller regardless, so wrapped ccum values can never reach an
    accepted result.  Single-limb cumsum + searchsorted move half the
    bytes of the i64 lowering."""
    return jnp.cumsum(cnt), jnp.sum(cnt.astype(jnp.int64))


@partial(jax.jit, static_argnames=("key32",))
def join_build(keys: jax.Array, n_valid: jax.Array, key32: bool = False):
    """Sort the build side.  Returns (sorted_keys, perm) with padding keys
    forced to the dtype max so they sort last.

    `key32` (catalog stats bound every value under 2^32): sort uint32
    instead of uint64 — half the key bytes through the sorter.  Values
    < 2^32 keep their order under the downcast, and stability breaks
    ties by index either way, so the permutation is bit-identical to a
    stable u64 argsort's.  The perm rides the sort as a payload — no
    argsort + O(P) gather."""
    P = keys.shape[0]
    live = jnp.arange(P, dtype=jnp.int32) < n_valid
    iota = jnp.arange(P, dtype=jnp.int32)
    if key32:
        k = jnp.where(live, keys.astype(jnp.uint32), _PAD_KEY32)
        sk, perm = jax.lax.sort((k, iota), num_keys=1, is_stable=True)
        return sk, perm
    from .lsd import sort_u64_with

    k = jnp.where(live, keys, _PAD_KEY)
    return sort_u64_with(k, (iota,))


@jax.jit
def join_probe_count(sorted_keys: jax.Array, n_build: jax.Array,
                     probe_keys: jax.Array, n_probe: jax.Array):
    """Per-probe-row match ranges and total output cardinality.

    Returns (lo, cnt, ccum, total): lo[i] = first match position in the
    sorted build array, cnt[i] = number of matches, ccum = inclusive cumsum
    of cnt, total = ccum[-1].

    Probe keys are compared in `sorted_keys`' dtype (uint32 when the
    build side was sorted single-limb — see join_build).  Both range
    edges come from ONE searchsorted over [probe, probe+1]: for integer
    keys, #elements(<= k) == #elements(< k+1), so side="right" at k is
    side="left" at k+1 — one internal sort of P+2*Pp elements instead of
    two sorts of P+Pp.  k = dtype-max would wrap, so its right edge is
    pinned to n_build, which is exact: pad slots hold dtype-max and sort
    (stably) after every valid row, so a valid max-key run always ends
    at n_build.
    """
    Pp = probe_keys.shape[0]
    pk = probe_keys.astype(sorted_keys.dtype)
    maxv = jnp.array(jnp.iinfo(sorted_keys.dtype).max, sorted_keys.dtype)
    # method="sort": a data-independent sort-based lowering, chosen when
    # the engine ran on another backend where the scan-based binary
    # search degenerated on duplicate runs.  Not yet re-measured on the
    # GPU.  u64 keys rank through one stable sort of the combined array
    # (ops/lsd.py).
    if sorted_keys.dtype == jnp.uint64:
        from .lsd import ranks_u64

        both = ranks_u64(sorted_keys, jnp.concatenate([pk, pk + 1]),
                         side="left")
    else:
        both = jnp.searchsorted(sorted_keys, jnp.concatenate([pk, pk + 1]),
                                side="left", method="sort")
    lo = jnp.minimum(both[:Pp], n_build).astype(jnp.int32)
    hi = jnp.where(pk == maxv, n_build,
                   jnp.minimum(both[Pp:], n_build)).astype(jnp.int32)
    live = jnp.arange(Pp, dtype=jnp.int32) < n_probe
    cnt = jnp.where(live, hi - lo, 0)
    return lo, cnt, *_ccum_total(cnt)


@jax.jit
def join_probe_count_table(cumcnt: jax.Array,
                           probe_keys: jax.Array, n_probe: jax.Array):
    """join_probe_count against a prep-time key table — ZERO sorts.

    `cumcnt` is the build column's domain rank table (engine
    device_key_table): cumcnt[k] = #build rows with key < k, for
    k in [0, u+2] where u = the column's exact max (catalog stats), so
    the table has u+3 entries and cumcnt.shape statically encodes u.
    Built once in the untimed prep window (the data-parallel restatement
    of the reference's per-join bucket-chain index, rhjoin.c:219-309: both
    answer "which build rows carry key k" without pointer chasing —
    here as two gathers into a rank table).

    Match ranges are in sorted-build coordinates, identical to
    join_probe_count's (cumcnt[k] is exactly the first sorted position
    of key k), so join_emit consumes them unchanged with the prep sort's
    perm.  Probe keys past the domain (k > u) get [n, n) — empty.
    """
    u = cumcnt.shape[0] - 3
    Pp = probe_keys.shape[0]
    in_dom = probe_keys <= jnp.uint64(u)
    pkc = jnp.minimum(probe_keys, jnp.uint64(u + 1)).astype(jnp.int32)
    lo = cumcnt[pkc]
    hi = jnp.where(in_dom, cumcnt[pkc + 1], lo)
    live = jnp.arange(Pp, dtype=jnp.int32) < n_probe
    cnt = jnp.where(live, hi - lo, 0)
    return lo, cnt, *_ccum_total(cnt)


@partial(jax.jit, static_argnames=("out_size",))
def join_emit(perm: jax.Array, lo: jax.Array, ccum: jax.Array,
              total: jax.Array, out_size: int):
    """Expand match ranges into dense (build_pos, probe_pos) pairs.

    build_pos indexes the *original* (unsorted, padded) build input;
    probe_pos indexes the probe input.  Slots >= total are padded with 0.

    Range expansion is scatter + running-max, O(out_size + Pp): each
    non-empty block scatters its probe-row index at its start slot
    (block starts are strictly increasing, so no collisions), and a
    cummax fills every slot with its owning row.  Replaces the
    searchsorted expansion, whose method="sort" lowering sorts
    Pp + out_size elements — the dominant cost of multi-million-row
    emits (the reference's equivalent loop is the pair emit at
    rhjoin.c:176-216, which is O(out) for the same reason)."""
    Pp = ccum.shape[0]
    starts = jnp.concatenate([jnp.zeros((1,), ccum.dtype), ccum[:-1]])
    cnt = ccum - starts
    rows = jnp.arange(Pp, dtype=jnp.int32)
    out = jnp.zeros((out_size,), jnp.int32)
    out = out.at[jnp.where(cnt > 0, starts, out_size)].max(
        rows + 1, mode="drop")
    i = jax.lax.cummax(out) - 1  # owning probe row per slot
    t = jnp.arange(out_size, dtype=ccum.dtype)
    i = jnp.clip(i, 0, Pp - 1)
    j = (t - starts[i]).astype(jnp.int32)
    valid = t < jnp.minimum(total, out_size).astype(ccum.dtype)
    bpos = perm[jnp.where(valid, lo[i] + j, 0)]
    build_pos = jnp.where(valid, bpos, 0).astype(jnp.int32)
    probe_pos = jnp.where(valid, i, 0).astype(jnp.int32)
    return build_pos, probe_pos
