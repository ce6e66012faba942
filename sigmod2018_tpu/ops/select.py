"""Selection operators: compare, mask-compaction, gather, checksum.

The reference's filter (filter.c:92-190), self-join (inter_res.c:234-263) and
same-node join (JoinInterNode, inter_res.c:363-389) are all per-row scalar
loops emitting into linked result buffers.  Here each of them is the same
two-step vectorized program:

    mask = elementwise compare          (one pass over the column)
    positions = compaction of the mask  (prefix-sum scatter; XLA lowers
                                         jnp.nonzero(size=) to cumsum+scatter)

All shapes are static: arrays are padded to a power-of-two size class and a
scalar `n_valid` marks the live prefix.  Row-ids are int32 (fits any contest
table; uint64 values stay uint64 end-to-end for bit-exact checksums).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


@partial(jax.jit, static_argnames=("op",))
def compare_mask(values: jax.Array, n_valid: jax.Array, op: str, const: jax.Array):
    """Elementwise filter mask over the live prefix of a padded u64 vector."""
    P = values.shape[0]
    live = jnp.arange(P, dtype=jnp.int32) < n_valid
    if op == "<":
        m = values < const
    elif op == ">":
        m = values > const
    elif op == "=":
        m = values == const
    else:
        raise ValueError(f"bad comparator {op!r}")
    return m & live


@jax.jit
def equal_mask(v1: jax.Array, v2: jax.Array, n_valid: jax.Array):
    """Self-join / same-component-join mask: v1[i] == v2[i] on live rows."""
    P = v1.shape[0]
    live = jnp.arange(P, dtype=jnp.int32) < n_valid
    return (v1 == v2) & live


@partial(jax.jit, static_argnames=("out_size",))
def mask_positions(mask: jax.Array, out_size: int):
    """Compact True positions to the front; returns (positions, count).

    positions has static length out_size, padded with 0 (a safe gather
    index); count is the number of valid entries.

    One stable u32 sort ((not mask) as the key, iota as payload) in
    place of `jnp.nonzero(size=)`'s cumsum + scatter — a choice made
    for a backend where scatters were slow; not yet re-measured on the
    GPU."""
    count = jnp.sum(mask, dtype=jnp.int32)
    P = mask.shape[0]
    iota = jnp.arange(P, dtype=jnp.int32)
    _, pos = jax.lax.sort(
        (jnp.logical_not(mask).astype(jnp.uint32), iota),
        num_keys=1, is_stable=True)
    if out_size <= P:
        pos = pos[:out_size]
    else:
        pos = jnp.concatenate(
            [pos, jnp.zeros((out_size - P,), jnp.int32)])
    live = jnp.arange(out_size, dtype=jnp.int32) < count
    return jnp.where(live, pos, 0), count


@jax.jit
def gather_u64(col: jax.Array, rowids: jax.Array) -> jax.Array:
    """values[i] = col[rowids[i]] — the reference's ScanInterResults gather
    (inter_res.c:182-206) as one XLA gather."""
    return col[rowids]


@jax.jit
def gather_rows(row: jax.Array, positions: jax.Array) -> jax.Array:
    return row[positions]


@jax.jit
def take_cols(table: jax.Array, positions: jax.Array) -> jax.Array:
    """Compact an [A, P] row-id matrix to table[:, positions] ([A, P_out])."""
    return jnp.take(table, positions, axis=1)


@jax.jit
def checksum(col: jax.Array, rowids: jax.Array, n_valid: jax.Array) -> jax.Array:
    """Wrap-around uint64 SUM over the gathered live prefix
    (reference: CalculateQueryResults, inter_res.c:320-339)."""
    P = rowids.shape[0]
    live = jnp.arange(P, dtype=jnp.int32) < n_valid
    vals = jnp.where(live, col[rowids], jnp.uint64(0))
    return jnp.sum(vals, dtype=jnp.uint64)


@jax.jit
def checksum_many(cols: jax.Array, rowids: jax.Array, n_valid: jax.Array) -> jax.Array:
    """Batched checksum: cols [V, N] gathered by rowids [V, P] -> [V] sums."""
    P = rowids.shape[1]
    live = (jnp.arange(P, dtype=jnp.int32) < n_valid)[None, :]
    vals = jnp.where(live, jnp.take_along_axis(cols, rowids.astype(jnp.int64), axis=1), jnp.uint64(0))
    return jnp.sum(vals, axis=1, dtype=jnp.uint64)
