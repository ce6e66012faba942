"""u64 sort / rank primitives.

Three rules, used across ops/:

  1. u64 sorts run as ONE single-key stable sort — never num_keys=2
     with a liveness flag (stability + pads-at-suffix gives the same
     order).
  2. Rank queries (searchsorted) against u64 keys do not use
     jnp.searchsorted's method="sort".  `ranks_u64` computes ranks from
     one stable single-key sort of the concatenated (haystack, queries)
     array + rank arithmetic, with searchsorted's tie semantics (side=)
     reproduced by the concatenation order under stability.
  3. Permutations ride sorts as i32 payloads; sorted values come from
     the same sort — never argsort + O(P) gather.

These lowering choices were made by measurement on the backend the
engine was first built for; they have not yet been re-measured on the
GPU (ROADMAP).  Reference mapping: drop-in primitives for where the
reference builds radix partitions and bucket-chain indexes
(preprocess.c:13-178, rhjoin.c:219-309).
"""

from __future__ import annotations

from functools import partial
from typing import Sequence, Tuple

import jax
import jax.numpy as jnp


def sort_u64_with(keys: jax.Array, operands: Sequence[jax.Array] = ()
                  ) -> Tuple[jax.Array, ...]:
    """Stable ascending sort by u64 `keys`, carrying `operands`.

    Returns (sorted_keys, *sorted_operands).  Callers relying on
    jnp.argsort's stability (pad rows forced to 2^64-1 staying behind
    live 2^64-1 keys, ops/sort_join.py) keep that guarantee."""
    out = jax.lax.sort((keys,) + tuple(operands), num_keys=1,
                       is_stable=True)
    return out


def argsort_u64(keys: jax.Array) -> jax.Array:
    """Stable argsort of u64 keys — bit-identical permutation to
    jnp.argsort(keys), without the argsort+gather round trip."""
    P = keys.shape[0]
    iota = jnp.arange(P, dtype=jnp.int32)
    return sort_u64_with(keys, (iota,))[1]


def ranks_u64(sorted_keys: jax.Array, queries: jax.Array,
              side: str = "left") -> jax.Array:
    """searchsorted over u64 keys through one stable sort.

    Returns, per query q, #elements of `sorted_keys` < q (side="left")
    or <= q (side="right") — identical to ``jnp.searchsorted(...,
    method="sort")``, from one stable single-key sort of the combined
    array.

    Tie order comes from the concatenation order under stability:
    queries FIRST for side="left" (a query precedes equal haystack
    elements, so its rank counts only strictly-smaller ones), haystack
    first for side="right".  rank(q) = q's combined position minus the
    number of queries at earlier positions.  One final stable u32 sort
    restores query order (non-queries keyed past every query index).
    """
    N = sorted_keys.shape[0]
    Q = queries.shape[0]
    # The barrier keeps XLA from constant-folding the index arrays below
    # into (N+Q)-element literals: on the GPU such literals cost minutes
    # of compile time and bloat every executable that ranks u64 keys.
    pos = jax.lax.optimization_barrier(jnp.arange(N + Q, dtype=jnp.int32))
    if side == "left":
        comb = jnp.concatenate([queries, sorted_keys])
        is_query = pos < Q
        qpos = pos
    else:
        comb = jnp.concatenate([sorted_keys, queries])
        is_query = pos >= N
        qpos = pos - N
    isq = is_query.astype(jnp.int32)
    qidx = jnp.where(is_query, qpos, 0)
    _, isq_s, qidx_s = jax.lax.sort((comb, isq, qidx), num_keys=1,
                                    is_stable=True)
    q_before = jnp.cumsum(isq_s) - isq_s  # queries strictly before pos
    rank = pos - q_before
    key2 = jnp.where(isq_s == 1, qidx_s, jnp.int32(Q)).astype(jnp.uint32)
    _, rank_q = jax.lax.sort((key2, rank), num_keys=1, is_stable=True)
    return rank_q[:Q]


@partial(jax.jit, static_argnames=("side",))
def searchsorted_u64(sorted_keys: jax.Array, queries: jax.Array,
                     side: str = "left") -> jax.Array:
    return ranks_u64(sorted_keys, queries, side)
