"""Factorized (message-passing) aggregate execution for acyclic joins.

Why this exists: every other execution path in this engine — like the
reference C engine (inter_res.c row-id materialization, query.c:408-461)
— materializes each intermediate join's row-id table, so a query whose
intermediate cardinality explodes (Zipf heavy hitters: zipfbig's last
query reaches ~5.5e11 rows in text order) cannot be answered by ANY
join order.  But the contest output is only COUNT + per-view SUM
checksums, and for an acyclic join graph those are computable without
materializing anything: Yannakakis message passing over the join
forest with (count, sum) annotations — one bottom-up and one top-down
sweep of sort / searchsorted / prefix-sum work, O(N log N) total,
independent of the join's output cardinality.

Math: for binding b let M_b(r) = number of full result tuples whose
b-component is base row r, computed mod 2^64 (wrap-around).  Then

    checksum(b.c) = sum_r M_b(r) * col(b,c)[r]        (mod 2^64)

and the result is NULL iff no full tuple exists.  M_b = up_b * down_b:
`up` aggregates each subtree bottom-up (leaf = the binding's
filter/liveness mask), `down` pushes the rest of the tree back down
with per-child sibling-exclusive products.  Wrapped counts can hit 0
mod 2^64 on astronomically large results, so emptiness rides a
parallel boolean semiring (`exists` flags, exact), never the wrapped
counts.  Disconnected components multiply: each component's total
count scales every other component's checksums (the cartesian phase of
engine/oracle.py:163-180, reference inter_res.c:391-428).

Applicability: the join multigraph (after filters/self-joins fold into
per-binding masks) must be a forest — no duplicate binding pairs, no
cycles.  `plan_forest` returns None otherwise and callers fall back to
the materializing engine.  This is capability the reference C engine
does not have in any form; it exists because the engine's data-parallel
sort/prefix primitives make the message-passing formulation natural.

Two twin implementations share `plan_forest`:
  * `execute_query_factorized_np` — NumPy, the independent oracle for
    blowup queries (workload generation + differential tests);
  * `factorized_result` — JAX on padded device columns (static shapes,
    few distinct (Ps, Pr) jit signatures thanks to size classes),
    returning a PendingResult for the engine's retry chain.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..frontend.parser import FilterPred, Query

_MASK64 = (1 << 64) - 1


# ---------------------------------------------------------------------------
# Shared host-side plan
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _Edge:
    parent: int
    child: int
    pcol: int  # join column on the parent binding
    ccol: int  # join column on the child binding


@dataclasses.dataclass(frozen=True)
class ForestPlan:
    nodes: Tuple[int, ...]           # all participating bindings
    comps: Tuple[Tuple[int, ...], ...]  # bindings per connected component
    roots: Tuple[int, ...]           # one root per component
    # BFS-ordered edges per component (parents precede children)
    edges: Tuple[Tuple[_Edge, ...], ...]


def plan_forest(query: Query) -> Optional[ForestPlan]:
    """The join forest, or None when the join multigraph has a duplicate
    binding pair or a cycle (the materializing engine handles those)."""
    joins = query.joins
    nodes = set(b for b, _ in query.views)
    for p in query.filters_and_selfjoins:
        nodes.add(p.binding if isinstance(p, FilterPred) else p.binding1)
    adj: Dict[int, List[Tuple[int, int, int]]] = {}
    seen_pairs = set()
    parent_uf: Dict[int, int] = {}

    def find(x: int) -> int:
        while parent_uf.setdefault(x, x) != x:
            parent_uf[x] = parent_uf[parent_uf[x]]
            x = parent_uf[x]
        return x

    for jp in joins:
        if jp.binding1 == jp.binding2:  # defensive: parser routes these
            return None                 # to filters_and_selfjoins
        pair = jp.pair()
        if pair in seen_pairs:
            return None  # multi-edge (compound key): not a tree edge
        seen_pairs.add(pair)
        r1, r2 = find(jp.binding1), find(jp.binding2)
        if r1 == r2:
            return None  # cycle
        parent_uf[r1] = r2
        nodes.add(jp.binding1)
        nodes.add(jp.binding2)
        adj.setdefault(jp.binding1, []).append(
            (jp.binding2, jp.column1, jp.column2))
        adj.setdefault(jp.binding2, []).append(
            (jp.binding1, jp.column2, jp.column1))

    # Root each component at a VIEW binding when one exists: the down
    # sweep then only needs edges on root->view paths (down_edges
    # below), and a single-view component needs NO down messages at
    # all — each message costs ~6 device gathers of the padded column
    # length, the dominant cost of the at-scale factorized path.
    view_b = {b for b, _ in query.views}
    comp_sets: List[set] = []
    seen = set()
    for start in sorted(nodes):
        if start in seen:
            continue
        comp, frontier = {start}, [start]
        seen.add(start)
        while frontier:
            u = frontier.pop()
            for v, _, _ in adj.get(u, ()):
                if v not in seen:
                    seen.add(v)
                    comp.add(v)
                    frontier.append(v)
        comp_sets.append(comp)

    comps: List[Tuple[int, ...]] = []
    roots: List[int] = []
    all_edges: List[Tuple[_Edge, ...]] = []
    for comp_set in comp_sets:
        vb = sorted(comp_set & view_b)
        start = vb[0] if vb else min(comp_set)
        comp, edges, frontier = [start], [], [start]
        visited = {start}
        while frontier:
            u = frontier.pop()
            for v, ucol, vcol in adj.get(u, ()):
                if v in visited:
                    continue
                visited.add(v)
                comp.append(v)
                edges.append(_Edge(parent=u, child=v, pcol=ucol, ccol=vcol))
                frontier.append(v)
        comps.append(tuple(comp))
        roots.append(start)
        all_edges.append(tuple(edges))
    return ForestPlan(nodes=tuple(sorted(nodes)), comps=tuple(comps),
                      roots=tuple(roots), edges=tuple(all_edges))


def down_edges(plan: ForestPlan, query: Query) -> set:
    """The edges whose DOWN message is actually consumed: those on some
    root->view-binding path (down_w is only read at view bindings; up
    messages always run).  Everything else's down message is skipped."""
    parent_of: Dict[int, _Edge] = {}
    for edges in plan.edges:
        for e in edges:
            parent_of[e.child] = e
    needed: set = set()
    for b, _ in query.views:
        e = parent_of.get(b)
        while e is not None and e not in needed:
            needed.add(e)
            e = parent_of.get(e.parent)
    return needed


# ---------------------------------------------------------------------------
# NumPy twin — the independent oracle for blowup queries
# ---------------------------------------------------------------------------


def _np_msg_cached(sw: np.ndarray, se: np.ndarray, order: np.ndarray,
                   lo: np.ndarray, hi: np.ndarray):
    """Per-receiver-row (sum of sender weights, any sender exists) over
    key equality: group-by via sort + prefix sums, no materialization.
    The edge's query-independent artifacts (sender sort order, receiver
    rank ranges) are precomputed by _np_edge_ranks — the NumPy mirror
    of the JAX twin's edge_ranks cache — so per message only the weight
    gather + two cumsums + four prefix gathers remain."""
    pw = np.concatenate([[np.uint64(0)],
                         np.cumsum(sw[order], dtype=np.uint64)])
    pe = np.concatenate([[0], np.cumsum(se[order].astype(np.int64))])
    return pw[hi] - pw[lo], (pe[hi] - pe[lo]) > 0


def _np_edge_ranks(catalog, srel: int, scol: int, rrel: int, rcol: int,
                   skey: np.ndarray, rkey: np.ndarray):
    """(order, lo, hi) for a (sender column, receiver column) pair —
    query-independent (base columns are immutable), cached on the
    catalog.  The sender argsort and the two rank queries were the
    dominant cost of the host factorized tier (re-run per message per
    query); with the cache, the scaled workload's host pass drops
    ~2.5x."""
    cache = catalog.__dict__.setdefault("_np_edge_ranks", {})
    key = (srel, scol, rrel, rcol)
    hit = cache.get(key)
    if hit is None:
        # two-level: the sender column's sort is shared across every
        # edge it participates in (queries join the same key columns
        # against different receivers)
        scache = catalog.__dict__.setdefault("_np_col_sort", {})
        sk = scache.get((srel, scol))
        if sk is None:
            order = np.argsort(skey, kind="stable")
            sk = (order, skey[order])
            scache[(srel, scol)] = sk
        order, ks = sk
        lo = np.searchsorted(ks, rkey, side="left")
        hi = np.searchsorted(ks, rkey, side="right")
        hit = (order, lo, hi)
        cache[key] = hit
    return hit


def execute_query_factorized_np(query: Query, catalog) -> Optional[str]:
    """Exact result line via NumPy message passing, or None when the
    query is not a forest.  Differentially equal to
    oracle.execute_query_numpy wherever the latter can materialize."""
    plan = plan_forest(query)
    if plan is None:
        return None

    def col(b: int, c: int) -> np.ndarray:
        dense = getattr(catalog, "dense_column", None)
        raw = (dense(query.relations[b], c) if dense is not None
               else catalog.column(query.relations[b], c))
        return np.asarray(raw, dtype=np.uint64)

    # Per-binding masks: filters + self-joins (oracle phase 1).
    mask: Dict[int, np.ndarray] = {}
    for b in plan.nodes:
        n = catalog.relation(query.relations[b]).num_tuples
        mask[b] = np.ones(n, dtype=bool)
    for p in query.filters_and_selfjoins:
        if isinstance(p, FilterPred):
            vals = col(p.binding, p.column)
            v = np.uint64(p.value & _MASK64)
            m = (vals < v if p.op == "<"
                 else vals > v if p.op == ">" else vals == v)
            mask[p.binding] &= m
        else:
            mask[p.binding1] &= (col(p.binding1, p.column1)
                                 == col(p.binding1, p.column2))

    if not all(mask[b].any() for b in plan.nodes):
        return " ".join("NULL" for _ in query.views)

    up_w = {b: mask[b].astype(np.uint64) for b in plan.nodes}
    up_e = {b: mask[b].copy() for b in plan.nodes}
    msg_w: Dict[_Edge, np.ndarray] = {}
    msg_e: Dict[_Edge, np.ndarray] = {}
    down_w: Dict[int, np.ndarray] = {}
    down_e: Dict[int, np.ndarray] = {}

    def edge(sb, sc, rb, rc):
        return _np_edge_ranks(catalog, query.relations[sb], sc,
                              query.relations[rb], rc,
                              col(sb, sc), col(rb, rc))

    need_down = down_edges(plan, query)
    for comp, root, edges in zip(plan.comps, plan.roots, plan.edges):
        for e in reversed(edges):  # children complete before parents
            mw, me = _np_msg_cached(up_w[e.child], up_e[e.child],
                                    *edge(e.child, e.ccol,
                                          e.parent, e.pcol))
            msg_w[e], msg_e[e] = mw, me
            up_w[e.parent] = up_w[e.parent] * mw
            up_e[e.parent] &= me
        down_w[root] = np.ones_like(up_w[root])
        down_e[root] = np.ones_like(up_e[root])
        for e in edges:  # parents complete before children
            if e not in need_down:  # down_w never read below this edge
                continue
            excl_w = down_w[e.parent] * mask[e.parent].astype(np.uint64)
            excl_e = down_e[e.parent] & mask[e.parent]
            for sib in edges:
                if sib.parent == e.parent and sib is not e:
                    excl_w = excl_w * msg_w[sib]
                    excl_e &= msg_e[sib]
            dmw, dme = _np_msg_cached(excl_w, excl_e,
                                      *edge(e.parent, e.pcol,
                                            e.child, e.ccol))
            down_w[e.child], down_e[e.child] = dmw, dme

    cnt_w = [np.add.reduce(up_w[r], dtype=np.uint64) for r in plan.roots]
    exists = all(bool(up_e[r].any()) for r in plan.roots)
    if not exists:
        return " ".join("NULL" for _ in query.views)

    comp_of = {b: i for i, comp in enumerate(plan.comps) for b in comp}
    sums = []
    for b, c in query.views:
        m = up_w[b] * down_w[b]
        s = np.add.reduce(m * col(b, c), dtype=np.uint64)
        for i, cw in enumerate(cnt_w):
            if i != comp_of[b]:
                s = s * cw
        sums.append(str(int(s) & _MASK64))
    return " ".join(sums)


# ---------------------------------------------------------------------------
# JAX executor on padded device columns
# ---------------------------------------------------------------------------


def _jax_ops():
    import jax
    import jax.numpy as jnp
    return jax, jnp


def _msg_jit_factory():
    import jax
    import jax.numpy as jnp

    @jax.jit
    def msg(sw, se, inv, lo, hi):
        """[Ps] sender weights/exists + the edge's CACHED rank
        artifacts -> ([Pr] u64 sum, [Pr] i32 count>0).

        The expensive parts of a message — the sender key sort and the
        receiver rank queries — depend only on the two BASE key
        columns, never on the query: `inv` is the INVERSE of the
        sender's prep-time sort permutation as a u32 sort key (row j's
        rank in key order) and lo/hi are each receiver row's match
        range in that order, computed once per edge per process
        (_edge_ranks).  Reordering the weights into key order runs as
        ONE u32-keyed 3-array sort instead of a permutation gather, a
        trade made for a backend where gathers were slow (ROADMAP S6:
        re-measure on the GPU).  What remains is two cumsums + four
        prefix gathers.

        Dead/padded sender rows carry weight 0 and exists 0 (liveness
        folded into the mask), so no live-length arguments are
        needed."""
        _, sw_s, se_s = jax.lax.sort((inv, sw, se), num_keys=1,
                                     is_stable=False)
        pw = jnp.concatenate([jnp.zeros(1, jnp.uint64),
                              jnp.cumsum(sw_s, dtype=jnp.uint64)])
        pe = jnp.concatenate([jnp.zeros(1, jnp.int32),
                              jnp.cumsum(se_s.astype(jnp.int32))])
        return (jnp.take(pw, hi) - jnp.take(pw, lo),
                ((jnp.take(pe, hi) - jnp.take(pe, lo)) > 0
                 ).astype(jnp.int32))

    return msg


def _ranks_jit_factory():
    import jax
    import jax.numpy as jnp

    @jax.jit
    def ranks(ks, rk):
        """(lo, hi) i32 ranks of every receiver key in the sorted
        sender keys — duplicate-run-safe (method="sort", see
        ops/sort_join.py; u64 keys rank via ops/lsd.py)."""
        if ks.dtype == jnp.uint64:
            from ..ops.lsd import ranks_u64

            lo = ranks_u64(ks, rk, side="left")
            hi = ranks_u64(ks, rk, side="right")
        else:
            lo = jnp.searchsorted(ks, rk, side="left", method="sort")
            hi = jnp.searchsorted(ks, rk, side="right", method="sort")
        return lo.astype(jnp.int32), hi.astype(jnp.int32)

    return ranks


_MSG_JIT = None
_RANKS_JIT = None


def factorized_result(engine, query: Query):
    """Execute `query` on `engine`'s device columns via message passing.
    Returns a PendingResult ([exists, sums...] packed vector — the
    count slot only gates NULL formatting, so it carries the exact
    boolean, immune to mod-2^64 wrap), or None when not a forest."""
    global _MSG_JIT, _RANKS_JIT
    plan = plan_forest(query)
    if plan is None:
        return None
    jax, jnp = _jax_ops()
    if _MSG_JIT is None:
        _MSG_JIT = _msg_jit_factory()
        _RANKS_JIT = _ranks_jit_factory()
    msg = _MSG_JIT
    ranks = _RANKS_JIT
    from .executor import PendingResult

    cols: Dict[Tuple[int, int], Tuple] = {}

    def col(b: int, c: int):
        key = (b, c)
        if key not in cols:
            cols[key] = engine.device_column(query.relations[b], c)
        return cols[key]

    def key32_of(b: int, c: int) -> bool:
        """True when catalog stats bound the column under 2^32: message
        keys then sort as u32 — half the key bytes, and each msg() is
        one variadic sort + two rank sorts, so a 3-edge tree pays ~18
        sort equivalents per execution."""
        stats = getattr(engine.catalog, "stats", None)
        if not stats:
            return False
        try:
            return stats[query.relations[b]][c].u < (1 << 32)
        except (IndexError, TypeError, AttributeError):
            return False

    def edge_ranks(sb, sc, rb, rc):
        """The edge's query-independent message artifacts
        (inv, lo, hi), cached on the engine per (relation, column)
        pair: inv = the INVERSE of the sender base column's prep-time
        sort permutation as a u32 key (row j's rank in key order —
        msg() reorders weights with one u32-keyed sort instead of a
        permutation gather), lo/hi = every receiver row's match range
        in that order.  Keys downcast to u32 when BOTH endpoint
        columns' stats allow (half the key bytes); pad rows
        carry weight 0 and exists 0, so their key values never
        matter."""
        ck = (query.relations[sb], sc, query.relations[rb], rc)
        ecache = engine.__dict__.setdefault("_fact_edge_ranks", {})
        hit = ecache.get(ck)
        if hit is None:
            sk64, perm = engine.device_sorted_column(
                query.relations[sb], sc)
            rk = col(rb, rc)[0]
            if key32_of(sb, sc) and key32_of(rb, rc):
                lo, hi = ranks(sk64.astype(jnp.uint32),
                               rk.astype(jnp.uint32))
            else:
                lo, hi = ranks(sk64, rk)
            # invert the permutation with a sort (not a scatter):
            # sorting (perm, iota) by perm puts iota value i at
            # position perm[i] -> the second output IS the rank of
            # every row, i.e. the u32 sort key msg() needs.
            iota = jnp.arange(perm.shape[0], dtype=jnp.uint32)
            _, inv = jax.lax.sort((perm.astype(jnp.uint32), iota),
                                  num_keys=1, is_stable=False)
            hit = (inv, lo, hi)
            ecache[ck] = hit
        return hit

    mask: Dict[int, object] = {}
    for b in plan.nodes:
        dev, n = col(b, 0)
        live = jnp.arange(dev.shape[0], dtype=jnp.int32) < jnp.int32(n)
        mask[b] = live
    for p in query.filters_and_selfjoins:
        if isinstance(p, FilterPred):
            dev, _ = col(p.binding, p.column)
            v = jnp.uint64(p.value & _MASK64)
            m = (dev < v if p.op == "<"
                 else dev > v if p.op == ">" else dev == v)
            mask[p.binding] = mask[p.binding] & m
        else:
            d1, _ = col(p.binding1, p.column1)
            d2, _ = col(p.binding1, p.column2)
            mask[p.binding1] = mask[p.binding1] & (d1 == d2)

    # No emptiness sync: the packed vector's exact `exists` flag (the
    # boolean semiring below) gates NULL at format time, so an empty
    # mask anywhere still answers correctly with ZERO blocking host
    # syncs.  (An early-exit sync used to pay for itself when each
    # message re-sorted its sender; with the per-edge rank cache a
    # message sweep is cheap, while every sync blocks the batch
    # pipeline.)

    up_w = {b: mask[b].astype(jnp.uint64) for b in plan.nodes}
    up_e = {b: mask[b].astype(jnp.int32) for b in plan.nodes}
    msg_w: Dict[_Edge, object] = {}
    msg_e: Dict[_Edge, object] = {}
    down_w: Dict[int, object] = {}
    down_e: Dict[int, object] = {}

    need_down = down_edges(plan, query)
    for comp, root, edges in zip(plan.comps, plan.roots, plan.edges):
        for e in reversed(edges):
            mw, me = msg(up_w[e.child], up_e[e.child],
                         *edge_ranks(e.child, e.ccol, e.parent, e.pcol))
            msg_w[e], msg_e[e] = mw, me
            up_w[e.parent] = up_w[e.parent] * mw
            up_e[e.parent] = up_e[e.parent] * me
        down_w[root] = jnp.ones_like(up_w[root])
        down_e[root] = jnp.ones_like(up_e[root])
        for e in edges:
            if e not in need_down:  # down_w never read below this edge
                continue
            excl_w = down_w[e.parent] * mask[e.parent].astype(jnp.uint64)
            excl_e = down_e[e.parent] * mask[e.parent].astype(jnp.int32)
            for sib in edges:
                if sib.parent == e.parent and sib is not e:
                    excl_w = excl_w * msg_w[sib]
                    excl_e = excl_e * msg_e[sib]
            dmw, dme = msg(excl_w, excl_e,
                           *edge_ranks(e.parent, e.pcol, e.child, e.ccol))
            down_w[e.child], down_e[e.child] = dmw, dme

    cnt_w = [jnp.sum(up_w[r], dtype=jnp.uint64) for r in plan.roots]
    exists = jnp.ones((), jnp.int32)
    for r in plan.roots:
        exists = exists * (jnp.max(up_e[r]) > 0).astype(jnp.int32)

    comp_of = {b: i for i, comp in enumerate(plan.comps) for b in comp}
    parts = [exists.astype(jnp.uint64).reshape(1)]
    for b, c in query.views:
        m = up_w[b] * down_w[b]
        s = jnp.sum(m * col(b, c)[0], dtype=jnp.uint64)
        for i, cw in enumerate(cnt_w):
            if i != comp_of[b]:
                s = s * cw
        parts.append(s.reshape(1))
    return PendingResult(jnp.concatenate(parts), len(query.views))
