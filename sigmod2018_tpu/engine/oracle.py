"""NumPy oracle executor — trivially-correct reference semantics.

This is the semantic twin of the C++ skeleton's Joiner/Operators engine
(Operators.cpp, Joiner.cpp): fully materializing, no padding, no device.
It exists so every JAX operator can be differentially tested against
a second, independent implementation (SURVEY §7.2 step 1).

Semantics (reference: query.c:325-467, inter_res.c, filter.c):
- intermediate result = set of *components*; each component maps a binding
  to an equal-length vector of base-table row-ids,
- filters/self-joins first, then joins; a join whose two bindings are
  already in one component degenerates to a value-equality selection
  (reference JoinInterNode, inter_res.c:363-389),
- empty result at any point => one "NULL ..." line (the C++ oracle's
  NULL-iff-empty rule, Joiner.cpp:108),
- output = wrap-around uint64 SUM per view, space-separated.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..frontend.parser import FilterPred, JoinPred, Query
from ..storage.catalog import Catalog

_MASK64 = (1 << 64) - 1

Component = Dict[int, np.ndarray]  # binding -> row-ids (int64)


def _find(components: List[Component], binding: int) -> Optional[Component]:
    for c in components:
        if binding in c:
            return c
    return None


def _apply_filter_mask(components: List[Component], comp: Optional[Component],
                       binding: int, mask_fn) -> int:
    """Apply a row mask over `binding`'s rows; returns surviving count."""
    if comp is None:
        n_mask = mask_fn(None)  # mask over the base relation
        rowids = np.nonzero(n_mask)[0].astype(np.int64)
        components.append({binding: rowids})
        return rowids.size
    mask = mask_fn(comp[binding])
    for b in comp:
        comp[b] = comp[b][mask]
    return comp[binding].size


def _join_pairs(keys_l: np.ndarray, keys_r: np.ndarray,
                max_rows: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
    """All (i, j) with keys_l[i] == keys_r[j], vectorized sort+searchsorted."""
    order = np.argsort(keys_r, kind="stable")
    sorted_r = keys_r[order]
    lo = np.searchsorted(sorted_r, keys_l, side="left")
    hi = np.searchsorted(sorted_r, keys_l, side="right")
    cnt = hi - lo
    total = int(cnt.sum())
    if max_rows is not None and total > max_rows:
        # checked BEFORE materializing: Zipf keys can explode to billions
        # of pairs (workload-generator guard)
        raise OracleOverflow(f"{total} join pairs > cap {max_rows}")
    if total == 0:
        return (np.empty(0, dtype=np.int64), np.empty(0, dtype=np.int64))
    li = np.repeat(np.arange(keys_l.size, dtype=np.int64), cnt)
    # offsets within each run of matches
    ccum = np.cumsum(cnt)
    starts = ccum - cnt
    within = np.arange(total, dtype=np.int64) - np.repeat(starts, cnt)
    rj = order[np.repeat(lo, cnt) + within]
    return li, rj


class OracleOverflow(RuntimeError):
    """An intermediate exceeded max_rows (workload-generator guard)."""


def execute_query_numpy(query: Query, catalog: Catalog,
                        join_order: Optional[Sequence[JoinPred]] = None,
                        max_rows: Optional[int] = None) -> str:
    components: List[Component] = []

    def guard(n: int) -> None:
        if max_rows is not None and n > max_rows:
            raise OracleOverflow(f"{n} rows > cap {max_rows}")

    def col(binding: int, column: int) -> np.ndarray:
        dense = getattr(catalog, "dense_column", None)
        if dense is not None:
            return dense(query.relations[binding], column)
        return catalog.column(query.relations[binding], column)

    # ---- phase 1: filters and self-joins ------------------------------
    for pred in query.filters_and_selfjoins:
        if isinstance(pred, FilterPred):
            c = col(pred.binding, pred.column)
            v = np.uint64(pred.value & _MASK64)
            op = pred.op

            def mask_fn(rowids, c=c, v=v, op=op):
                vals = c if rowids is None else c[rowids]
                if op == "<":
                    return vals < v
                if op == ">":
                    return vals > v
                return vals == v

            n = _apply_filter_mask(components, _find(components, pred.binding),
                                   pred.binding, mask_fn)
        else:  # self-join: two columns of the same bound relation are equal
            c1 = col(pred.binding1, pred.column1)
            c2 = col(pred.binding1, pred.column2)

            def mask_fn(rowids, c1=c1, c2=c2):
                if rowids is None:
                    return c1 == c2
                return c1[rowids] == c2[rowids]

            n = _apply_filter_mask(components, _find(components, pred.binding1),
                                   pred.binding1, mask_fn)
        if n == 0:
            return _null_line(query)

    # ---- phase 2: joins ------------------------------------------------
    joins = list(join_order) if join_order is not None else query.joins
    for jp in joins:
        comp_l = _find(components, jp.binding1)
        comp_r = _find(components, jp.binding2)
        if comp_l is not None and comp_l is comp_r:
            # both bindings already in one component: value-equality selection
            vals1 = col(jp.binding1, jp.column1)[comp_l[jp.binding1]]
            vals2 = col(jp.binding2, jp.column2)[comp_l[jp.binding2]]
            mask = vals1 == vals2
            for b in comp_l:
                comp_l[b] = comp_l[b][mask]
            n = int(mask.sum())
        else:
            keys_l = (col(jp.binding1, jp.column1)[comp_l[jp.binding1]]
                      if comp_l is not None else col(jp.binding1, jp.column1))
            keys_r = (col(jp.binding2, jp.column2)[comp_r[jp.binding2]]
                      if comp_r is not None else col(jp.binding2, jp.column2))
            li, rj = _join_pairs(keys_l, keys_r, max_rows=max_rows)
            new_comp: Component = {}
            if comp_l is not None:
                for b in comp_l:
                    new_comp[b] = comp_l[b][li]
                components[:] = [c for c in components if c is not comp_l]
            else:
                new_comp[jp.binding1] = li
            if comp_r is not None:
                for b in comp_r:
                    new_comp[b] = comp_r[b][rj]
                components[:] = [c for c in components if c is not comp_r]
            else:
                new_comp[jp.binding2] = rj
            components.append(new_comp)
            n = li.size
        if n == 0:
            return _null_line(query)
        guard(n)

    # ---- phase 3: cartesian product of leftover components -------------
    # (reference: CartesianInterResults, inter_res.c:391-428; bindings that
    # appear only in views behave as full relations)
    for b, _ in query.views:
        if _find(components, b) is None:
            nrows = catalog.relation(query.relations[b]).num_tuples
            components.append({b: np.arange(nrows, dtype=np.int64)})
    while len(components) > 1:
        c1, c2 = components[0], components[1]
        n1 = next(iter(c1.values())).size
        n2 = next(iter(c2.values())).size
        guard(n1 * n2)
        merged: Component = {}
        for b in c1:
            merged[b] = np.repeat(c1[b], n2)
        for b in c2:
            merged[b] = np.tile(c2[b], n1)
        components = [merged] + components[2:]

    if not components or next(iter(components[0].values())).size == 0:
        return _null_line(query)

    # ---- phase 4: checksums --------------------------------------------
    comp = components[0]
    sums = []
    for b, c in query.views:
        vals = col(b, c)[comp[b]]
        # wrap-around uint64 sum (reference: inter_res.c:330-334)
        s = int(np.add.reduce(vals, dtype=np.uint64)) & _MASK64
        sums.append(str(s))
    return " ".join(sums)


def _null_line(query: Query) -> str:
    return " ".join("NULL" for _ in query.views)
