"""The JAX query VM: dense row-id intermediate results + operator dispatch.

This is the data-parallel restatement of the reference's interpreter
(ExecuteQuery, query.c:325-467) and intermediate-result machinery
(inter_res.c).  Differences by design (SURVEY §7.1):

- an intermediate component is a dense [A, P] int32 row-id matrix on device
  (A = active bindings, P = power-of-two padded row count) instead of a
  linked list of malloc'd columns (structs.h:97-111),
- every operator is a statically-shaped jitted XLA program,
- the pthread scheduler (scheduler.c) has no equivalent: intra-device
  parallelism is XLA's, cross-device parallelism lives in parallel/.

Host-sync discipline (every device→host readback stalls the host until
the device queue drains, so the engine keeps them rare):

- filter / self-join / same-component-join counts stay ON DEVICE as int32
  scalars threaded into the next operator's `n_valid`; no readback,
- only an intermediate join syncs (its output cardinality sizes the next
  static shape — SURVEY §7.3 "dynamic shapes everywhere"),
- the LAST join of a query is fused with the checksum (ops/agg_join.py):
  the final — usually largest — intermediate is never materialized and
  costs no sync,
- execute_async() returns a PendingResult whose single packed device
  vector [count, sum_0, ..sum_V] is fetched once, when the protocol
  layer formats the output line; whole batches pipeline on the device.

Empty-result semantics: the reference short-circuits to a NULL line the
moment any operator yields zero rows (query.c:358-371).  Deferring counts
keeps the same observable output — every operator preserves emptiness, so
final count == 0  ⇔  some operator went empty  ⇔  NULL line
(the oracle's NULL-iff-empty rule, Joiner.cpp:108).
"""

from __future__ import annotations

import dataclasses
import sys
import threading
from typing import Dict, List, Optional, Sequence, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

from ..config import DEFAULT_CONFIG, EngineConfig
from ..frontend.parser import FilterPred, JoinPred, Query
from ..storage.catalog import Catalog
from ..utils.padding import pad_to, size_class
from .. import ops

_MASK64 = (1 << 64) - 1

_cast_u32 = jax.jit(lambda a: a.astype(jnp.uint32))

Count = Union[int, jax.Array]  # host int or device int32/uint64 scalar


def _n32(n: Count) -> jax.Array:
    if isinstance(n, jax.Array):
        return n if n.dtype == jnp.int32 else n.astype(jnp.int32)
    return jnp.int32(n)


def _u64(n: Count) -> jax.Array:
    if isinstance(n, jax.Array):
        return n if n.dtype == jnp.uint64 else n.astype(jnp.uint64)
    return jnp.uint64(n)


@dataclasses.dataclass
class Component:
    """One connected piece of the intermediate result."""

    bindings: Tuple[int, ...]  # order matches table rows
    table: jax.Array  # [len(bindings), P] int32 row-ids into base tables
    count: Count  # live rows (host int once known, else device scalar)

    def row(self, binding: int) -> jax.Array:
        return self.table[self.bindings.index(binding)]


class PendingResult:
    """A query's answer as one device vector [count, sum_0, ... sum_{V-1}]
    (uint64).  `line()` performs the single host readback and formats."""

    def __init__(self, packed: jax.Array, num_views: int):
        self.packed = packed
        self.num_views = num_views

    @property
    def packed_len(self) -> int:
        return 1 + self.num_views

    # Optional recovery closure: re-runs the query through the plain
    # jit path when the DEVICE execution behind `packed` failed (async
    # dispatch defers program errors to the fetch, past any try/except
    # at dispatch time — e.g. a stale vault-served program).  Without
    # it a poisoned program would surface as a per-query NULL through
    # the REPL's fault isolation: a WRONG ANSWER, not an error.
    fetch_retry = None

    def line_from(self, arr) -> str:
        """Format from an already-fetched host copy of `packed`."""
        if int(arr[0]) == 0:
            return " ".join("NULL" for _ in range(self.num_views))
        return " ".join(str(int(v) & _MASK64) for v in arr[1:])

    def line(self) -> str:
        try:
            arr = np.asarray(self.packed)
        except Exception as exc:  # noqa: BLE001 — deferred program failure
            if self.fetch_retry is None:
                raise
            # A failed fetch on a healthy device is a device fault: say
            # so before the query is served again.
            print(f"result fetch failed ({exc!r}); re-serving the query",
                  file=sys.stderr)
            return self.fetch_retry()
        return self.line_from(arr)


class ServeCounters:
    """Queries answered per serving tier, shared by the engine and the
    REPL (io/repl.py; thread-safe: batch workers count concurrently).

    - ``warmup_host``: answered by the host oracle before the device
      engine finished its prep (io/repl.py warm-up tier);
    - ``failure_host``: answered by the host oracle after a device-side
      failure (JaxEngine._last_resort);
    - ``fetch_failed``: result fetches that raised and went to the
      query's recovery path (re-run on the device, or the host).

    Every query the REPL hands the engine that is not a failure_host
    answer is a device answer; the REPL derives that count."""

    def __init__(self):
        self._lock = threading.Lock()
        self.counts: Dict[str, int] = {
            "warmup_host": 0, "failure_host": 0, "fetch_failed": 0}

    def add(self, name: str, n: int = 1) -> None:
        with self._lock:
            self.counts[name] += n

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self.counts)


class IntermediateBlowup(RuntimeError):
    """A planned join order produced an intermediate beyond the cap."""


# Technical ceiling on any materialized intermediate, independent of the
# configurable max_intermediate guard: past this, row-id tables stop
# fitting HBM comfortably (and size classes would overflow int32 index
# space well before 2^31).  Queries that exceed it under EVERY join
# order are answered by the factorized path (engine/factorized.py)
# when the join graph is a forest — the reference C engine, with no cap
# at all, simply dies on these (its materialization is the same
# algorithm, inter_res.c:320-389).
HARD_INTERMEDIATE_CAP = 1 << 27


class NullResult:
    """Known-empty early exit (host already observed a zero cardinality)."""

    def __init__(self, num_views: int):
        self.num_views = num_views

    def line(self) -> str:
        return " ".join("NULL" for _ in range(self.num_views))


Result = Union[PendingResult, NullResult]


def format_batch(results: Sequence) -> List[str]:
    """Format a batch of results with ONE device→host transfer.

    Each fetch synchronizes the host with the device; a 50-query batch
    pays that once by concatenating every PendingResult's packed vector
    on device first.  Non-Pending entries (NullResult, plain
    error strings) pass through."""
    pend = [r for r in results if isinstance(r, PendingResult)]
    if len(pend) > 1:
        try:
            flat = np.asarray(jnp.concatenate([r.packed for r in pend]))
            off = 0
            for r in pend:
                r._fetched = flat[off:off + r.packed_len]  # type: ignore
                off += r.packed_len
        except Exception:  # noqa: BLE001 — one poisoned program must
            pass           # not fail the batch: fall through to the
                           # per-result fetches (each with its own
                           # fetch_retry recovery)
    lines = []
    for r in results:
        if isinstance(r, str):
            lines.append(r)
        elif isinstance(r, PendingResult) and getattr(r, "_fetched", None) is not None:
            # Speculative results validate here and may re-dispatch
            # (SpecResult.line_from) — still after the one flat fetch.
            lines.append(r.line_from(r._fetched))  # type: ignore
        else:
            lines.append(r.line())
    return lines


class JaxEngine:
    """Executes contest queries against a Catalog on the JAX backend."""

    # Single-chip prep-time join artifacts (presorted columns, key
    # tables, prefix tables) feed the fused join directly; the mesh
    # engine re-partitions the build side across chips in its shuffle,
    # so they do not apply there (dist_engine.py sets this False).
    prep_join_artifacts = True

    def __init__(self, catalog: Catalog, config: EngineConfig = DEFAULT_CONFIG):
        self.catalog = catalog
        self.config = config
        self.counters = ServeCounters()
        self._columns: Dict[Tuple[int, int], Tuple[jax.Array, int]] = {}
        self._planner = None
        if config.optimize_joins:
            from ..planner import plan_joins

            self._planner = plan_joins
        self._ops = ops
        self._tracer = None
        if config.trace:
            from .trace import TimedOps, Tracer

            self._tracer = Tracer(
                mode="json" if config.trace == "json" else "table")
            self._ops = TimedOps(ops, self._tracer)

    # ---- storage ---------------------------------------------------------

    def device_column(self, rid: int, cid: int) -> Tuple[jax.Array, int]:
        """Base column as a padded device array + live length."""
        key = (rid, cid)
        hit = self._columns.get(key)
        if hit is not None:
            return hit
        col = np.asarray(self.catalog.column(rid, cid), dtype=np.uint64)
        n = col.shape[0]
        dev = jnp.asarray(pad_to(col, size_class(n, self.config.min_pad)))
        self._columns[key] = (dev, n)
        return dev, n

    def device_sorted_column(self, rid: int, cid: int,
                             key32: bool = False):
        """Prep-time sort of a base column: (sorted_keys, perm) with pads
        forced to dtype-max, as produced by ops.join_build.  The contest
        prep window is untimed (harness.cpp:175-208), so any join whose
        build side is an unfiltered base column skips its argsort at
        query time.  The u64 sort is canonical; the key32 variant is a
        cached order-preserving downcast of it (bit-identical to sorting
        u32 directly — values < 2^32, stable ties by index)."""
        cache = self.__dict__.setdefault("_sorted_columns", {})
        key = (rid, cid, key32)
        hit = cache.get(key)
        if hit is not None:
            return hit
        if key32:
            sk64, perm = self.device_sorted_column(rid, cid, False)
            pair = (_cast_u32(sk64), perm)
        else:
            dev, n = self.device_column(rid, cid)
            pair = ops.join_build(dev, jnp.int32(n))
        cache[key] = pair
        return pair

    def device_key_table(self, rid: int, cid: int):
        """Domain rank table of a base column, or None when gated off:
        cumcnt[k] = #rows with key < k, k in [0, u+2], u = the column's
        exact max (catalog stats) — u+3 i32 entries, so the table's
        shape statically encodes u.  The data-parallel restatement of
        the reference's bucket-chain index (rhjoin.c:219-309): a probe
        row's match range in the prep-sorted column is two gathers, no
        sort.
        Built host-side (one bincount+cumsum pass) in the untimed prep
        window."""
        cache = self.__dict__.setdefault("_key_tables", {})
        key = (rid, cid)
        if key in cache:
            return cache[key]
        tbl = None
        stats = getattr(self.catalog, "stats", None)
        if stats and self.config.key_table_max and self.config.presort:
            try:
                u = int(stats[rid][cid].u)
            except (IndexError, TypeError):
                u = -1
            if 0 <= u and u + 3 <= self.config.key_table_max:
                col = np.asarray(self.catalog.column(rid, cid),
                                 dtype=np.uint64)
                bc = np.bincount(col.astype(np.int64), minlength=u + 1)
                if bc.shape[0] == u + 1:  # stats exact -> always true
                    cumcnt = np.zeros(u + 3, dtype=np.int32)
                    cumcnt[1:u + 2] = np.cumsum(bc)
                    cumcnt[u + 2] = cumcnt[u + 1]
                    tbl = jnp.asarray(cumcnt)
        cache[key] = tbl
        return tbl

    def device_prefix_table(self, rid: int, key_cid: int, val_cid: int):
        """Prep-time prefix sums of a value column in key-sorted order:
        pref[i] = wrap-around u64 sum of column `val_cid` over the first
        i rows when sorted by column `key_cid` (pads contribute 0).
        Shape [P+1].  Paired with device_key_table, this makes a fused
        checksum join PROBE-ONLY at query time (two prefix gathers per
        view replace the per-query build-payload gather + cumsum) — see
        ops.join_checksum_fused_table_pref.  Lazily built and cached;
        prefetch eager-builds the pairs of key-table columns."""
        cache = self.__dict__.setdefault("_prefix_tables", {})
        key = (rid, key_cid, val_cid)
        hit = cache.get(key)
        if hit is None:
            _, perm = self.device_sorted_column(rid, key_cid)
            col, n = self.device_column(rid, val_cid)
            hit = ops.prefix_by_perm(col, perm, jnp.int32(n))
            cache[key] = hit
        return hit

    def prefetch(self) -> None:
        """Push every base column to device, presort it, build its key
        table, and build the prefix-sum tables of every (key-table
        column, value column) pair, ahead of the timed phase (the
        contest's prep window is untimed, harness.cpp:175-177).

        Column-parallel: the device sorts, transfers, and NumPy
        bincounts all release the GIL, so threads overlap them (the
        per-(rid,cid) dict caches are written under the GIL; a racing
        duplicate build is benign — last write wins with equal
        values)."""
        def one_column(rid: int, cid: int, ncols: int) -> None:
            self.device_column(rid, cid)
            if self.config.presort and self.prep_join_artifacts:
                self.device_sorted_column(rid, cid)
                if self.device_key_table(rid, cid) is not None:
                    for vcid in range(ncols):
                        self.device_prefix_table(rid, cid, vcid)

        work = [(rid, cid, rel.num_columns)
                for rid, rel in enumerate(self.catalog.relations)
                for cid in range(rel.num_columns)]
        if len(work) > 1:
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(max_workers=8,
                                    thread_name_prefix="s18prep") as pool:
                list(pool.map(lambda w: one_column(*w), work))
        else:
            for w in work:
                one_column(*w)
        for dev, _ in self._columns.values():
            dev.block_until_ready()

    # ---- execution -------------------------------------------------------

    def execute(self, query: Query) -> str:
        res = self.execute_async(query)
        return res if isinstance(res, str) else res.line()

    # ---- last-resort host execution (device failure recovery) -----------
    # The worst case seen on an earlier backend: one failed device
    # execution left the WHOLE process's device state wedged — every
    # later dispatch (and even trivial programs) raised INVALID_ARGUMENT.
    # No in-process device retry can work then.  The recovery that
    # always works is the host: the NumPy oracle (engine/oracle.py)
    # shares no device state and is exact, so a failed query re-runs
    # there — the answer stays CORRECT (never a NULL-for-wrong-answer),
    # the batch and process survive.
    # When the device itself is unhealthy, the engine flips to
    # oracle-only serving for the rest of the process.  Every answer
    # served here is counted (counters["failure_host"]).

    def _device_healthy(self) -> bool:
        try:
            import jax

            jax.block_until_ready(jnp.zeros((8,), jnp.int32) + 1)
            return True
        except Exception:  # noqa: BLE001 — any failure = unhealthy
            return False

    def _last_resort(self, query: Query) -> Optional[str]:
        """Exact host-side answer after a device-side failure (or None
        when even the oracle cannot answer).  Flips the engine into
        oracle-only mode when the device no longer executes anything."""
        poisoned = self.__dict__.get("_device_poisoned", False)
        if not poisoned and not self._device_healthy():
            self.__dict__["_device_poisoned"] = True
            print("device unhealthy: serving remaining queries from the "
                  "host oracle", file=sys.stderr)
        # Forest-shaped queries first through the factorized NumPy twin
        # (the same math the device factorized path runs): it never
        # materializes, so a blowup query cannot exhaust host memory.
        # The materializing oracle takes the rest, capped like the
        # device path.
        try:
            from .factorized import execute_query_factorized_np

            line = execute_query_factorized_np(query, self.catalog)
            if line is not None:
                return line
            from .oracle import execute_query_numpy

            return execute_query_numpy(query, self.catalog,
                                       max_rows=HARD_INTERMEDIATE_CAP)
        except Exception as exc:  # noqa: BLE001
            print(f"oracle fallback failed: {exc!r} in {query.text!r}",
                  file=sys.stderr)
            return None

    def _last_resort_or_raise(self, query: Query) -> str:
        line = self._last_resort(query)
        if line is None:
            raise RuntimeError(
                f"device failure and oracle fallback failed: {query.text!r}")
        self.counters.add("failure_host")
        return line

    def _counted(self, fetch_retry):
        """A result's fetch-failure recovery, counted in
        counters["fetch_failed"] when it runs."""
        def run() -> str:
            self.counters.add("fetch_failed")
            return fetch_retry()

        return run

    def _maybe_factorized(self, query: Query) -> Optional[Result]:
        """Proactive factorized service (engine/factorized.py): a
        forest-shaped query whose PLANNED max intermediate reaches
        config.factorize_min answers by Yannakakis message passing —
        exact, never materializes the blowup.  The reference engine has
        no equivalent (it always materializes, inter_res.c:34-141).
        Decision cached per text; None -> the materializing path
        serves."""
        if (not self.config.factorize_min
                or getattr(self.config, "mesh_devices", 1) > 1
                or len(query.joins) < 2):
            return None
        cache = self.__dict__.setdefault("_fact_choice", {})
        use = cache.get(query.text)
        if use is False:
            return None
        try:
            from ..planner.join_order import estimate_cardinalities

            joins = (self._planner(query, self.catalog)
                     if self._planner is not None else query.joins)
            ests = estimate_cardinalities(query, self.catalog,
                                          tuple(joins))
        except Exception:  # noqa: BLE001 — estimator failure: materialize
            cache[query.text] = False
            return None
        # Two triggers.  (1) Intermediate estimates measure
        # materialization cost directly (the final join fuses with the
        # checksum and never materializes).  (2) A fused-final estimate
        # 16x past the threshold flags a hot-key blowup the
        # intermediate estimates missed (Zipf workloads: intermediates
        # estimated ~500K, actual 10.9M — 22x under — while the final
        # estimate was 162M and dead right about the blowup); message
        # passing costs O(sum of relation sizes) regardless.
        fmin = self.config.factorize_min
        if (max(ests[:-1], default=0) < fmin
                and ests[-1] < fmin * 16):
            cache[query.text] = False
            return None
        from .factorized import factorized_result

        res = factorized_result(self, query)
        if res is None:  # cyclic / duplicate-pair: not a forest
            cache[query.text] = False
        return res

    def execute_async(self, query: Query) -> Result:
        if self.__dict__.get("_device_poisoned"):
            return self._last_resort_or_raise(query)
        try:
            res = self._maybe_factorized(query)
            if res is None:
                res = self._execute_async_device(query)
        except (IntermediateBlowup, RecursionError):
            raise
        except Exception as exc:  # noqa: BLE001 — dispatch-time failure
            # Log BEFORE falling back (once per query text): a plain
            # code bug on a healthy device would otherwise serve
            # correct-but-slow oracle answers with zero diagnostic
            # output, making device-path regressions invisible.
            logged = self.__dict__.setdefault("_fallback_logged", set())
            if query.text not in logged:
                logged.add(query.text)
                import traceback

                print(f"device dispatch failed ({exc!r}) for "
                      f"{query.text!r}; serving from the host oracle",
                      file=sys.stderr)
                traceback.print_exc(limit=8, file=sys.stderr)
            return self._last_resort_or_raise(query)
        if isinstance(res, PendingResult) and res.fetch_retry is None:
            res.fetch_retry = self._counted(
                lambda: self._last_resort_or_raise(query))
        return res

    def _execute_async_device(self, query: Query) -> Result:
        try:
            return self._dispatch(query, use_planner=True, guard=True)
        except IntermediateBlowup:
            # The planner's order exploded past max_intermediate (hot-key
            # skew the estimator missed).  A forest query is answered
            # exactly WITHOUT materializing anything (factorized message
            # passing); otherwise the original text order is the safety
            # net, bounded by the technical cap.
            from .factorized import factorized_result

            res = factorized_result(self, query)
            if res is not None:
                return res
            return self._dispatch(query, use_planner=False, guard=False)

    def _dispatch(self, query: Query, use_planner: bool,
                  guard: bool) -> Result:
        if self._tracer is not None:
            self._tracer.reset()
            try:
                return self._execute(query, use_planner, guard)
            finally:
                self._tracer.report(query.text)
        return self._execute(query, use_planner, guard)

    def _execute(self, query: Query, use_planner: bool = True,
                 guard: bool = True) -> Result:
        components: List[Component] = []

        def find(binding: int) -> Optional[Component]:
            for c in components:
                if binding in c.bindings:
                    return c
            return None

        def col_of(binding: int, column: int) -> Tuple[jax.Array, int]:
            return self.device_column(query.relations[binding], column)

        # ---- phase 1: filters and self-joins (no host syncs) -------------
        for pred in query.filters_and_selfjoins:
            if isinstance(pred, FilterPred):
                self._exec_filter(components, find, col_of, pred)
            else:
                self._exec_selfjoin(components, find, col_of, pred)

        # ---- phase 2: joins ----------------------------------------------
        joins = query.joins
        if use_planner and self._planner is not None and len(joins) > 1:
            joins = self._planner(query, self.catalog)
        if self.config.explain and joins:
            from ..planner.join_order import estimate_cardinalities

            ests = estimate_cardinalities(query, self.catalog, joins)
            order = " -> ".join(
                f"{j} (est {e})" for j, e in zip(joins, ests)
            )
            print(f"-- plan: {order}", file=sys.stderr)

        view_bindings = {b for b, _ in query.views}
        for idx, jp in enumerate(joins):
            comp_l = find(jp.binding1)
            comp_r = find(jp.binding2)

            if comp_l is not None and comp_l is comp_r:
                # Both sides live in one component: value-equality selection
                # (reference JoinInterNode, inter_res.c:363-389).
                c1dev, _ = col_of(jp.binding1, jp.column1)
                c2dev, _ = col_of(jp.binding2, jp.column2)
                v1 = self._ops.gather_u64(c1dev, comp_l.row(jp.binding1))
                v2 = self._ops.gather_u64(c2dev, comp_l.row(jp.binding2))
                mask = self._ops.equal_mask(v1, v2, _n32(comp_l.count))
                self._compact(components, comp_l, mask)
                continue

            if self.config.fuse_final_join and idx == len(joins) - 1:
                new_bindings = set((jp.binding1, jp.binding2))
                if comp_l is not None:
                    new_bindings |= set(comp_l.bindings)
                if comp_r is not None:
                    new_bindings |= set(comp_r.bindings)
                lone = all(c is comp_l or c is comp_r for c in components)
                if lone and view_bindings <= new_bindings:
                    return self._exec_join_fused(
                        query, col_of, comp_l, comp_r, jp
                    )

            comp = self._exec_join(components, comp_l, comp_r, col_of, jp,
                                   query, guard=guard)
            if comp.count == 0:  # host int: the sized emit observed zero
                return NullResult(len(query.views))

        # ---- phase 3: cartesian of leftovers ------------------------------
        for b in view_bindings:
            if find(b) is None:
                n = self.catalog.relation(query.relations[b]).num_tuples
                if n == 0:
                    return NullResult(len(query.views))
                P = size_class(n, self.config.min_pad)
                ident = jnp.arange(P, dtype=jnp.int32)[None, :]
                components.append(Component((b,), ident, n))
        while len(components) > 1:
            c1, c2 = components[0], components[1]
            n1 = self._host_count(c1)
            n2 = self._host_count(c2)
            total = n1 * n2
            if total == 0:
                return NullResult(len(query.views))
            P = size_class(total, self.config.min_pad)
            i1, i2 = self._ops.cartesian_indices(
                jnp.int64(n1), jnp.int64(n2), out_size=P
            )
            table = jnp.concatenate(
                [self._ops.take_cols(c1.table, i1), self._ops.take_cols(c2.table, i2)], axis=0
            )
            merged = Component(c1.bindings + c2.bindings, table, total)
            components = [merged] + components[2:]

        if not components:
            return NullResult(len(query.views))

        # ---- phase 4: checksums (single packed fetch) ---------------------
        comp = components[0]
        n = _n32(comp.count)
        parts = [_u64(comp.count).reshape(1)]
        for b, c in query.views:
            coldev, _ = col_of(b, c)
            parts.append(self._ops.checksum(coldev, comp.row(b), n).reshape(1))
        return PendingResult(jnp.concatenate(parts), len(query.views))

    # ---- operator implementations ----------------------------------------

    def _host_count(self, comp: Component) -> int:
        if not isinstance(comp.count, int):
            comp.count = int(comp.count)
        return comp.count

    def _exec_filter(self, components, find, col_of, pred: FilterPred) -> None:
        coldev, n_base = col_of(pred.binding, pred.column)
        const = jnp.uint64(pred.value & _MASK64)
        comp = find(pred.binding)
        if comp is None:
            mask = self._ops.compare_mask(coldev, jnp.int32(n_base), pred.op, const)
            pos, cnt = self._ops.mask_positions(mask, out_size=coldev.shape[0])
            components.append(Component((pred.binding,), pos[None, :], cnt))
            return
        vals = self._ops.gather_u64(coldev, comp.row(pred.binding))
        mask = self._ops.compare_mask(vals, _n32(comp.count), pred.op, const)
        self._compact(components, comp, mask)

    def _exec_selfjoin(self, components, find, col_of, pred: JoinPred) -> None:
        c1dev, n_base = col_of(pred.binding1, pred.column1)
        c2dev, _ = col_of(pred.binding1, pred.column2)
        comp = find(pred.binding1)
        if comp is None:
            mask = self._ops.equal_mask(c1dev, c2dev, jnp.int32(n_base))
            pos, cnt = self._ops.mask_positions(mask, out_size=c1dev.shape[0])
            components.append(Component((pred.binding1,), pos[None, :], cnt))
            return
        rids = comp.row(pred.binding1)
        mask = self._ops.equal_mask(
            self._ops.gather_u64(c1dev, rids), self._ops.gather_u64(c2dev, rids),
            _n32(comp.count),
        )
        self._compact(components, comp, mask)

    def _compact(self, components, comp: Component, mask: jax.Array) -> None:
        pos, cnt = self._ops.mask_positions(mask, out_size=comp.table.shape[1])
        new = Component(comp.bindings, self._ops.take_cols(comp.table, pos), cnt)
        components[:] = [c if c is not comp else new for c in components]

    def _join_keys(self, col_of, comp: Optional[Component], binding: int,
                   column: int) -> Tuple[jax.Array, Count]:
        coldev, n_base = col_of(binding, column)
        if comp is None:
            return coldev, n_base
        return self._ops.gather_u64(coldev, comp.row(binding)), comp.count

    def _exec_join(self, components, comp_l, comp_r, col_of,
                   jp: JoinPred, query: Query,
                   guard: bool = True) -> Component:
        keys_l, n_l = self._join_keys(col_of, comp_l, jp.binding1, jp.column1)
        keys_r, n_r = self._join_keys(col_of, comp_r, jp.binding2, jp.column2)

        # Build-side choice: a side with a prep-time key table joins with
        # ZERO sorts regardless of its size, so it wins outright; else
        # the smaller padded side (sort cost is driven by the static
        # shape, which the host knows without a readback).
        rc_l = (query.relations[jp.binding1], jp.column1)
        rc_r = (query.relations[jp.binding2], jp.column2)
        tbl_l = self.device_key_table(*rc_l) if comp_l is None else None
        tbl_r = self.device_key_table(*rc_r) if comp_r is None else None
        if (tbl_l is None) != (tbl_r is None):
            build_left = tbl_l is not None
        else:
            build_left = keys_l.shape[0] <= keys_r.shape[0]
        keys_b, n_b = (keys_l, n_l) if build_left else (keys_r, n_r)
        keys_p, n_p = (keys_r, n_r) if build_left else (keys_l, n_l)

        key32 = self._key32(query, jp)
        comp_b = comp_l if build_left else comp_r
        tbl_b = tbl_l if build_left else tbl_r
        b, c = ((jp.binding1, jp.column1) if build_left
                else (jp.binding2, jp.column2))
        if tbl_b is not None:
            # Key-table path: match ranges are two gathers, no sort.
            _, perm = self.device_sorted_column(query.relations[b], c)
            lo, cnt, ccum, total_dev = self._ops.join_probe_count_table(
                tbl_b, keys_p, _n32(n_p))
        else:
            if comp_b is None and self.config.presort:
                # Unfiltered base build side: prep-time sort.
                sorted_keys, perm = self.device_sorted_column(
                    query.relations[b], c, key32)
            else:
                sorted_keys, perm = self._ops.join_build(keys_b, _n32(n_b),
                                                         key32=key32)
            lo, cnt, ccum, total_dev = self._ops.join_probe_count(
                sorted_keys, _n32(n_b), keys_p, _n32(n_p))
        total = int(total_dev)  # the one required sync: sizes the emit
        if (guard and 0 < self.config.max_intermediate < total) or (
                total > HARD_INTERMEDIATE_CAP):
            raise IntermediateBlowup(total)
        if self.config.explain:
            print(f"--   {jp}: actual {total}", file=sys.stderr)
        if total == 0:
            return Component((jp.binding1, jp.binding2),
                             jnp.zeros((2, self.config.min_pad), jnp.int32), 0)
        P = size_class(total, self.config.min_pad)
        bpos, ppos = self._ops.join_emit(perm, lo, ccum, total_dev, out_size=P)
        pos_l, pos_r = (bpos, ppos) if build_left else (ppos, bpos)

        rows: List[jax.Array] = []
        bindings: List[int] = []
        for comp, binding, pos in (
            (comp_l, jp.binding1, pos_l),
            (comp_r, jp.binding2, pos_r),
        ):
            if comp is not None:
                rows.append(self._ops.take_cols(comp.table, pos))
                bindings.extend(comp.bindings)
                components[:] = [c for c in components if c is not comp]
            else:
                rows.append(pos[None, :])
                bindings.append(binding)
        new = Component(tuple(bindings), jnp.concatenate(rows, axis=0), total)
        components.append(new)
        return new

    # Views per side are zero-padded to a fixed width so the fused program
    # specializes only on (P_build, P_probe), not on how many projections
    # land on each side (fewer program shapes to compile).
    _FUSED_VPAD = 4
    # Slot-padded fused view scheme: True keeps the [VPAD, P]
    # zero-column stacks whose sums_b + sums_p are view-slot aligned
    # (the mesh engine's shuffle join is built on it).  False (single
    # device) passes ONLY the real views per side and assembles the
    # packed vector per view — runtime zero columns defeat XLA's
    # constant folding and cost dead u64 multiply-sum work, at the
    # price of a few more program shapes per (Vb, Vp).
    _fused_slot_padded = False

    def _zeros_u64(self, P: int) -> jax.Array:
        z = self._columns.get(("__zeros__", P))
        if z is None:
            z = (jnp.zeros((P,), jnp.uint64), 0)
            self._columns[("__zeros__", P)] = z
        return z[0]

    def _exec_join_fused(self, query: Query, col_of, comp_l, comp_r,
                         jp: JoinPred) -> PendingResult:
        """Last join + checksums in one program (ops/agg_join.py): the
        final intermediate is never materialized and needs no sync."""
        keys_l, n_l = self._join_keys(col_of, comp_l, jp.binding1, jp.column1)
        keys_r, n_r = self._join_keys(col_of, comp_r, jp.binding2, jp.column2)
        rc_l = (query.relations[jp.binding1], jp.column1)
        rc_r = (query.relations[jp.binding2], jp.column2)
        tbl_l = self.device_key_table(*rc_l) if comp_l is None else None
        tbl_r = self.device_key_table(*rc_r) if comp_r is None else None
        if (tbl_l is None) != (tbl_r is None):
            build_left = tbl_l is not None
        else:
            build_left = keys_l.shape[0] <= keys_r.shape[0]

        def side_of(binding: int) -> bool:
            """True = the jp.binding1 (left) side."""
            if comp_l is not None and binding in comp_l.bindings:
                return True
            if comp_r is not None and binding in comp_r.bindings:
                return False
            return binding == jp.binding1

        keys_b, n_b = (keys_l, n_l) if build_left else (keys_r, n_r)
        keys_p, n_p = (keys_r, n_r) if build_left else (keys_l, n_l)

        presorted = table = None
        comp_b = comp_l if build_left else comp_r
        tbl_b = tbl_l if build_left else tbl_r
        bb, bc = ((jp.binding1, jp.column1) if build_left
                  else (jp.binding2, jp.column2))
        if (comp_b is None and self.config.presort
                and self.prep_join_artifacts):
            presorted = self.device_sorted_column(query.relations[bb], bc)
            if tbl_b is not None:
                table = (tbl_b, presorted[1])

        Pb = keys_b.shape[0]
        # Key-table build side: every build-side view is a base column of
        # the build relation (comp_b is None), so its prep-time prefix
        # table replaces the per-query gather + cumsum — the fused join
        # becomes probe-only (ops.join_checksum_fused_table_pref).
        prefs_mode = table is not None

        if self._fused_slot_padded:
            V = max(len(query.views), self._FUSED_VPAD)
            brows = [self._zeros_u64(Pb)] * V
            prows = [self._zeros_u64(keys_p.shape[0])] * V
            prefs = [self._zeros_u64(Pb + 1)] * V if prefs_mode else None
            for vi, (b, c) in enumerate(query.views):
                coldev, _ = col_of(b, c)
                comp = comp_l if side_of(b) else comp_r
                if side_of(b) == build_left:
                    if prefs is not None:
                        prefs[vi] = self.device_prefix_table(
                            query.relations[bb], bc, c)
                    else:
                        brows[vi] = (coldev if comp is None else
                                     self._ops.gather_u64(coldev,
                                                          comp.row(b)))
                else:
                    prows[vi] = (coldev if comp is None else
                                 self._ops.gather_u64(coldev, comp.row(b)))
            packed = self._fused_join_packed(
                keys_b, jnp.stack(brows) if prefs is None else None,
                _n32(n_b), keys_p, jnp.stack(prows), _n32(n_p),
                key32=self._key32(query, jp), presorted=presorted,
                table=table,
                table_prefs=jnp.stack(prefs) if prefs is not None else None,
            )
            return PendingResult(packed[: 1 + len(query.views)],
                                 len(query.views))

        # Per-side real-view scheme: only actual projection columns
        # enter the program; the packed vector assembles per view.
        brows, prows, prefs = [], [], []
        b_idx, p_idx = {}, {}
        for vi, (b, c) in enumerate(query.views):
            coldev, _ = col_of(b, c)
            comp = comp_l if side_of(b) else comp_r
            if side_of(b) == build_left:
                b_idx[vi] = len(prefs) if prefs_mode else len(brows)
                if prefs_mode:
                    prefs.append(self.device_prefix_table(
                        query.relations[bb], bc, c))
                else:
                    brows.append(coldev if comp is None else
                                 self._ops.gather_u64(coldev, comp.row(b)))
            else:
                p_idx[vi] = len(prows)
                prows.append(coldev if comp is None else
                             self._ops.gather_u64(coldev, comp.row(b)))
        bstack = (jnp.stack(brows) if brows
                  else jnp.zeros((0, Pb), jnp.uint64))
        pstack = (jnp.stack(prows) if prows
                  else jnp.zeros((0, keys_p.shape[0]), jnp.uint64))
        count, sums_b, sums_p = self._ops.fused_join(
            keys_b, None if prefs_mode else bstack, _n32(n_b),
            keys_p, pstack, _n32(n_p),
            key32=self._key32(query, jp),
            presorted=presorted, table=table,
            table_prefs=jnp.stack(prefs) if prefs_mode and prefs else
            (jnp.zeros((0, Pb + 1), jnp.uint64) if prefs_mode else None))
        parts = [count.astype(jnp.uint64).reshape(1)]
        for vi in range(len(query.views)):
            s = (sums_b[b_idx[vi]] if vi in b_idx
                 else sums_p[p_idx[vi]])
            parts.append(s.reshape(1))
        return PendingResult(jnp.concatenate(parts), len(query.views))

    def _key32(self, query, jp) -> bool:
        """True when both join key columns are < 2^32 by catalog stats —
        statically enables the single-limb u32 sort path (row-id
        gathers only shrink a column's value range)."""
        stats = getattr(self.catalog, "stats", None)
        if not stats:
            return False
        try:
            u1 = stats[query.relations[jp.binding1]][jp.column1].u
            u2 = stats[query.relations[jp.binding2]][jp.column2].u
        except (IndexError, TypeError):
            return False
        return u1 < (1 << 32) and u2 < (1 << 32)

    def _fused_join_packed(self, keys_b, bcols, n_b, keys_p, pcols,
                           n_p, key32: bool = False,
                           presorted=None, table=None,
                           table_prefs=None) -> jax.Array:
        """Fused final join + checksums -> packed [1 + V] device vector.
        Each view's values live on exactly one side (the other side's
        zero column contributes 0 to both partial sums).  The member is
        picked inside ops.fused_join.  Overridden by the mesh engine with
        the distributed shuffle join."""
        count, sums_b, sums_p = self._ops.fused_join(
            keys_b, bcols, n_b, keys_p, pcols, n_p, key32=key32,
            presorted=presorted, table=table, table_prefs=table_prefs)
        return jnp.concatenate([count.reshape(1), sums_b + sums_p])
