"""Whole-query compilation: structure-keyed programs + speculative sizing.

The operator-granular executor (executor.py) dispatches ~6-20 device
programs per query; on small inputs the Python/dispatch overhead and the
per-program boundaries dominate.  This engine compiles each query into
ONE XLA program in the common case, and at most 1 + (#intermediate
joins) programs when speculation misses.

Two mechanisms (both SURVEY §7.3 "dynamic shapes everywhere" answers):

1. **Structure keying.**  The jit cache key is the query's *skeleton*:
   the query with every filter constant replaced by an index into a
   runtime uint64 `consts` vector.  Two queries differing only in
   constants (template workloads, fuzzers, dashboards) share one
   compiled program — compile count tracks query *shapes*, not query
   *texts*, so cold-start cost and cache growth stay bounded.
2. **Speculative intermediate sizing.**  The only data-dependent value
   the host must supply is each intermediate join's padded output size.
   Instead of syncing per join (a host stall each), the host *guesses*
   every size class up front from the planner's cardinality estimates
   (margin × estimate, power-of-two class), runs
   the whole query as one program, and the program returns the actual
   totals alongside the packed result.  Validation happens after the
   batch's single fetch: a guess that was too small truncated the
   intermediate, so the query re-runs on the incremental (per-join sync)
   path with the now-known exact classes.  Good guesses ⇒ a whole batch
   costs ZERO per-query syncs — one packed fetch for all queries.

Re-running earlier joins in each segment costs O(J²) device compute for
a J-join query; J ≤ 4 on contest queries and device compute is orders
of magnitude cheaper than a program boundary here.

Queries whose shape cannot be decided statically (disconnected view
bindings needing a cartesian product) fall back to the step-wise engine.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..frontend.parser import FilterPred, JoinPred, Query
from ..utils.padding import size_class
from .executor import (
    HARD_INTERMEDIATE_CAP,
    IntermediateBlowup,
    JaxEngine,
    NullResult,
    PendingResult,
    Result,
    _MASK64,
)
from .. import ops


def _skeletonize(query: Query) -> Tuple[Query, np.ndarray]:
    """Replace every filter constant with its index into a consts vector.

    The returned skeleton (text dropped, values = indices) is the jit
    cache key; the uint64 consts array rides into the program as a
    runtime argument, so constant-only query variations share programs.
    """
    consts: List[int] = []
    preds = []
    for p in query.predicates:
        if isinstance(p, FilterPred):
            preds.append(FilterPred(p.binding, p.column, p.op, len(consts)))
            consts.append(p.value & _MASK64)
        else:
            preds.append(p)
    skel = Query(query.relations, tuple(preds), query.views, text="")
    return skel, np.asarray(consts, dtype=np.uint64)


class SpecResult(PendingResult):
    """A speculatively-sized query answer: packed device vector
    [t_1..t_k, count, sum_0..sum_{V-1}] where t_i are the actual
    intermediate-join totals.  Valid iff every t_i fit its guessed
    class; otherwise `retry` re-runs the query incrementally."""

    def __init__(self, packed: jax.Array, num_views: int,
                 classes: Tuple[int, ...], max_intermediate: int,
                 retry: Callable[[], str],
                 record: Optional[Callable[[Tuple[int, ...]], None]] = None):
        super().__init__(packed, num_views)
        self.classes = classes
        self.max_intermediate = max_intermediate
        self.retry = retry
        self.record = record

    @property
    def packed_len(self) -> int:
        return len(self.classes) + 1 + self.num_views

    def line_from(self, arr) -> str:
        k = len(self.classes)
        totals = [int(t) for t in arr[:k]]
        if self.record is not None:
            self.record(tuple(totals))
        if any(t > c for t, c in zip(totals, self.classes)) or (
            0 < self.max_intermediate < max(totals, default=0)
        ):
            return self.retry()
        if int(arr[k]) == 0:
            return " ".join("NULL" for _ in range(self.num_views))
        return " ".join(str(int(v) & _MASK64) for v in arr[k + 1:])


class CompiledEngine(JaxEngine):
    """JaxEngine with whole-query structure-keyed compilation
    (S18_COMPILE_QUERIES) and speculative sizing (S18_SPECULATE)."""

    # Learned size classes: query text -> actual intermediate totals of
    # the last execution.  A repeated query (templates, dashboards, the
    # contest's warm-then-timed harness) speculates with EXACT classes —
    # zero syncs AND no margin-padded device compute.  Validation still
    # runs every time, so a (hypothetical) data change only costs a
    # retry, never correctness.  Persisted to the prep-cache dir keyed
    # by (relation-set identity, sizing-relevant config), so a cold
    # process re-serving the same data skips the learning sync too —
    # a stale entry is only a retry, the same cost as no entry.
    def _learned(self, query: Query) -> Optional[Tuple[int, ...]]:
        return self._learned_cache().get(query.text)

    def _prep_key(self) -> Optional[Tuple[str, str, str]]:
        """(cache base dir, relation-set digest, config hash) keying every
        per-(data, config) prep artifact: learned classes, program vault."""
        pk = self.__dict__.get("_prep_key_val", "?")
        if pk != "?":
            return pk
        import hashlib

        from ..storage.catalog import identity_digest, prep_cache_dir

        pk = None
        base = prep_cache_dir()
        paths = getattr(self.catalog, "source_paths", None)
        digest = identity_digest(paths) if (base and paths) else None
        if digest is not None:
            cfg = self.config
            ch = hashlib.sha1(
                f"{cfg.min_pad}:{cfg.optimize_joins}:{cfg.fuse_final_join}:"
                f"{cfg.presort}:{cfg.key_table_max}"
                .encode()).hexdigest()[:8]
            pk = (base, digest, ch)
        self.__dict__["_prep_key_val"] = pk
        return pk

    def _learned_file(self) -> Optional[str]:
        import os

        pk = self._prep_key()
        if pk is None:
            return None
        base, digest, ch = pk
        return os.path.join(base, f"learned-{digest}-{ch}.json")

    def _vault(self):
        v = self.__dict__.get("_vault_obj")
        if v is None:
            import os

            from .vault import ProgramVault

            cfg = self.config
            # Mesh engines keep the plain jit path: shard_map programs
            # have their own cross-process story (sharding-annotated
            # export is untested here) and dist prep is not the
            # contest-timed surface.
            use = cfg.vault and getattr(cfg, "mesh_devices", 1) <= 1
            pk = self._prep_key() if use else None
            # v3: program-signature schema version — bump when the
            # _run_segments argument list changes, so stale exported
            # programs aren't restored (loads cost prep time even when
            # their keys can no longer match).
            from .vault import generation_dir

            d = (generation_dir(pk[0], f"vault3-{pk[1]}-{pk[2]}")
                 if pk is not None else None)
            v = ProgramVault(d)
            self.__dict__["_vault_obj"] = v
        return v

    def _learned_cache(self) -> dict:
        cache = self.__dict__.get("_learned_classes")
        if cache is None:
            cache = {}
            fp = self._learned_file()
            if fp is not None:
                import json

                try:
                    with open(fp) as fh:
                        raw = json.load(fh)
                    cache = {k: tuple(int(t) for t in v)
                             for k, v in raw.items() if isinstance(v, list)}
                except (OSError, ValueError):
                    cache = {}
            self.__dict__["_learned_classes"] = cache
        return cache

    def _learn(self, text: str, classes: Tuple[int, ...]) -> None:
        cache = self._learned_cache()
        if cache.get(text) == classes:
            return
        cache[text] = classes
        fp = self._learned_file()
        if fp is None:
            return
        import json
        import os
        import tempfile

        try:
            os.makedirs(os.path.dirname(fp), exist_ok=True)
            fd, tmp = tempfile.mkstemp(dir=os.path.dirname(fp),
                                       suffix=".json")
            with os.fdopen(fd, "w") as fh:
                json.dump({k: list(v) for k, v in cache.items()}, fh)
            os.replace(tmp, fp)  # atomic: concurrent servers race benignly
        except OSError:
            pass

    def prefetch(self) -> None:
        """Base prefetch (columns, presorts, key tables) plus a replay of
        the persisted serving history: every query text whose size
        classes survived a previous process is executed once, untimed,
        so its XLA programs are loaded/compiled and its speculation is
        validated BEFORE the timed phase.  Structure-keyed programs make
        this generalize: an unseen query that shares a skeleton with any
        replayed one rides an already-warm program.

        Off by default (S18_WARM_REPLAY=1 enables): the contest harness
        only gives a 1 s prep window after Done (harness.cpp:175-177),
        and a blocking replay's overrun lands in the TIMED phase.
        Enable it for real serving restarts, where prep is genuinely
        untimed.

        The program vault (vault.py) supersedes replay for program
        warmth: restores start here, overlap the device prep below
        (deserialize is GIL-light, the XLA compile-cache hit releases
        the GIL), and a query arriving before its restore finishes
        waits on that restore instead of re-tracing."""
        self._vault().load_async()
        super().prefetch()
        self._replay_bad_texts_async()
        if self.config.warm_replay:
            self._replay_learned()

    def _replay_bad_texts_async(self) -> None:
        """Replay (in a daemon thread, overlapping the rest of prep) the
        query texts recorded as unvaultable by earlier processes: their
        programs can only be served by the plain jit path, whose trace
        and persistent-cache load still cost time in every process —
        absorb that in the untimed prep window.  A query arriving while
        its replay compiles simply waits on jit's own per-program lock,
        exactly as it would have without the replay."""
        texts = self._vault().bad_texts()
        if not texts:
            return
        import threading

        from ..frontend.parser import parse_query

        def run():
            for t in texts:
                try:
                    self.execute(parse_query(t))
                except Exception:  # noqa: BLE001 — warming only
                    pass

        t = threading.Thread(target=run, daemon=True, name="s18badreplay")
        self.__dict__["_replay_thread"] = t
        t.start()

    def quiesce(self) -> None:
        """Join every background prep activity (vault restores + the
        bad-text replay thread) so NOTHING overlaps a timed phase:
        background compiles and zero-prime executions contend with
        serving for the host and the device.  bench.py calls this
        between warm-up and the clock."""
        t = self.__dict__.get("_replay_thread")
        if t is not None:
            t.join()
        self._vault().wait_loaded()

    def _replay_learned(self, cap: int = 512) -> None:
        texts = list(self._learned_cache())
        if not texts:
            return
        from ..frontend.parser import parse_query
        from .executor import format_batch

        pending = []
        for text in texts[:cap]:
            try:
                pending.append(self.execute_async(parse_query(text)))
            except Exception:  # noqa: BLE001 — stale/foreign entry: skip
                continue
        try:
            format_batch(pending)  # one drain; results discarded
        except Exception:  # noqa: BLE001
            pass

    def _make_recorder(self, query: Query, k: int):
        min_pad = self.config.min_pad

        def record(totals: Tuple[int, ...]) -> None:
            self._learn(query.text, tuple(size_class(max(t, 1), min_pad)
                                          for t in totals))

        return record if k else None

    def _execute_async_device(self, query: Query) -> Result:
        # Overrides the step-wise path; the base execute_async wraps this
        # with the poisoned-device short-circuit + host-oracle recovery.
        try:
            return self._execute_compiled(query, use_planner=True,
                                          guard=True)
        except _Fallback:
            return super()._execute_async_device(query)
        except IntermediateBlowup:
            return self._retry_text_order(query)

    def _retry_text_order(self, query: Query) -> Result:
        # Planner misfire on skew.  Forest queries are answered exactly
        # with zero materialization (factorized message passing —
        # immune to intermediate blowups the planner missed); cyclic
        # ones retry in original text order under the technical cap
        # (see executor.py).
        from .factorized import factorized_result

        res = factorized_result(self, query)
        if res is not None:
            return res
        try:
            return self._execute_compiled(query, use_planner=False,
                                          guard=False)
        except _Fallback:
            return super()._execute_async_device(query)

    def _execute_compiled(self, query: Query, use_planner: bool,
                          guard: bool) -> Result:
        # Per-text fast path: for a repeated query text the whole host
        # side (static plan, skeletonization, device refs, vault key) is
        # deterministic, so a prepared zero-arg dispatch closure is
        # cached and reused — the per-query Python becomes a dict hit +
        # dispatch.  Invalidated when the learned size classes diverge
        # from the cached ones (the slow path would now pick different
        # classes); wrong speculation still self-heals through the
        # normal SpecResult validation + retry.
        fast = self.__dict__.setdefault("_fastpath", {})
        if len(fast) > 8192:  # unbounded distinct texts: drop, relearn
            fast.clear()
        fkey = query.text if (use_planner and guard and query.text) else None
        if fkey is not None:
            hit = fast.get(fkey)
            if hit is not None:
                classes, n_classes, call, args = hit
                learned = self._learned(query)
                if not (learned is not None and len(learned) == n_classes
                        and tuple(learned) != classes):
                    out = call()
                    if n_classes:
                        res = SpecResult(
                            out, len(query.views), classes,
                            self.config.max_intermediate,
                            self._make_retry(query, args, guard),
                            record=self._make_recorder(query, n_classes))
                    else:
                        res = SpecResult(out, len(query.views), (), 0,
                                         retry=lambda: "")
                    res.fetch_retry = self._make_fetch_retry(
                        call, query, args, guard)
                    return res
                fast.pop(fkey, None)
        joins, cols_used, n_classes, class_idx = self._static_plan(
            query, use_planner)
        skel, consts = _skeletonize(query)
        # Device-array consts: keeps the call signature identical to the
        # vault's zeros-primed one (np inputs key a different pjit entry).
        consts = jnp.asarray(consts)
        cols = tuple(self.device_column(r, c)[0] for r, c in cols_used)
        ns = tuple(self.device_column(r, c)[1] for r, c in cols_used)
        key32 = tuple(self._key32(query, jp) for jp in joins)
        # Prep-time sorts of every base join-key column ride in as extra
        # runtime args; joins whose build side is statically an
        # unfiltered base column skip their argsort (XLA DCEs unused
        # entries).  jkeys indexes in SKELETON coordinates (relation id,
        # column), matching col_of's keys.
        if self.config.presort:
            jkeys = tuple(sorted(
                {(query.relations[jp.binding1], jp.column1) for jp in joins}
                | {(query.relations[jp.binding2], jp.column2)
                   for jp in joins}))
            spairs = tuple(self.device_sorted_column(r, c) for r, c in jkeys)
            tkeys = tuple(rc for rc in jkeys
                          if self.device_key_table(*rc) is not None)
            tcols = tuple(self.device_key_table(*rc) for rc in tkeys)
            # Prefix tables for the final join's potential key-table
            # build sides: one per (relation, join column, view column)
            # triple — makes the fused table join probe-only
            # (ops.join_checksum_fused_table_pref).
            fset = set()
            if joins:
                jp = joins[-1]
                for b, cjoin in ((jp.binding1, jp.column1),
                                 (jp.binding2, jp.column2)):
                    rel = query.relations[b]
                    if self.device_key_table(rel, cjoin) is not None:
                        for vb, vc in query.views:
                            if vb == b:
                                fset.add((rel, cjoin, vc))
            fkeys = tuple(sorted(fset))
            fprefs = tuple(self.device_prefix_table(*t) for t in fkeys)
        else:
            jkeys, spairs, tkeys, tcols, fkeys, fprefs = \
                (), (), (), (), (), ()
        scols = tuple(p[0] for p in spairs)
        sperms = tuple(p[1] for p in spairs)
        args = (skel, joins, key32, cols_used, ns, consts, cols,
                jkeys, scols, sperms, tkeys, tcols, fkeys, fprefs)

        if n_classes == 0:
            # Complete in one program (fused final join / filter-only):
            # the cacheable fast-path shape.
            call = self._prepare_call(
                skel, joins, key32, (), cols_used, ns, consts, cols,
                jkeys, scols, sperms, tkeys, tcols, fkeys, fprefs,
                qtext=query.text)
            out = call()
            if fkey is not None:
                fast[fkey] = ((), 0, call, args)
            res = SpecResult(out, len(query.views), (), 0,
                             retry=lambda: "")
            res.fetch_retry = self._make_fetch_retry(call, query, args,
                                                     guard)
            return res

        if guard and self.config.speculate:
            learned = self._learned(query)
            classes = (learned if learned is not None
                       and len(learned) == n_classes
                       else self._guess_classes(query, joins, class_idx))
            if classes is not None:
                call = self._prepare_call(
                    skel, joins, key32, classes, cols_used, ns, consts,
                    cols, jkeys, scols, sperms, tkeys, tcols, fkeys,
                    fprefs, qtext=query.text)
                out = call()
                if fkey is not None:
                    fast[fkey] = (classes, n_classes, call, args)
                res = SpecResult(out, len(query.views), classes,
                                 self.config.max_intermediate if guard
                                 else 0,
                                 self._make_retry(query, args, guard),
                                 record=self._make_recorder(query,
                                                            n_classes))
                res.fetch_retry = self._make_fetch_retry(call, query,
                                                         args, guard)
                return res
        return self._run_incremental(query, *args, guard=guard)

    def _make_fetch_retry(self, call, query: Query, args, guard: bool):
        """Recovery for a DEVICE-side program failure discovered at the
        fetch (async dispatch defers errors past every dispatch-time
        guard): disable the vault entry that served the program, then
        re-run the query through the plain jit path.  Without this, a
        poisoned program surfaces as a NULL line via the REPL's fault
        isolation — a wrong answer.  Counted (counters["fetch_failed"])
        and logged by PendingResult.line when it runs."""
        @self._counted
        def fetch_retry() -> str:
            disable = getattr(call, "vault_disable", None)
            if disable is not None:
                try:
                    disable()
                except Exception:  # noqa: BLE001
                    pass
            self.__dict__.get("_fastpath", {}).pop(query.text, None)
            return self._make_retry(query, args, guard)()

        return fetch_retry

    def _make_retry(self, query: Query, args, guard: bool):
        def retry() -> str:
            # The device retry can itself die when the first failure
            # wedged the process's device state: the host oracle is the
            # tier that cannot be poisoned — exact answer, batch
            # survives (counted as a failure_host answer).
            try:
                try:
                    res = self._run_incremental(query, *args, guard=guard)
                except IntermediateBlowup:
                    res = self._retry_text_order(query)
                return res if isinstance(res, str) else res.line()
            except Exception:  # noqa: BLE001 — device wedged
                return self._last_resort_or_raise(query)

        return retry

    def _prepare_call(self, skel, joins, key32, classes, cols_used, ns,
                      consts, cols, jkeys, scols, sperms, tkeys, tcols,
                      fkeys, fprefs, qtext=None):
        """A zero-arg dispatch closure for one query-program signature:
        a vaulted program when one is ready (or restoring — wait beats
        re-tracing), else one built via jax.export (first execution of
        this signature anywhere, persisted for every later process),
        else the plain jit call.  The closure is reusable (the per-text
        fast path caches it); it re-checks the vault table per call, a
        locked dict get.

        The exported wrapper and the direct jit program lower to the
        same HLO, so correctness is identical; only trace cost moves
        out of the timed phase (see vault.py)."""
        cfg = self.config
        vault = self._vault()
        statics = (skel, joins, key32, classes, cols_used, ns,
                   cfg.min_pad, cfg.fuse_final_join, jkeys, tkeys, fkeys)
        dyn = (consts, cols, scols, sperms, tcols, fprefs)

        def jit_call():
            return _run_segments(skel, joins, key32, classes, cols_used,
                                 ns, cfg.min_pad, cfg.fuse_final_join,
                                 consts, cols, jkeys, scols, sperms, tkeys,
                                 tcols, fkeys, fprefs)

        if not vault.enabled:
            return jit_call
        key = vault.key(statics, dyn)

        def call():
            prog = vault.acquire(key)
            if prog is None:
                prog = vault.build(key, _program_closure(statics), dyn)
            if prog is not None:
                try:
                    return prog(*dyn)
                except Exception:  # noqa: BLE001 — stale artifact: re-jit
                    vault.disable(key)
                    vault.note_bad_text(qtext)
            else:
                # Unvaultable signature: remember the text so the next
                # process replays it (and pays the fallback compile) in
                # the untimed prep window, not while serving.
                vault.note_bad_text(qtext)
            return jit_call()

        call.vault_disable = lambda: (vault.disable(key),
                                      vault.note_bad_text(qtext))
        return call

    def _run_incremental(self, query: Query, skel, joins, key32,
                         cols_used, ns, consts, cols,
                         jkeys, scols, sperms, tkeys, tcols,
                         fkeys, fprefs, *, guard: bool) -> Result:
        """Per-intermediate-join sync path: each segment's output total
        sizes the next static class (one host sync per intermediate
        join)."""
        classes: Tuple[int, ...] = ()
        while True:
            out = self._prepare_call(
                skel, joins, key32, classes, cols_used, ns, consts, cols,
                jkeys, scols, sperms, tkeys, tcols, fkeys, fprefs)()
            if out.ndim:  # complete: [totals..., count, sums...]
                if classes and guard:
                    # the exact classes are now known — teach the
                    # speculative path for the next run of this query
                    self._learn(query.text, classes)
                return SpecResult(out, len(query.views), classes, 0,
                                  retry=lambda: "")  # totals known valid
            total = int(out)  # the one sync per intermediate join
            if total == 0:
                return NullResult(len(query.views))
            if (guard and 0 < self.config.max_intermediate < total) or (
                    total > HARD_INTERMEDIATE_CAP):
                raise IntermediateBlowup(total)
            classes = classes + (size_class(total, self.config.min_pad),)

    def _guess_classes(self, query: Query, joins,
                       class_idx: Tuple[int, ...]) -> Optional[Tuple[int, ...]]:
        """Size classes from planner estimates × margin; None when any
        class would exceed spec_max (incremental path is cheaper than
        compiling huge speculative programs)."""
        from ..planner.join_order import estimate_cardinalities

        ests = estimate_cardinalities(query, self.catalog, joins)
        classes = []
        for idx in class_idx:
            est = max(int(ests[idx]), 1) * self.config.spec_margin
            cls = size_class(est, self.config.min_pad)
            if cls > self.config.spec_max:
                return None
            classes.append(cls)
        return tuple(classes)

    def _static_plan(self, query: Query, use_planner: bool = True):
        """Host-side static analysis: join order, referenced columns, the
        number of intermediate size classes the host must supply, and the
        indices (into the join order) of the class-consuming joins."""
        joins = query.joins
        if use_planner and self._planner is not None and len(joins) > 1:
            joins = self._planner(query, self.catalog)
        joins = tuple(joins)

        # Static component tracking to find: (a) cartesian fallbacks,
        # (b) which joins are same-component selections, (c) fusability.
        comps: List[set] = []

        def find(b):
            for c in comps:
                if b in c:
                    return c
            return None

        for p in query.filters_and_selfjoins:
            b = p.binding if isinstance(p, FilterPred) else p.binding1
            if find(b) is None:
                comps.append({b})
        class_idx: List[int] = []
        for idx, jp in enumerate(joins):
            cl, cr = find(jp.binding1), find(jp.binding2)
            if cl is not None and cl is cr:
                continue
            last = idx == len(joins) - 1
            merged = {jp.binding1, jp.binding2}
            if cl is not None:
                merged |= cl
            if cr is not None:
                merged |= cr
            if last and self.config.fuse_final_join:
                others = [c for c in comps if c is not cl and c is not cr]
                if not others and {b for b, _ in query.views} <= merged:
                    break  # fused: no class needed
            class_idx.append(idx)
            comps = [c for c in comps if c is not cl and c is not cr]
            comps.append(merged)
        else:
            # No fused final join: the result must be a single component
            # covering every view binding, else cartesian -> fallback.
            view_b = {b for b, _ in query.views}
            if len(comps) != 1 or not view_b <= comps[0]:
                raise _Fallback
            if not joins and not query.filters_and_selfjoins:
                raise _Fallback

        cols_used = sorted(self._columns_referenced(query, joins))
        return joins, tuple(cols_used), len(class_idx), tuple(class_idx)

    def _columns_referenced(self, query: Query, joins) -> set:
        used = set()
        for p in query.filters_and_selfjoins:
            if isinstance(p, FilterPred):
                used.add((query.relations[p.binding], p.column))
            else:
                used.add((query.relations[p.binding1], p.column1))
                used.add((query.relations[p.binding1], p.column2))
        for jp in joins:
            used.add((query.relations[jp.binding1], jp.column1))
            used.add((query.relations[jp.binding2], jp.column2))
        for b, c in query.views:
            used.add((query.relations[b], c))
        return used


class _Fallback(Exception):
    pass


def _program_closure(statics):
    """A positional-arg closure over one signature's static arguments,
    tracing the same body as _run_segments — the exportable form of the
    program (jax.export can't carry jit static_argnames)."""
    (skel, joins, key32, classes, cols_used, ns, min_pad, fuse,
     jkeys, tkeys, fkeys) = statics
    raw = _run_segments.__wrapped__

    def fn(consts, cols, scols, sperms, tcols, fprefs):
        return raw(skel, joins, key32, classes, cols_used, ns, min_pad,
                   fuse, consts, cols, jkeys, scols, sperms, tkeys, tcols,
                   fkeys, fprefs)

    return fn


@partial(jax.jit,
         static_argnames=("query", "joins", "key32", "classes", "cols_used",
                          "ns", "min_pad", "fuse", "jkeys", "tkeys",
                          "fkeys"))
def _run_segments(query: Query, joins, key32, classes, cols_used, ns,
                  min_pad: int, fuse: bool, consts, cols,
                  jkeys=(), scols=(), sperms=(), tkeys=(), tcols=(),
                  fkeys=(), fprefs=()):
    """Pure-functional replay of the executor up to the next unknown size
    class.  `query` is a SKELETON (filter values = indices into the
    runtime `consts` vector).  Returns the next intermediate join's total
    (i64 scalar) when `classes` is not yet complete, else the packed
    [len(classes) + 1 + V] u64 vector
    [t_1..t_k, count, sum_0..sum_{V-1}].

    `jkeys`/`scols`/`sperms`: prep-time sorts of base join-key columns
    (engine.device_sorted_column) — a join building on an unfiltered
    base column uses them instead of sorting at query time.
    `tkeys`/`tcols`: prep-time domain rank tables
    (engine.device_key_table) — a join building on such a column runs
    with ZERO sorts; a side with a table is preferred as the build side
    outright."""
    colmap = {rc: (cols[i], ns[i]) for i, rc in enumerate(cols_used)}
    smap = {rc: (scols[i], sperms[i]) for i, rc in enumerate(jkeys)}
    tmap = {rc: tcols[i] for i, rc in enumerate(tkeys)}

    def col_of(b, c):
        return colmap[(query.relations[b], c)]

    # components: list of (bindings tuple, [A, P] rowid matrix, n traced)
    components: List[Tuple[Tuple[int, ...], jax.Array, jax.Array]] = []

    def find(b):
        for comp in components:
            if b in comp[0]:
                return comp
        return None

    def replace(old, new):
        components[:] = [new if c is old else c for c in components]

    def row(comp, b):
        return comp[1][comp[0].index(b)]

    def compact(comp, mask):
        pos, cnt = ops.mask_positions(mask, out_size=comp[1].shape[1])
        replace(comp, (comp[0], jnp.take(comp[1], pos, axis=1), cnt))

    totals: List[jax.Array] = []  # actual intermediate-join cardinalities

    def done(packed: jax.Array) -> jax.Array:
        return jnp.concatenate(
            [jnp.stack(totals).astype(jnp.uint64), packed]
            if totals else [packed]
        )

    # ---- filters & self-joins ----------------------------------------
    for pred in query.filters_and_selfjoins:
        if isinstance(pred, FilterPred):
            coldev, n_base = col_of(pred.binding, pred.column)
            const = consts[pred.value]  # skeleton value = index
            comp = find(pred.binding)
            if comp is None:
                mask = ops.compare_mask(coldev, jnp.int32(n_base), pred.op, const)
                pos, cnt = ops.mask_positions(mask, out_size=coldev.shape[0])
                components.append(((pred.binding,), pos[None, :], cnt))
            else:
                vals = coldev[row(comp, pred.binding)]
                mask = ops.compare_mask(vals, comp[2], pred.op, const)
                compact(comp, mask)
        else:
            c1dev, n_base = col_of(pred.binding1, pred.column1)
            c2dev, _ = col_of(pred.binding1, pred.column2)
            comp = find(pred.binding1)
            if comp is None:
                mask = ops.equal_mask(c1dev, c2dev, jnp.int32(n_base))
                pos, cnt = ops.mask_positions(mask, out_size=c1dev.shape[0])
                components.append(((pred.binding1,), pos[None, :], cnt))
            else:
                rids = row(comp, pred.binding1)
                mask = ops.equal_mask(c1dev[rids], c2dev[rids], comp[2])
                compact(comp, mask)

    # ---- joins --------------------------------------------------------
    def join_keys(comp, b, c):
        coldev, n_base = col_of(b, c)
        if comp is None:
            return coldev, jnp.int32(n_base)
        return coldev[row(comp, b)], comp[2]

    class_idx = 0
    view_b = {b for b, _ in query.views}
    for idx, jp in enumerate(joins):
        comp_l = find(jp.binding1)
        comp_r = find(jp.binding2)
        if comp_l is not None and comp_l is comp_r:
            c1dev, _ = col_of(jp.binding1, jp.column1)
            c2dev, _ = col_of(jp.binding2, jp.column2)
            v1 = c1dev[row(comp_l, jp.binding1)]
            v2 = c2dev[row(comp_l, jp.binding2)]
            compact(comp_l, ops.equal_mask(v1, v2, comp_l[2]))
            continue

        keys_l, n_l = join_keys(comp_l, jp.binding1, jp.column1)
        keys_r, n_r = join_keys(comp_r, jp.binding2, jp.column2)
        tbl_l = (tmap.get((query.relations[jp.binding1], jp.column1))
                 if comp_l is None else None)
        tbl_r = (tmap.get((query.relations[jp.binding2], jp.column2))
                 if comp_r is None else None)
        if (tbl_l is None) != (tbl_r is None):
            build_left = tbl_l is not None
        else:
            build_left = keys_l.shape[0] <= keys_r.shape[0]
        keys_b, n_b = (keys_l, n_l) if build_left else (keys_r, n_r)
        keys_p, n_p = (keys_r, n_r) if build_left else (keys_l, n_l)
        comp_b = comp_l if build_left else comp_r
        tbl_b = tbl_l if build_left else tbl_r
        bb, bc = ((jp.binding1, jp.column1) if build_left
                  else (jp.binding2, jp.column2))
        presorted = (smap.get((query.relations[bb], bc))
                     if comp_b is None else None)

        last = idx == len(joins) - 1
        merged = {jp.binding1, jp.binding2}
        if comp_l is not None:
            merged |= set(comp_l[0])
        if comp_r is not None:
            merged |= set(comp_r[0])
        others = [c for c in components if c is not comp_l and c is not comp_r]
        if fuse and last and not others and view_b <= merged:
            # fused final join + checksums
            def side_of(b):
                if comp_l is not None and b in comp_l[0]:
                    return True
                if comp_r is not None and b in comp_r[0]:
                    return False
                return b == jp.binding1

            # Per-side REAL-view stacks (+ slot maps for assembly):
            # padding both sides to the view count with runtime zero
            # columns would cost dead u64 multiply-sum work XLA cannot
            # fold away.
            brows, prows = [], []
            b_idx, p_idx = {}, {}
            for vi, (b, c) in enumerate(query.views):
                coldev, _ = col_of(b, c)
                comp = comp_l if side_of(b) else comp_r
                vals = coldev if comp is None else coldev[row(comp, b)]
                if side_of(b) == build_left:
                    b_idx[vi] = len(brows)
                    brows.append(vals)
                else:
                    p_idx[vi] = len(prows)
                    prows.append(vals)
            table = ((tbl_b, presorted[1])
                     if tbl_b is not None and presorted is not None
                     else None)
            # Prep-time prefix tables make the table member probe-only:
            # when every build-side view has one (fkeys/fprefs), the
            # build payload never enters the program (XLA DCEs brows).
            tprefs = None
            if table is not None:
                fmap = {t: fprefs[i] for i, t in enumerate(fkeys)}
                rel_b = query.relations[bb]
                rows_p, ok = [], True
                for vi, (b, c) in enumerate(query.views):
                    if side_of(b) == build_left:
                        pr = fmap.get((rel_b, bc, c))
                        if pr is None:
                            ok = False
                            break
                        rows_p.append(pr)
                if ok:
                    tprefs = (jnp.stack(rows_p) if rows_p else
                              jnp.zeros((0, keys_b.shape[0] + 1),
                                        jnp.uint64))
            bstack = (jnp.stack(brows) if brows
                      else jnp.zeros((0, keys_b.shape[0]), jnp.uint64))
            pstack = (jnp.stack(prows) if prows
                      else jnp.zeros((0, keys_p.shape[0]), jnp.uint64))
            count, sums_b, sums_p = ops.fused_join(
                keys_b, bstack, n_b, keys_p, pstack, n_p,
                key32=key32[idx], presorted=presorted,
                table=table, table_prefs=tprefs)
            parts = [count.astype(jnp.uint64).reshape(1)]
            for vi in range(len(query.views)):
                s = (sums_b[b_idx[vi]] if vi in b_idx
                     else sums_p[p_idx[vi]])
                parts.append(s.reshape(1))
            return done(jnp.concatenate(parts))

        if tbl_b is not None and presorted is not None:
            # Key-table path: match ranges are two gathers, no sort.
            perm = presorted[1]
            lo, cnt, ccum, total = ops.join_probe_count_table(
                tbl_b, keys_p, n_p)
        else:
            if presorted is not None:
                sk64, perm = presorted
                sorted_keys = (sk64.astype(jnp.uint32) if key32[idx]
                               else sk64)
            else:
                sorted_keys, perm = ops.join_build(keys_b, n_b,
                                                   key32=key32[idx])
            lo, cnt, ccum, total = ops.join_probe_count(
                sorted_keys, n_b, keys_p, n_p)
        if class_idx >= len(classes):
            return total  # segment boundary: host picks the class
        totals.append(total)

        P = classes[class_idx]
        class_idx += 1
        bpos, ppos = ops.join_emit(perm, lo, ccum, total, out_size=P)
        pos_l, pos_r = (bpos, ppos) if build_left else (ppos, bpos)
        rows_, bindings_ = [], []
        for comp, binding, pos in ((comp_l, jp.binding1, pos_l),
                                   (comp_r, jp.binding2, pos_r)):
            if comp is not None:
                rows_.append(jnp.take(comp[1], pos, axis=1))
                bindings_.extend(comp[0])
                components[:] = [c for c in components if c is not comp]
            else:
                rows_.append(pos[None, :])
                bindings_.append(binding)
        total32 = jnp.minimum(total, P).astype(jnp.int32)
        components.append((tuple(bindings_), jnp.concatenate(rows_, axis=0),
                           total32))

    # ---- checksums (no fused final join happened) ---------------------
    comp = components[0]
    parts = [comp[2].astype(jnp.uint64).reshape(1)]
    for b, c in query.views:
        coldev, _ = col_of(b, c)
        parts.append(ops.checksum(coldev, row(comp, b), comp[2]).reshape(1))
    return done(jnp.concatenate(parts))
