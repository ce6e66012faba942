"""stdin/stdout protocol driver (reference: handler.c, main.cpp).

Protocol:
  1. one relation file path per line, until the line "Done"
  2. query lines in batches; "F" ends a batch (the whole batch executes
     then), "Exit" or EOF terminates
  3. one output line per query: space-separated uint64 checksums, or NULL
     per projection on an empty result

The prep phase (loading + stats + device transfer) happens before the first
batch and is untimed by the contest harness (harness.cpp:175-208), so the
engine eagerly pushes all columns to the device and pre-compiles the hot
operator shapes there.
"""

from __future__ import annotations

import os
import sys
import threading
from typing import IO, List, Optional

from ..config import EngineConfig
from ..frontend.parser import Query, parse_query
from ..storage.catalog import Catalog


SERVE_SUMMARY_TAG = "s18-serve"

# JAX's compile-phase events (jax/_src/dispatch.py): tracing, lowering to
# MLIR, and the backend compile; summed into the exit summary.
_COMPILE_EVENTS = ("/jax/core/compile/jaxpr_trace_duration",
                   "/jax/core/compile/jaxpr_to_mlir_module_duration",
                   "/jax/core/compile/backend_compile_duration")


class _CompileClock:
    """Seconds spent in JAX compile phases since `start()`."""

    def __init__(self):
        self._lock = threading.Lock()
        self.seconds = 0.0

    def start(self) -> None:
        import jax.monitoring

        def on_event(event: str, duration_secs: float, **_kw) -> None:
            if event in _COMPILE_EVENTS:
                with self._lock:
                    self.seconds += duration_secs

        jax.monitoring.register_event_duration_secs_listener(on_event)


def _device_memory() -> dict:
    """Peak bytes in use and the allocator's limit, per local device
    (None where the backend keeps no statistics, as on the CPU)."""
    import jax

    peaks, limits = [], []
    for d in jax.local_devices():
        st = d.memory_stats() or {}
        peaks.append(st.get("peak_bytes_in_use"))
        limits.append(st.get("bytes_limit"))
    return {"peak_bytes": peaks, "bytes_limit": limits}


def serve_summary(tiers: dict, compile_s: Optional[float],
                  memory: Optional[dict]) -> str:
    """The one stderr line the REPL prints at exit: queries per
    serving tier, device memory and compile seconds, as
    ``s18-serve <json>``."""
    import json

    return f"{SERVE_SUMMARY_TAG} " + json.dumps(
        dict(tiers, compile_s=compile_s, **(memory or {})),
        sort_keys=True)


def run_protocol(stdin: IO[str], stdout: IO[str],
                 config: Optional[EngineConfig] = None) -> None:
    config = config or EngineConfig.from_env()
    clock = None
    if config.backend != "numpy":
        clock = _CompileClock()
        clock.start()

    paths: List[str] = []
    for raw in stdin:
        line = raw.strip()
        if line == "Done":
            break
        if line:
            paths.append(line)

    catalog = Catalog.from_files(paths)

    if config.backend == "numpy":
        from ..engine.oracle import execute_query_numpy

        def run_async(q: Query):
            return execute_query_numpy(q, catalog)

        pool = None
        warmup_oracle = None
        counters = None
    else:
        from concurrent.futures import ThreadPoolExecutor

        if config.mesh_devices > 1:
            from ..parallel.multihost import init_distributed

            init_distributed()  # no-op unless S18_COORD_ADDR is set
            if config.compile_queries and not config.trace:
                from ..parallel.dist_compiled import DistCompiledEngine

                engine = DistCompiledEngine(catalog, config)
            else:
                from ..parallel.dist_engine import DistJaxEngine

                engine = DistJaxEngine(catalog, config)
        elif config.compile_queries and not config.trace:
            from ..engine.compiled import CompiledEngine

            engine = CompiledEngine(catalog, config)
        else:
            from ..engine.executor import JaxEngine

            engine = JaxEngine(catalog, config)
        counters = engine.counters
        # Async prep (default): serving starts the moment the engine
        # exists; prefetch (device transfers, presorts, key tables,
        # vault restore) runs in a daemon thread and the first queries
        # build exactly the columns they need on demand (the per-column
        # caches make the duplicate work benign).  Wall-clock becomes
        # max(prefetch, serving critical path) instead of their sum —
        # the contest harness starts its stopwatch 1 s after `Done`
        # (harness.cpp:206-208), long before a cold prefetch finishes.
        # S18_ASYNC_PREP=0 restores blocking prep (debugging).
        device_ready = threading.Event()
        if os.environ.get("S18_ASYNC_PREP", "1") != "0":
            def prep():
                try:
                    engine.prefetch()
                    if hasattr(engine, "quiesce"):
                        engine.quiesce()
                finally:
                    device_ready.set()

            threading.Thread(target=prep, daemon=True,
                             name="s18prefetch").start()
        else:
            engine.prefetch()
            device_ready.set()
        run_async = engine.execute_async
        # Tiered warm-up serving: until the device engine is warm
        # (prefetch + vault restores done), queries over SMALL inputs
        # are answered by the exact host oracle, so device start-up
        # never blocks the first batches.  The oracle is the same
        # differential-test twin that backs the poisoned-device tier;
        # answers are exact either way, and each one is counted
        # (counters["warmup_host"]).  Row bound S18_WARMUP_ORACLE
        # (total referenced base rows; 0 disables) keeps at-scale
        # queries on the device path.
        warmup_max = int(os.environ.get("S18_WARMUP_ORACLE",
                                        str(1 << 21)))

        def warmup_oracle(q: Query):
            if warmup_max <= 0 or device_ready.is_set():
                return None
            try:
                rows = sum(catalog.relation(r).num_tuples
                           for r in q.relations)
                if rows > warmup_max:
                    return None
                # Forest queries (most) answer via the factorized twin:
                # zero materialization, so no first-touch page faults on
                # huge repeat-expansions.
                from ..engine.factorized import execute_query_factorized_np

                line = execute_query_factorized_np(q, catalog)
                if line is None:
                    from ..engine.oracle import execute_query_numpy

                    line = execute_query_numpy(q, catalog)
            except Exception:  # noqa: BLE001 — device path serves it
                return None
            counters.add("warmup_host")
            return line

        # Threads overlap per-query host syncs; device execution stays
        # serialized (and deterministic) inside XLA.  Not on a mesh:
        # programs with collectives must reach every device in the same
        # order, and programs dispatched from several threads can
        # interleave differently per device and wait on each other's
        # collectives forever.
        pool = (ThreadPoolExecutor(config.batch_workers)
                if config.batch_workers > 1 and config.mesh_devices <= 1
                else None)

    served = {"queries": 0, "errors": 0}
    served_lock = threading.Lock()  # batch workers fail concurrently

    def null_line(q: Query) -> str:
        with served_lock:
            served["errors"] += 1
        return " ".join("NULL" for _ in q.views) if q.views else "NULL"

    def start(q: Query):
        # Per-query fault isolation: one bad query must not kill the batch
        # (the reference exits the process on internal errors, query.c:424;
        # we degrade to a NULL line and keep serving).
        try:
            if warmup_oracle is not None:  # jax path: warm-up tier
                line = warmup_oracle(q)
                if line is not None:
                    return line
            return run_async(q)
        except Exception as exc:  # noqa: BLE001
            print(f"query error: {exc!r} in {q.text!r}", file=sys.stderr)
            return null_line(q)

    def finish(q: Query, res) -> str:
        if isinstance(res, str):
            return res
        try:
            return res.line()
        except Exception as exc:  # noqa: BLE001
            print(f"query error: {exc!r} in {q.text!r}", file=sys.stderr)
            return null_line(q)

    def run_batch(batch: List[Query]) -> None:
        # Dispatch the whole batch to the device before fetching any
        # result line (SURVEY §7.3 batch-level pipelining).
        if pool is not None:
            results = list(pool.map(start, batch))
        else:
            results = [start(q) for q in batch]
        try:
            from ..engine.executor import format_batch

            lines = format_batch(results)
        except Exception:  # degraded path: per-query fetch
            lines = [finish(q, res) for q, res in zip(batch, results)]
        served["queries"] += len(lines)
        for line in lines:
            stdout.write(line + "\n")
        stdout.flush()

    batch: List[Query] = []
    batches_done = 0
    for raw in stdin:
        line = raw.strip()
        if line == "Exit":
            break
        if not line:
            continue
        if line == "F":
            run_batch(batch)
            batch = []
            batches_done += 1
            if (config.cache_clear_batches
                    and batches_done % config.cache_clear_batches == 0):
                import jax

                jax.clear_caches()  # bound program-cache growth
            continue
        try:
            batch.append(parse_query(line))
        except Exception as exc:  # noqa: BLE001
            print(f"parse error: {exc!r} in {line!r}", file=sys.stderr)
            batch.append(Query((), (), ((0, 0),), text=line))
    # Trailing unterminated batch (EOF without final F) still executes,
    # matching the C++ driver's per-line behavior (main.cpp:17-22).
    run_batch(batch)

    # Which tier answered what: every query not answered by a host tier
    # (or failed to a NULL line) was answered by the device.
    if counters is None:
        tiers = dict(served, numpy_backend=served["queries"]
                     - served["errors"])
        memory = None
    else:
        tiers = dict(served, **counters.snapshot())
        tiers["device"] = (served["queries"] - served["errors"]
                           - tiers["warmup_host"] - tiers["failure_host"])
        if hasattr(engine, "_vault"):
            tiers["vault"] = dict(engine._vault().counters)
        memory = _device_memory()
    print(serve_summary(tiers, clock.seconds if clock else None, memory),
          file=sys.stderr)


def main() -> None:
    run_protocol(sys.stdin, sys.stdout)
    # Hard exit: daemon prep threads (prefetch, vault restores) may
    # still sit inside native code; interpreter teardown cancels them
    # mid-C++ and glibc aborts with "FATAL: exception not rethrown".  Every result line is already flushed — skip teardown.
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


if __name__ == "__main__":
    main()
