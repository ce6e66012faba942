"""Engine configuration.

The reference hard-codes its knobs as compile-time #defines (structs.h:8-12:
CACHE_SIZE, RESULT_MAX_BUFFER, N_LSB, THREADS) and needs a recompile to change
them.  Here everything is a single runtime dataclass; jit caches are keyed on
the static values so no recompile of the framework is ever needed.
"""

from __future__ import annotations

import dataclasses
import os


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    # Operator backend: "jax" (XLA programs, GPU/CPU) or "numpy" (oracle).
    backend: str = "jax"

    # Minimum padded length for any device array (the smallest size
    # class: bounds the number of distinct program shapes).
    min_pad: int = 128

    # Join-order optimization via DP enumeration (reference best_tree.c).
    optimize_joins: bool = True

    # Fuse the last join of a query with the checksum reduction
    # (ops/agg_join.py): the final intermediate is never materialized.
    fuse_final_join: bool = True

    # Presort every base column at prep time (the contest prep window is
    # untimed): joins whose build side is an unfiltered base column skip
    # their argsort at query time (engine device_sorted_column).  Costs
    # one sorted copy + permutation per column of device memory.
    presort: bool = True

    # Domain-rank key tables (engine device_key_table): for a base join
    # column whose exact max value u (catalog stats) satisfies
    # u + 3 <= key_table_max, prep builds cumcnt[k] = #rows with key < k
    # over the whole domain — the data-parallel restatement of the
    # reference's bucket-chain index (rhjoin.c:219-309).  A join building on such a
    # column runs with ZERO sorts (two gathers give each probe row its
    # match range).  0 disables.  Device cost: 4*(u+3) bytes per column.
    key_table_max: int = 1 << 22

    # Whole-query segment compilation (engine/compiled.py): one XLA
    # program per intermediate-join sync point instead of one per
    # operator.  Single-join queries become one program, zero syncs.
    compile_queries: bool = True

    # Speculative intermediate sizing (engine/compiled.py): guess every
    # intermediate join's size class from planner estimates x spec_margin
    # and run the whole query as ONE program with zero host syncs; a
    # missed guess re-runs that query on the per-join sync path.  Guesses
    # whose class would exceed spec_max rows skip speculation (padded
    # compute and compile time grow with the class).
    speculate: bool = True
    spec_margin: int = 8

    # Replay the persisted serving history (learned size classes file)
    # during prefetch, warming every known query's XLA programs before
    # the timed phase.  Off by default: under the contest harness's 1 s
    # prep window the blocking replay costs more than it saves (see
    # CompiledEngine.prefetch); enable for serving restarts with a real
    # untimed prep window.
    warm_replay: bool = False
    spec_max: int = 1 << 22

    # Program vault (engine/vault.py): persist every compiled query
    # program (jax.export StableHLO) in the prep cache and restore them
    # during prefetch, so a cold process never pays Python trace/lower
    # inside the timed phase.  S18_VAULT=0 disables.
    vault: bool = True

    # Intermediate-result row cap: if a planned join order produces a
    # bigger intermediate, the query retries in original text order
    # (estimator misfires on adversarial skew; the text order is what
    # the workload author validated).  0 disables the net.
    max_intermediate: int = 1 << 26

    # Proactive factorized (Yannakakis message-passing) service: a
    # forest-shaped query whose PLANNED max intermediate reaches this
    # many rows answers via engine/factorized.py instead of
    # materializing — exact, and O(sum of relation sizes) instead of
    # O(intermediate) (workloads/scaled q11: a 4-relation chain with a
    # 20M-row true intermediate).  The reference engine has no such path (it materializes always,
    # inter_res.c).  0 disables.
    factorize_min: int = 1 << 22

    # Clear jit caches after every N batches (0 = never).  The compiled
    # engine holds one program per distinct query text; unbounded query
    # diversity in a long-lived server grows host memory without this.
    cache_clear_batches: int = 0

    # Threads dispatching queries of one batch concurrently.  Device work
    # is serialized by XLA; the threads overlap the per-query host work
    # (planning, dispatch) and host syncs.
    batch_workers: int = 8

    # Emit per-operator timings / chosen plans to stderr.
    explain: bool = False
    # Tracing: False, True (aligned table) or "json" (one JSON object
    # per query — machine-readable per-op device timings).
    trace: object = False

    # Multi-device: number of mesh devices to shard relations over
    # (1 = single device; >1 requires that many JAX devices).
    mesh_devices: int = 1

    # Cross-device shuffle transport: "a2a" (XLA all_to_all, full
    # fanout) or "ring" (ppermute neighbor hops, parallel/dist.py).
    exchange: str = "a2a"

    # Distributed join strategy cutover: a build side whose padded
    # GLOBAL row count is at or below this broadcasts via all_gather
    # (the big probe side moves nothing); larger builds hash-shuffle
    # both sides with all_to_all (parallel/dist_compiled.py).
    bcast_threshold: int = 4096

    # Skew-split joins (SURVEY §2.3 north-star row): a shuffle join
    # whose catalog MCV sketch shows a hot key carrying at least
    # skew_factor x the average per-chip row share takes the split —
    # hot build rows are all_gather'ed to every chip (duplicate build
    # rows), hot probe rows join LOCALLY, cold rows hash-shuffle as
    # usual — so the hot key's probe work spreads over the mesh instead
    # of hammering its hash owner.  0 disables.
    skew_factor: int = 2

    @staticmethod
    def from_env() -> "EngineConfig":
        def _flag(name: str, default: str) -> str:
            return os.environ.get(name, default)

        return EngineConfig(
            backend=_flag("S18_BACKEND", "jax"),
            optimize_joins=_flag("S18_OPTIMIZE", "1") != "0",
            fuse_final_join=_flag("S18_FUSE", "1") != "0",
            compile_queries=_flag("S18_COMPILE_QUERIES", "1") != "0",
            presort=_flag("S18_PRESORT", "1") != "0",
            key_table_max=int(_flag("S18_KEYTABLE", str(1 << 22))),
            speculate=_flag("S18_SPECULATE", "1") != "0",
            spec_margin=int(_flag("S18_SPEC_MARGIN", "8")),
            warm_replay=_flag("S18_WARM_REPLAY", "0") != "0",
            vault=_flag("S18_VAULT", "1") != "0",
            factorize_min=int(_flag("S18_FACTORIZE_MIN", str(1 << 22))),
            spec_max=int(_flag("S18_SPEC_MAX", str(1 << 22))),
            batch_workers=int(_flag("S18_WORKERS", "8")),
            cache_clear_batches=int(_flag("S18_CACHE_CLEAR", "0")),
            explain=_flag("S18_EXPLAIN", "0") == "1",
            trace={"0": False, "1": True}.get(
                _flag("S18_TRACE", "0"), _flag("S18_TRACE", "0")),
            mesh_devices=int(_flag("S18_MESH", "1")),
            bcast_threshold=int(_flag("S18_BCAST", "4096")),
            exchange=_flag("S18_EXCHANGE", "a2a"),
            skew_factor=int(_flag("S18_SKEW", "2")),
        )


DEFAULT_CONFIG = EngineConfig()
