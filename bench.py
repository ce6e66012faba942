"""Benchmark: the contest small workload end-to-end on the real backend.

Mirrors the reference harness's metric (harness.cpp:292-299): wall-clock ms
for all 50 queries of workloads/small, valid only at 0 mismatches.  The
relation-loading / device-transfer / compilation prep is untimed, matching
the contest's untimed prep window (harness.cpp:175-208) — warm passes run
every query so jit compilation lands in the prep phase (the persistent
cache in .jax_cache makes reruns cheap), then the timed pass executes the
whole workload again.

Observability + deadline: every phase prints a progress line to stderr,
and a hard overall deadline (S18_BENCH_DEADLINE seconds, default 2700)
kills the process with a diagnostic instead of letting a wedged phase
hang.  Warm pass structure: two SERIAL passes — the first learns exact
intermediate size classes, the second compiles the learned-class
programs and times each query alone — then one pipelined pass
exercising the threaded serving path before the clock starts.

Self-diagnostics: the emitted JSON carries a `diag` object — the device
(JAX platform, device kind and count; nvidia-smi name and power limit),
vault restore/build/fail counters, phase times, warm-vs-timed ratio, and
the top-5 slowest queries of the serial warm pass.

Baseline: the reference C engine built from /root/reference measured
892 ms on this container (median of 3 idle runs, 2026-08-17; BASELINE.md);
`vs_baseline` is our_ms/ref_ms (< 1.0 means faster than the reference on
the same machine).

Prints ONE JSON line:
  {"metric": "small_workload_wall_ms", "value": N, "unit": "ms",
   "vs_baseline": N, "mismatches": N, "diag": {...}}

An optional workload directory argument benchmarks another fixture set
with the same methodology (e.g. `python bench.py workloads/scaled`);
the metric name and the reference-ms baseline follow the workload
(reference C engine re-measured idle on this container, BASELINE.md).
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from pathlib import Path

SMALL = Path("/root/reference/submission/workloads/small")
# Reference C engine wall-clock on this container, idle (BASELINE.md).
# None = the reference cannot produce a valid baseline there: zipf it
# answers 1/12 wrong (empty-join NULL bug), bigdom it answers 8/8 wrong
# (filter constants past 2^31 go through atoi into int, query.c:239),
# zipfbig it crashes (closed stdout mid-batch).  big measured
# 2026-08-20 via build/harness, idle, 0 mismatches.
REFERENCE_MS = {"small": 892.0, "scaled": 381.0, "zipf": None,
                "big": 31852.0, "bigdom": None, "zipfbig": None}

_T0 = time.monotonic()


def log(msg: str) -> None:
    print(f"[bench +{time.monotonic() - _T0:7.1f}s] {msg}",
          file=sys.stderr, flush=True)


def _arm_deadline(seconds: float) -> None:
    """Hard overall deadline: a wedged phase must fail loud in minutes,
    not hang for an hour."""
    def watchdog() -> None:
        while True:
            left = seconds - (time.monotonic() - _T0)
            if left <= 0:
                break
            time.sleep(min(left, 5.0))
        log(f"DEADLINE EXCEEDED ({seconds:.0f}s): a phase is wedged; "
            f"aborting")
        import faulthandler

        faulthandler.dump_traceback(file=sys.stderr)
        os._exit(3)

    threading.Thread(target=watchdog, daemon=True,
                     name="bench-deadline").start()


def main() -> None:
    from sigmod2018_tpu.config import EngineConfig
    from sigmod2018_tpu.engine.executor import JaxEngine, format_batch
    from sigmod2018_tpu.frontend.parser import parse_work_file
    from sigmod2018_tpu.storage.catalog import Catalog

    from sigmod2018_tpu.utils.device import card_name_and_power, jax_device

    _arm_deadline(float(os.environ.get("S18_BENCH_DEADLINE", "2700")))

    wl = Path(sys.argv[1]).resolve() if len(sys.argv) > 1 else SMALL
    name = wl.name
    diag: dict = {"device": jax_device(), "card": card_name_and_power()}
    init = [
        str(wl / line.strip().split("/")[-1])
        for line in (wl / f"{name}.init").read_text().splitlines()
        if line.strip()
    ]
    batches = list(parse_work_file((wl / f"{name}.work").read_text().splitlines()))
    expected = [
        l for l in (wl / f"{name}.result").read_text().splitlines() if l.strip()
    ]
    nq = sum(len(b) for b in batches)
    log(f"workload={name} queries={nq} batches={len(batches)} "
        f"device={diag['device']} card={diag['card']}")

    # ---- untimed prep: load, transfer, compile (contest prep window) ----
    from concurrent.futures import ThreadPoolExecutor

    config = EngineConfig.from_env()
    t0 = time.perf_counter()
    catalog = Catalog.from_files(init)
    log("catalog loaded")
    if config.compile_queries:
        from sigmod2018_tpu.engine.compiled import CompiledEngine

        engine = CompiledEngine(catalog, config)
    else:
        engine = JaxEngine(catalog, config)
    engine.prefetch()
    diag["prep_ms"] = round((time.perf_counter() - t0) * 1000.0, 1)
    log(f"prefetch done (vault={'on' if config.vault else 'off'})")
    pool = ThreadPoolExecutor(max(config.batch_workers, 1))

    def run_batch(batch):
        # Same pipeline as io/repl.py: dispatch the whole batch, then one
        # packed fetch for every result.
        results = list(pool.map(engine.execute_async, batch))
        return format_batch(results)

    # Serial warm pass 1: first execution of every query — guessed-class
    # programs compile one at a time; exact size classes are learned
    # here.
    queries = [q for batch in batches for q in batch]
    t0 = time.perf_counter()
    for i, q in enumerate(queries):
        engine.execute(q)
        if (i + 1) % 10 == 0 or i + 1 == nq:
            log(f"warm pass 1 (serial, learning): {i + 1}/{nq}")
    diag["warm1_ms"] = round((time.perf_counter() - t0) * 1000.0, 1)
    # Serial warm pass 2: queries whose learned classes differ from the
    # guesses rebuild here — still one compile at a time.  Per-query
    # wall times here attribute slowness to specific queries (the
    # pipelined passes interleave, so only the serial pass can).
    t0 = time.perf_counter()
    per_q = []
    for i, q in enumerate(queries):
        tq = time.perf_counter()
        engine.execute(q)
        per_q.append((round((time.perf_counter() - tq) * 1000.0, 2),
                      q.text))
        if (i + 1) % 10 == 0 or i + 1 == nq:
            log(f"warm pass 2 (serial, learned classes): {i + 1}/{nq}")
    diag["warm2_ms"] = round((time.perf_counter() - t0) * 1000.0, 1)
    diag["slowest_queries"] = [
        {"ms": ms, "q": text}
        for ms, text in sorted(per_q, reverse=True)[:5]]
    # Pipelined warm pass: the threaded serving path (pure dispatch now —
    # every program is compiled) + output validation.
    t0 = time.perf_counter()
    warm = [line for batch in batches for line in run_batch(batch)]
    warm_ms = (time.perf_counter() - t0) * 1000.0
    diag["warm3_ms"] = round(warm_ms, 1)
    mismatches = sum(1 for got, want in zip(warm, expected) if got != want)
    mismatches += abs(len(warm) - len(expected))
    log(f"warm pass 3 (pipelined): {warm_ms:.1f} ms, "
        f"mismatches={mismatches}")
    if hasattr(engine, "quiesce"):
        engine.quiesce()  # no background prep may bleed into the clock
    vault = getattr(engine, "_vault", None)
    if vault is not None:
        v = vault()
        diag["vault"] = dict(v.counters, nready=len(v._ready),
                             enabled=v.enabled)
        log(f"vault: {diag['vault']}")
    if getattr(engine, "__dict__", {}).get("_device_poisoned"):
        log("WARNING: device poisoned during warm-up — timed pass would "
            "measure the host oracle; failing loud instead")
        print(json.dumps({"metric": f"{name}_workload_wall_ms",
                          "value": None, "unit": "ms",
                          "vs_baseline": None,
                          "mismatches": mismatches,
                          "error": "device poisoned during warm-up",
                          "diag": diag}))
        sys.exit(4)

    # ---- timed pass -----------------------------------------------------
    # All batches dispatch before any fetch — the contest harness feeds
    # batches through a select() loop without waiting for results
    # (harness.cpp:214-263), so the engine sees every query before it
    # must answer the first batch; one packed fetch drains everything
    # (the same pipelining io/repl.py applies when the pipe fills).
    log("timed pass starting")
    t0 = time.perf_counter()
    results = list(pool.map(engine.execute_async, queries))
    format_batch(results)
    ms = (time.perf_counter() - t0) * 1000.0
    log(f"timed pass: {ms:.1f} ms")
    diag["timed_over_warm3"] = round(ms / warm_ms, 3) if warm_ms else None

    ref_ms = REFERENCE_MS.get(name)
    print(json.dumps({
        "metric": f"{name}_workload_wall_ms",
        "value": round(ms, 2),
        "unit": "ms",
        # None for workloads where the reference engine answers wrongly
        # (zipf: 1/12 mismatches, BASELINE.md) — no valid baseline exists.
        "vs_baseline": round(ms / ref_ms, 4) if ref_ms else None,
        "mismatches": mismatches,
        "diag": diag,
    }))
    if mismatches:
        print(f"BENCH INVALID: {mismatches} mismatches", file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
