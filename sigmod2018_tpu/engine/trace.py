"""Per-operator tracing (SURVEY §5: the reference has only commented-out
clock() calls, handler.c:65,98; here tracing is a first-class debug mode).

With `EngineConfig.trace` on, every device operator is timed and a
per-query report goes to stderr: operator name, input shapes, and
milliseconds.  Each record also carries the bytes the operator touches,
so `report()` can print the achieved share of the device's memory
bandwidth — only for a device whose peak is in `PEAK_BYTES_PER_SEC`.

Timing: each traced call runs once for its result (compiling on first
use) and is drained with `block_until_ready`; the op then runs once
more, timed from dispatch to `block_until_ready`.  Host dispatch is
inside the timed span.  Tracing serializes the pipeline and doubles the
device work — never enable it when benchmarking.

`S18_TRACE=json` emits one JSON object per query on stderr (machine-
readable: per-op ms, bytes, shapes) instead of the aligned table,
pairing with `S18_EXPLAIN=1`'s est-vs-actual cardinalities.
"""

from __future__ import annotations

import json
import sys
import time
from typing import Any, List, Optional, Tuple

import jax

# Published device-memory bandwidth by `device_kind`, bytes/s.  A device
# not listed gets no bandwidth share: a guessed peak is worse than none.
PEAK_BYTES_PER_SEC = {
    # NVIDIA H100 SXM data sheet: 80 GB HBM3 at 3.35 TB/s.
    "NVIDIA H100 80GB HBM3": 3.35e12,
}


def peak_bytes_per_sec(device_kind: str) -> Optional[float]:
    return PEAK_BYTES_PER_SEC.get(device_kind)


def _nbytes(x: Any) -> int:
    if isinstance(x, jax.Array):
        return x.size * x.dtype.itemsize
    if isinstance(x, (tuple, list)):
        return sum(_nbytes(v) for v in x)
    return 0


class Tracer:
    def __init__(self, out=None, mode: str = "table",
                 device_kind: Optional[str] = None):
        self.out = out or sys.stderr
        self.mode = mode
        if device_kind is None:
            device_kind = jax.devices()[0].device_kind
        self.peak = peak_bytes_per_sec(device_kind)
        # (op name, shapes, ms, bytes)
        self.records: List[Tuple[str, str, float, int]] = []

    def reset(self) -> None:
        self.records = []

    def record(self, name: str, args, result, ms: float) -> None:
        shapes = ",".join(
            str(tuple(a.shape)) for a in args if isinstance(a, jax.Array)
        )
        self.records.append((name, shapes, ms,
                             _nbytes(args) + _nbytes(result)))

    def bw_share(self, nbytes: int, ms: float) -> Optional[float]:
        """Achieved bytes/s over the device's peak, or None when the
        peak is unknown or the op took no measurable time."""
        if self.peak is None or ms <= 0:
            return None
        return nbytes / (ms / 1e3) / self.peak

    def report(self, label: str = "") -> None:
        if self.mode == "json":
            ops_ = []
            for name, shapes, ms, nbytes in self.records:
                share = self.bw_share(nbytes, ms)
                ops_.append({"op": name, "shapes": shapes,
                             "ms": round(ms, 4), "bytes": nbytes,
                             "bw_share": (round(share, 4)
                                          if share is not None else None)})
            print(json.dumps({"query": label, "ops": ops_}), file=self.out)
            return
        total = sum(ms for _, _, ms, _ in self.records)
        print(f"-- trace {label}: {total:.2f} ms total", file=self.out)
        for name, shapes, ms, nbytes in self.records:
            share = self.bw_share(nbytes, ms)
            frac = f" bw={share * 100:5.1f}%" if share is not None else ""
            print(f"--   {name:22s} {ms:8.3f} ms  [{shapes}]{frac}",
                  file=self.out)


class TimedOps:
    """Proxy over the ops module that times every device call: one
    dispatch for the returned value (drained), then one timed re-run
    ending in block_until_ready."""

    def __init__(self, ops_module, tracer: Tracer):
        self._ops = ops_module
        self._tracer = tracer

    def __getattr__(self, name: str):
        fn = getattr(self._ops, name)
        if not callable(fn):
            return fn

        def timed(*args, **kwargs):
            result = fn(*args, **kwargs)
            if not any(isinstance(v, jax.Array)
                       for v in jax.tree_util.tree_leaves(result)):
                return result  # host-side op: nothing to device-time
            jax.block_until_ready(result)  # compile + drain prior work
            t0 = time.perf_counter()
            jax.block_until_ready(fn(*args, **kwargs))
            self._tracer.record(name, args, result,
                                (time.perf_counter() - t0) * 1e3)
            return result

        return timed
