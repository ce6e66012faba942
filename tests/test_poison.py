"""Backend-poisoning regression: the failure mode observed on an
earlier backend is one program whose fetch raises, after which EVERY
device dispatch in the process raises (the device state is wedged —
round-3 bench crash).  The batch must still return CORRECT lines (the
host-oracle last-resort tier) and the process must survive, flipping
into oracle-only serving."""

import dataclasses

import numpy as np
import pytest

from sigmod2018_tpu.config import EngineConfig
from sigmod2018_tpu.engine.compiled import CompiledEngine
from sigmod2018_tpu.engine.executor import (JaxEngine, PendingResult,
                                            format_batch)
from sigmod2018_tpu.engine.oracle import execute_query_numpy
from sigmod2018_tpu.frontend.parser import parse_query
from sigmod2018_tpu.storage.catalog import Catalog
from sigmod2018_tpu.storage.relation import Relation

QUERIES = [
    "0 1|0.0=1.0|0.1 1.2",
    "0 1 2|0.0=1.0&1.1=2.1|0.2 2.0",
    "0 1|0.0=1.0&0.1>250|1.1",
]


def _catalog(seed=5, rows=2000, dom=400):
    rng = np.random.default_rng(seed)
    rels = [Relation(columns=[rng.integers(0, dom, rows).astype(np.uint64)
                              for _ in range(3)]) for _ in range(3)]
    return Catalog(rels)


class _PoisonPacked:
    """A device array whose program failed: materialization raises."""

    ndim = 1

    def __array__(self, *a, **k):
        raise RuntimeError("deferred device failure (simulated)")


def _wedge(engine, monkeypatch):
    """Simulate the wedged device: every subsequent device program —
    the plain-jit retry, the incremental path, even a trivial health
    probe — raises."""
    def boom(*a, **k):
        raise RuntimeError("INVALID_ARGUMENT: backend error (simulated)")

    monkeypatch.setattr(engine, "_run_incremental", boom)
    monkeypatch.setattr(engine, "_device_healthy", lambda: False)


@pytest.mark.parametrize("engine_cls", [CompiledEngine, JaxEngine])
def test_poisoned_fetch_recovers_with_correct_lines(engine_cls,
                                                    monkeypatch):
    cat = _catalog()
    cfg = EngineConfig.from_env()
    eng = engine_cls(cat, cfg)
    eng.prefetch()
    queries = [parse_query(t) for t in QUERIES]
    expected = [execute_query_numpy(q, cat) for q in queries]

    results = [eng.execute_async(q) for q in queries]
    # Poison the middle result the way the hardware does: its packed
    # vector fails at fetch time, and from then on the whole device is
    # wedged (every dispatch raises).
    assert isinstance(results[1], PendingResult)
    results[1].packed = _PoisonPacked()
    if engine_cls is CompiledEngine:
        _wedge(eng, monkeypatch)
    else:
        monkeypatch.setattr(eng, "_device_healthy", lambda: False)

    lines = format_batch(results)
    assert lines == expected  # correct answers, not NULLs
    # the engine noticed the wedge and flipped to oracle-only serving
    assert eng.__dict__.get("_device_poisoned") is True


def test_oracle_only_mode_serves_correctly(monkeypatch):
    """After the flip, every later query short-circuits to the host
    oracle without touching the device."""
    cat = _catalog(seed=9)
    eng = CompiledEngine(cat, EngineConfig.from_env())
    eng.__dict__["_device_poisoned"] = True

    def boom(*a, **k):  # the device must not be touched at all
        raise AssertionError("device dispatch in oracle-only mode")

    monkeypatch.setattr(eng, "_execute_async_device", boom)
    for t in QUERIES:
        q = parse_query(t)
        assert eng.execute_async(q) == execute_query_numpy(q, cat)


def test_dispatch_time_device_failure_recovers(monkeypatch):
    """A failure at DISPATCH time (not fetch) also lands on the oracle
    tier: execute_async returns the correct line as a plain string."""
    cat = _catalog(seed=11)
    eng = CompiledEngine(cat, EngineConfig.from_env())
    eng.prefetch()

    def boom(*a, **k):
        raise RuntimeError("INVALID_ARGUMENT: backend error (simulated)")

    monkeypatch.setattr(eng, "_execute_async_device", boom)
    monkeypatch.setattr(eng, "_device_healthy", lambda: False)
    q = parse_query(QUERIES[0])
    assert eng.execute_async(q) == execute_query_numpy(q, cat)
    assert eng.__dict__.get("_device_poisoned") is True


def test_healthy_device_single_bad_program_stays_on_device(monkeypatch):
    """A program-specific failure with a HEALTHY device must not flip
    the engine into oracle-only mode: the query is answered (oracle
    tier), later queries keep the device path."""
    cat = _catalog(seed=13)
    eng = CompiledEngine(cat, EngineConfig.from_env())
    eng.prefetch()
    q0, q1 = (parse_query(t) for t in QUERIES[:2])
    res = eng.execute_async(q0)
    assert isinstance(res, PendingResult)
    res.packed = _PoisonPacked()
    monkeypatch.setattr(eng, "_run_incremental",
                        lambda *a, **k: (_ for _ in ()).throw(
                            RuntimeError("stale program (simulated)")))
    assert res.line() == execute_query_numpy(q0, cat)
    assert not eng.__dict__.get("_device_poisoned")
    monkeypatch.undo()
    r1 = eng.execute_async(q1)
    got = r1 if isinstance(r1, str) else r1.line()
    assert got == execute_query_numpy(q1, cat)
