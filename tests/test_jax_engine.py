"""JAX engine: unit semantics + bit-exactness on the small workload,
differential vs the NumPy oracle on random queries."""

import numpy as np
import pytest

from sigmod2018_tpu.config import EngineConfig
from sigmod2018_tpu.engine.executor import JaxEngine
from sigmod2018_tpu.engine.oracle import execute_query_numpy
from sigmod2018_tpu.frontend.parser import parse_query, parse_work_file
from sigmod2018_tpu.storage.catalog import Catalog
from sigmod2018_tpu.storage.relation import Relation, make_identity_relation


@pytest.fixture(scope="module")
def tiny_engine():
    cat = Catalog([make_identity_relation(10, 3), make_identity_relation(5, 2)])
    return JaxEngine(cat)


@pytest.mark.parametrize(
    "query,expected",
    [
        ("0 1|0.0=1.0|0.0 1.1", "10 10"),
        ("0 1|0.0=1.0&0.0>2|0.0", "7"),
        ("0|0.1=7|0.0 0.2", "7 7"),
        ("0 1|0.0=1.0&0.0>100|0.0 1.1", "NULL NULL"),
        ("0 1 1|0.0=1.0&1.0=2.0&0.0=2.0|0.0", "10"),
        ("0 1|0.0=1.0&0.1=1.1|0.0", "10"),
    ],
)
def test_unit_queries(tiny_engine, query, expected):
    assert tiny_engine.execute(parse_query(query)) == expected


def test_self_join_jax():
    r = Relation(columns=[np.array([1, 2, 3], dtype=np.uint64),
                          np.array([1, 5, 3], dtype=np.uint64)])
    eng = JaxEngine(Catalog([r]))
    assert eng.execute(parse_query("0|0.0=0.1|0.0")) == "4"


def test_small_workload_bit_exact(small_workload, small_catalog):
    _, work, expected = small_workload
    engine = JaxEngine(small_catalog)
    got = []
    for batch in parse_work_file(work):
        for q in batch:
            got.append(engine.execute(q))
    mismatches = [
        (i, g, e) for i, (g, e) in enumerate(zip(got, expected)) if g != e.strip()
    ]
    assert not mismatches, f"{len(mismatches)} mismatches, first: {mismatches[:3]}"


def test_differential_random_queries():
    """Random catalogs + random chain/star queries: JAX engine == oracle."""
    rng = np.random.default_rng(42)
    rels = []
    for _ in range(4):
        n = int(rng.integers(50, 400))
        cols = [rng.integers(0, 60, size=n).astype(np.uint64) for _ in range(3)]
        rels.append(Relation(columns=cols))
    cat = Catalog(rels)
    engine = JaxEngine(cat)
    for trial in range(15):
        nrel = int(rng.integers(2, 4))
        bindings = list(rng.integers(0, 4, size=nrel))
        preds = []
        for b in range(1, nrel):
            preds.append(f"{b-1}.{rng.integers(0,3)}={b}.{rng.integers(0,3)}")
        if rng.random() < 0.7:
            op = rng.choice(["<", ">", "="])
            preds.append(f"0.{rng.integers(0,3)}{op}{rng.integers(0, 70)}")
        views = " ".join(
            f"{rng.integers(0, nrel)}.{rng.integers(0, 3)}"
            for _ in range(int(rng.integers(1, 4)))
        )
        qtext = f"{' '.join(map(str, bindings))}|{'&'.join(preds)}|{views}"
        q = parse_query(qtext)
        assert engine.execute(q) == execute_query_numpy(q, cat), qtext


def test_empty_join_null_despite_bucket_overlap():
    """Empty equi-join -> NULL per view, even when the key exists on one
    side only (both sides non-empty, values sharing low bits).

    The reference C engine answers this WRONG on such data: a radix join
    whose bucket histograms overlap but whose keys never match returns a
    non-NULL zero-tuple result, and CalculateQueryResults
    (/root/reference/inter_res.c:320-339) has no zero-tuple check, so it
    prints "0 0" instead of "NULL NULL" (reproduced on workloads/zipf,
    query '0 3|0.0=1.0&0.0=784|0.2 0.2' — BASELINE.md).  The contest's
    C++ skeleton semantics (Joiner.cpp:108: NULL iff empty) and this
    engine print NULL."""
    # r0.col0 holds 784 (thrice); r1.col0 never does, but 784+16k values
    # share its low radix bits, so one-level radix buckets overlap.
    r0 = Relation(columns=[
        np.array([784, 784, 784, 5], dtype=np.uint64),
        np.array([1, 2, 3, 4], dtype=np.uint64),
        np.array([10, 20, 30, 40], dtype=np.uint64),
    ])
    r1 = Relation(columns=[
        np.array([800, 816, 768, 5 + 16], dtype=np.uint64),
        np.array([7, 8, 9, 11], dtype=np.uint64),
    ])
    cat = Catalog([r0, r1])
    q = parse_query("0 1|0.0=1.0&0.0=784|0.2 0.2")
    assert execute_query_numpy(q, cat) == "NULL NULL"
    eng = JaxEngine(cat)
    assert eng.execute(q) == "NULL NULL"
    from sigmod2018_tpu.engine.compiled import CompiledEngine

    ceng = CompiledEngine(cat, EngineConfig())
    assert ceng.execute(q) == "NULL NULL"


class _PoisonPacked:
    """Mimics a device array whose program failed: any materialization
    raises (jax defers program errors to the fetch)."""

    ndim = 1

    def __array__(self, *a, **k):
        raise RuntimeError("deferred device failure")


def test_fetch_retry_recovers_single():
    from sigmod2018_tpu.engine.compiled import SpecResult

    calls = []
    res = SpecResult(_PoisonPacked(), 2, (), 0, retry=lambda: "")
    res.fetch_retry = lambda: calls.append(1) or "42 43"
    assert res.line() == "42 43"
    assert calls == [1]


def test_fetch_retry_raises_without_handler():
    from sigmod2018_tpu.engine.compiled import SpecResult

    res = SpecResult(_PoisonPacked(), 1, (), 0, retry=lambda: "")
    with pytest.raises(RuntimeError):
        res.line()


def test_format_batch_survives_poisoned_program():
    """One poisoned program must not fail the whole batch: the flat
    fetch falls back to per-result fetches + per-result recovery."""
    import jax.numpy as jnp

    from sigmod2018_tpu.engine.compiled import SpecResult
    from sigmod2018_tpu.engine.executor import format_batch

    good = SpecResult(jnp.asarray(np.array([3, 7, 9], np.uint64)), 2,
                      (), 0, retry=lambda: "")
    bad = SpecResult(_PoisonPacked(), 1, (), 0, retry=lambda: "")
    bad.fetch_retry = lambda: "99"
    lines = format_batch([good, bad, "NULL"])
    assert lines == ["7 9", "99", "NULL"]
