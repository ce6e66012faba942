"""Planner tests: selectivity math (stats.c:88-259) and DP join
enumeration (best_tree.c:105-223)."""

import numpy as np

from sigmod2018_tpu.engine.oracle import execute_query_numpy
from sigmod2018_tpu.frontend.parser import parse_query
from sigmod2018_tpu.planner import plan_joins
from sigmod2018_tpu.planner.stats import QueryStats
from sigmod2018_tpu.storage.catalog import Catalog
from sigmod2018_tpu.storage.relation import Relation


def _catalog(rng, sizes, keyspace=100):
    rels = []
    for n in sizes:
        cols = [rng.integers(0, keyspace, size=n).astype(np.uint64)
                for _ in range(3)]
        rels.append(Relation(columns=cols))
    return Catalog(rels)


def test_equality_filter_stats():
    rng = np.random.default_rng(0)
    cat = _catalog(rng, [1000])
    q = parse_query("0|0.0=5|0.0")
    st = QueryStats(q, cat)
    st.apply(q.predicates[0])
    s = st.get(0, 0)
    assert s.d == 1 and s.l == 5 and s.u == 5
    assert s.f <= 1000


def test_range_filter_scales_linearly():
    rng = np.random.default_rng(1)
    cat = _catalog(rng, [1000], keyspace=100)
    q = parse_query("0|0.0<50|0.0")
    st = QueryStats(q, cat)
    f_before = st.get(0, 0).f
    st.apply(q.predicates[0])
    s = st.get(0, 0)
    assert 0 < s.f < f_before
    assert s.u <= 50


def test_join_order_small_build_first():
    """A tiny filtered relation should be joined before a huge one."""
    rng = np.random.default_rng(2)
    # r0 joins r1 (huge fanout) and r2 (tiny); starting with r2 is cheaper.
    r0 = Relation(columns=[np.arange(1000, dtype=np.uint64)] * 3)
    r1 = Relation(columns=[np.zeros(5000, dtype=np.uint64)] * 3)  # hot key 0
    r2 = Relation(columns=[np.arange(10, dtype=np.uint64)] * 3)
    cat = Catalog([r0, r1, r2])
    q = parse_query("0 1 2|0.0=1.0&0.1=2.0|0.0")
    order = plan_joins(q, cat)
    assert [str(p) for p in order] == ["0.1=2.0", "0.0=1.0"]


def test_cycle_edge_reinserted():
    rng = np.random.default_rng(3)
    cat = _catalog(rng, [200, 200, 200])
    q = parse_query("0 1 2|0.0=1.0&1.1=2.1&0.1=2.0|0.0")
    order = plan_joins(q, cat)
    # All three predicates must survive planning (the cycle-closing edge
    # becomes a value-equality selection).
    assert len(order) == 3
    assert {str(p) for p in order} == {"0.0=1.0", "1.1=2.1", "0.1=2.0"}


def test_planned_order_preserves_results():
    rng = np.random.default_rng(4)
    cat = _catalog(rng, [300, 250, 120, 90], keyspace=40)
    for qtext in [
        "0 1 2|0.0=1.0&1.1=2.1|0.2 2.0",
        "0 1 2 3|0.0=1.0&1.1=2.1&2.2=3.0|3.1",
        "0 1 2|0.0=1.0&1.1=2.1&0.1=2.0|0.0 1.0 2.0",
    ]:
        q = parse_query(qtext)
        order = plan_joins(q, cat)
        with_plan = execute_query_numpy(q, cat, join_order=order)
        without = execute_query_numpy(q, cat)
        assert with_plan == without, qtext


def test_duplicate_pair_predicates_kept():
    rng = np.random.default_rng(5)
    cat = _catalog(rng, [100, 100])
    q = parse_query("0 1|0.0=1.0&0.1=1.1|0.0")
    order = plan_joins(q, cat)
    assert len(order) == 2


def test_mcv_sketch_sees_hot_keys():
    """The 1-bucket MCV sketch must surface hot-key join fanout the
    span-based formula misses (Zipf robustness)."""
    rng = np.random.default_rng(6)
    # r0.c0: half the rows are key 7 spread over a huge value range
    hot = np.full(500, 7, dtype=np.uint64)
    rest = rng.integers(0, 1 << 40, size=500, dtype=np.uint64)
    r0 = Relation(columns=[np.concatenate([hot, rest])] * 3)
    r1 = Relation(columns=[np.concatenate([hot, rest])] * 3)
    cat = Catalog([r0, r1])
    q = parse_query("0 1|0.0=1.0|0.0")
    st = QueryStats(q, cat)
    est = st.estimate_after(q.joins[0])
    # hot key alone contributes 500*500 = 250000 pairs; the span formula
    # would estimate ~0 (1000*1000 / 2^40)
    assert est >= 250000


def test_blowup_retry_net():
    """A plan whose intermediate exceeds the cap retries in text order."""
    import jax

    from sigmod2018_tpu.config import EngineConfig
    from sigmod2018_tpu.engine.executor import JaxEngine
    from sigmod2018_tpu.engine.oracle import execute_query_numpy

    rng = np.random.default_rng(7)
    rels = [Relation(columns=[rng.integers(0, 10, size=200).astype(np.uint64)
                              for _ in range(3)]) for _ in range(3)]
    cat = Catalog(rels)
    q = parse_query("0 1 2|0.0=1.0&1.1=2.1|0.2")
    # Absurdly low cap: every plan blows it, forcing the retry path.
    eng = JaxEngine(cat, EngineConfig(max_intermediate=10))
    assert eng.execute(q) == execute_query_numpy(q, cat)


def test_join_orders_match_reference_joinenum(small_catalog, small_workload):
    """Pin the DP's chosen orders against the reference's actual JoinEnum
    output on every small-workload query that reaches the DP (VERDICT r1
    weak #6; fixture provenance in tests/fixtures/small_joinenum_plans.txt).

    The single documented deviation: we keep cycle-closing predicates the
    reference drops (join_order.py docstring), so the comparison removes
    predicates absent from the reference plan before asserting equality —
    the tree-edge sequence and duplicate-pair re-insertion points must
    match exactly.

    Parity is asserted under the reference estimator (S18_ESTIMATOR=ref
    semantics): the default "dbound" estimator deliberately diverges —
    it adds the System-R distinct bound the reference lacks, which
    fixes the backwards chain plans the span formula produces after
    equality filters (planner/stats.py ESTIMATOR comment; 20M-row
    intermediates instead of ~100 on workloads/scaled)."""
    import pathlib

    from sigmod2018_tpu.planner import stats as _stats

    old = _stats.ESTIMATOR
    _stats.ESTIMATOR = "ref"
    try:
        _ref_parity_body(small_catalog, small_workload)
    finally:
        _stats.ESTIMATOR = old


def _ref_parity_body(small_catalog, small_workload):
    import pathlib

    fixture = pathlib.Path(__file__).parent / "fixtures" / "small_joinenum_plans.txt"
    ref_plans = {}
    for line in fixture.read_text().splitlines():
        if not line.startswith("PLAN"):
            continue
        parts = line.split()
        ref_plans[int(parts[1])] = parts[2:]
    assert len(ref_plans) == 32

    _, work, _ = small_workload
    queries = [l for l in work if l.strip() and l.strip() != "F"]

    for qi, text in enumerate(queries):
        if qi not in ref_plans:
            continue
        q = parse_query(text)
        order = [f"{j.binding1}.{j.column1}={j.binding2}.{j.column2}"
                 for j in plan_joins(q, small_catalog)]
        ref = ref_plans[qi]
        common = [p for p in order if p in ref]
        assert common == ref, (
            f"query {qi} ({text}): planner order {order} vs reference {ref}")
