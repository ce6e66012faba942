"""Distributed compiled engine on the 8-device virtual CPU mesh:
every join shuffle- or broadcast-executed inside shard_map, bit-exact
against the NumPy oracle, with no GSPMD-inserted cross-shard gathers
(VERDICT r1 #3 done-criteria)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sigmod2018_tpu.config import EngineConfig
from sigmod2018_tpu.engine.oracle import execute_query_numpy
from sigmod2018_tpu.frontend.parser import parse_query
from sigmod2018_tpu.parallel import make_mesh
from sigmod2018_tpu.parallel.dist_compiled import DistCompiledEngine
from sigmod2018_tpu.storage.catalog import Catalog
from sigmod2018_tpu.storage.relation import Relation

N_DEV = 8

QUERIES = [
    "0 1|0.0=1.0|0.1 1.2",                        # single join -> fused SPMD
    "0 1|0.0=1.0&0.1>20|0.1 1.2",                 # filter + fused join
    "0 1 2|0.0=1.0&1.1=2.1|0.2 1.0 2.2",          # chain: shuffle + fused
    "0 1 2|0.0=1.0&1.1=2.1&0.1=1.2|0.2 2.2",      # cycle edge (selection)
    "0 1|0.0=1.0&0.0>100|0.0 1.1",                # empty -> NULL
    "0 0|0.0=1.1|0.2 1.0",                        # same relation twice
    "0 1 2 3|0.0=1.0&1.1=2.1&2.2=3.0|3.1 0.1",    # 4-relation chain
    "0|0.0=0.1|0.2",                              # self-join only
    "2|0.0>5|0.1",                                # filter only
]


@pytest.fixture(scope="module")
def mesh():
    if len(jax.devices()) < N_DEV:
        pytest.skip(f"need {N_DEV} devices")
    return make_mesh(N_DEV)


@pytest.fixture(scope="module")
def catalog():
    rng = np.random.default_rng(31)
    rels = []
    for n in (700, 450, 230, 120):
        cols = [rng.integers(0, 60, size=n).astype(np.uint64)
                for _ in range(3)]
        rels.append(Relation(columns=cols))
    return Catalog(rels)


def test_matches_oracle(mesh, catalog):
    eng = DistCompiledEngine(catalog, EngineConfig(), mesh=mesh)
    for qtext in QUERIES:
        q = parse_query(qtext)
        assert eng.execute(q) == execute_query_numpy(q, catalog), qtext
    # every non-selection join took an explicit strategy
    assert eng.join_strategies, "no joins traced through the SPMD builder"
    assert set(eng.join_strategies) <= {"shuffle", "broadcast"}


def test_matches_oracle_no_speculation(mesh, catalog):
    eng = DistCompiledEngine(catalog, EngineConfig(speculate=False),
                             mesh=mesh)
    for qtext in QUERIES:
        q = parse_query(qtext)
        assert eng.execute(q) == execute_query_numpy(q, catalog), qtext


def test_broadcast_join_chosen_for_small_build(mesh, catalog):
    """A small build side must take the all_gather broadcast path."""
    eng = DistCompiledEngine(catalog, EngineConfig(bcast_threshold=1 << 14),
                             mesh=mesh)
    q = parse_query("0 3|0.0=1.0|0.1 1.1")  # relation 3 (120 rows) at binding 1
    assert eng.execute(q) == execute_query_numpy(q, catalog)
    assert "broadcast" in eng.join_strategies


def test_shuffle_join_chosen_for_large_build(mesh, catalog):
    eng = DistCompiledEngine(catalog, EngineConfig(bcast_threshold=0),
                             mesh=mesh)
    q = parse_query("0 1|0.0=1.0|0.1 1.2")
    assert eng.execute(q) == execute_query_numpy(q, catalog)
    assert eng.join_strategies == ["shuffle"]


def test_no_cross_shard_gather_in_hlo(mesh, catalog):
    """The compiled SPMD program's collectives are exactly the ones the
    engine wrote: all-to-all / all-gather / all-reduce.  GSPMD-inserted
    cross-shard gathers would show up as collective-permute + dynamic
    ops or unexpected all-gathers of full columns; shard_map bodies are
    manual, so none may appear."""
    eng = DistCompiledEngine(catalog, EngineConfig(bcast_threshold=0),
                             mesh=mesh)
    q = parse_query("0 1 2|0.0=1.0&1.1=2.1|0.2 1.0 2.2")
    joins, cols_used, n_classes, class_idx = eng._static_plan(q, True)
    from sigmod2018_tpu.engine.compiled import _skeletonize

    skel, consts = _skeletonize(q)
    cols = tuple(eng.device_column(r, c)[0] for r, c in cols_used)
    ns = tuple(eng.device_column(r, c)[1] for r, c in cols_used)
    classes = eng._guess_classes(q, joins, class_idx)
    fn = eng._spmd_program(skel, joins, classes, cols_used, ns)
    hlo = fn.lower(jnp.asarray(consts), *cols).compile().as_text()
    assert "all-to-all" in hlo
    assert "collective-permute" not in hlo


def test_zipf_skew_retry_stays_exact(mesh):
    """Zipf keys blow past the speculated per-chip caps; the pmax
    validation must catch it and the retry must stay bit-exact."""
    rng = np.random.default_rng(41)
    n = 2048
    rels = [
        Relation(columns=[
            np.minimum(rng.zipf(1.3, size=n), 500).astype(np.uint64),
            rng.integers(0, 1 << 30, size=n).astype(np.uint64),
        ]),
        Relation(columns=[
            np.minimum(rng.zipf(1.3, size=n), 500).astype(np.uint64),
            rng.integers(0, 1 << 30, size=n).astype(np.uint64),
        ]),
        Relation(columns=[
            rng.integers(0, 500, size=512).astype(np.uint64),
            rng.integers(0, 1 << 30, size=512).astype(np.uint64),
        ]),
    ]
    cat = Catalog(rels)
    eng = DistCompiledEngine(cat, EngineConfig(max_intermediate=1 << 24),
                             mesh=make_mesh(N_DEV))
    for qtext in [
        "0 1|0.0=1.0|0.1 1.1",
        "0 1 2|0.0=1.0&1.0=2.0|0.1 2.1",
    ]:
        q = parse_query(qtext)
        assert eng.execute(q) == execute_query_numpy(q, cat), qtext


def test_mesh4_shape_agnostic(catalog):
    if len(jax.devices()) < 4:
        pytest.skip("need 4 devices")
    eng = DistCompiledEngine(catalog, EngineConfig(), mesh=make_mesh(4))
    for qtext in QUERIES[:4]:
        q = parse_query(qtext)
        assert eng.execute(q) == execute_query_numpy(q, catalog), qtext


def test_ring_exchange_matches_a2a(mesh, catalog):
    """S18_EXCHANGE=ring: the ppermute neighbor-hop decomposition of the
    shuffle (dist._ring_all_to_all) is bit-equivalent to the XLA
    all_to_all transport on every query shape."""
    eng = DistCompiledEngine(
        catalog, EngineConfig(exchange="ring", bcast_threshold=0),
        mesh=mesh)
    for qtext in QUERIES:
        q = parse_query(qtext)
        assert eng.execute(q) == execute_query_numpy(q, catalog), qtext
    assert "shuffle" in eng.join_strategies


def test_hier_mesh_topology(mesh):
    """hier_mesh/flat_mesh_host_major group devices host-major so the 1-D
    shuffle axis keeps same-host chips adjacent (multihost.py; CI fakes
    the host grouping — one process owns all virtual devices)."""
    from sigmod2018_tpu.parallel import flat_mesh_host_major, hier_mesh

    hm = hier_mesh(fake_hosts=2)
    assert hm.devices.shape == (2, len(jax.devices()) // 2)
    assert hm.axis_names == ("host", "chip")
    fm = flat_mesh_host_major(fake_hosts=2)
    devs = list(fm.devices.reshape(-1))
    half = len(devs) // 2
    # first half of the flat axis = host 0's chips, in order
    assert [d.id for d in devs[:half]] == [d.id for d in hm.devices[0]]


def test_init_distributed_noop_without_env(monkeypatch):
    from sigmod2018_tpu.parallel import init_distributed

    monkeypatch.delenv("S18_COORD_ADDR", raising=False)
    assert init_distributed() is False


def _skewed_catalog(n=4096, dom=40):
    """Small key domain => per-destination send counts well below the
    full local length, so learned caps shrink the exchange buffers."""
    rng = np.random.default_rng(77)
    rels = [Relation(columns=[rng.integers(0, dom, n).astype(np.uint64),
                              rng.integers(0, 1 << 30, n).astype(np.uint64),
                              rng.integers(0, 1 << 30, n).astype(np.uint64)])
            for _ in range(3)]
    return Catalog(rels)


def test_learned_exchange_caps_shrink_buffers(mesh):
    """VERDICT r3 #6: after one execution the engine learns per-join
    exchange caps; the next program's all_to_all buffers are sized at
    the learned cap, not the sender's full local length."""
    cat = _skewed_catalog()
    eng = DistCompiledEngine(cat, EngineConfig(bcast_threshold=0),
                             mesh=mesh)
    q = parse_query("0 1 2|0.0=1.0&1.1=2.1|0.2 1.0 2.2")
    expect = execute_query_numpy(q, cat)
    assert eng.execute(q) == expect          # run 1: full caps, learns
    learned, xcaps = eng._learned_dist(q, 1, 4)
    assert learned is not None
    # Slots that observed sends learn tight caps; a slot that observed
    # ZERO sends keeps the 'full length' sentinel 0 (ADVICE r4 — a tiny
    # learned cap would truncate the exchange if a strategy flip later
    # routes real rows through it).  Here the planner's first join
    # (1.1=2.1, 2^30-domain value columns) is empty, so the final
    # join's build side — the empty intermediate — records 0.
    assert xcaps and sum(1 for c in xcaps if c > 0) >= 3, xcaps
    # every learned cap is far below the full per-chip length (4096/8 =
    # 512 local rows; domain-40 keys over 8 destinations ≈ 64-128/dst)
    L = 4096 // N_DEV
    assert all(c < L for c in xcaps), xcaps
    assert eng.execute(q) == expect          # run 2: capped buffers
    # the capped program's exchange buffers carry the learned shapes:
    # lower the exact program the engine now uses and assert no
    # full-length [ndev, L] all_to_all operand remains
    from sigmod2018_tpu.engine.compiled import _skeletonize

    joins, cols_used, n_classes, class_idx = eng._static_plan(q, True)
    skel, consts = _skeletonize(q)
    cols = tuple(eng.device_column(r, c)[0] for r, c in cols_used)
    ns = tuple(eng.device_column(r, c)[1] for r, c in cols_used)
    classes, xcaps2 = eng._learned_dist(q, n_classes, 2 * len(joins))
    fn = eng._spmd_program(skel, joins, classes, cols_used, ns, xcaps2)
    hlo = fn.lower(jnp.asarray(consts), *cols).compile().as_text()
    import re
    a2a_shapes = [int(m) for line in hlo.splitlines()
                  if "all-to-all" in line
                  for m in re.findall(r"u64\[1,(\d+)\]", line)]
    assert a2a_shapes, "no all-to-all buffers in the capped program"
    assert max(a2a_shapes) <= max(xcaps2), (max(a2a_shapes), xcaps2)


def test_undersized_exchange_cap_retries_exactly(mesh):
    """A learned cap the data outgrew truncates the send buffers; the
    packed per-destination maxima must expose it and the retry must
    return the exact answer (correctness never depends on the cap)."""
    cat = _skewed_catalog()
    eng = DistCompiledEngine(cat, EngineConfig(bcast_threshold=0),
                             mesh=mesh)
    q = parse_query("0 1 2|0.0=1.0&1.1=2.1|0.2 1.0 2.2")
    expect = execute_query_numpy(q, cat)
    assert eng.execute(q) == expect
    learned, xcaps = eng._learned_dist(q, 1, 4)
    # poison the caps far below the real maxima (domain-40 keys send
    # >= 4096/40 rows to some destination; 2 rows cannot hold them)
    eng._learn_dist(q.text, learned, (2,) * len(xcaps))
    assert eng.execute(q) == expect          # truncation caught, retried


def test_comm_model_pins_bytes(mesh):
    """VERDICT r3 #9: the analytic cross-device byte model is recorded per join
    at trace time and matches the hand-computed volume of the chosen
    strategy, so multi-chip communication is checkable without real
    multi-chip hardware."""
    cat = _skewed_catalog()
    eng = DistCompiledEngine(cat, EngineConfig(bcast_threshold=0),
                             mesh=mesh)
    q = parse_query("0 1 2|0.0=1.0&1.1=2.1|0.2 1.0 2.2")
    assert eng.execute(q) == execute_query_numpy(q, cat)
    shuffles = [e for e in eng.comm_model if e["strategy"] == "shuffle"]
    assert shuffles, eng.comm_model
    for e in shuffles:
        per_side = lambda cap, npay: (N_DEV * (N_DEV - 1) * cap
                                      * 8 * (1 + npay))
        assert e["bytes_moved"] == (per_side(e["cap_b"], e["npay_b"])
                                  + per_side(e["cap_p"], e["npay_p"]))
    # learned caps shrink the modeled bytes on the next execution
    before = sum(e["bytes_moved"] for e in shuffles)
    eng.comm_model.clear()
    assert eng.execute(q) == execute_query_numpy(q, cat)
    shuffles2 = [e for e in eng.comm_model if e["strategy"] == "shuffle"]
    if shuffles2:  # capped program may be cached from run 1's retry
        after = sum(e["bytes_moved"] for e in shuffles2)
        assert after <= before
    # broadcast model: small build side all_gathered, probe moves nothing
    eng2 = DistCompiledEngine(cat, EngineConfig(bcast_threshold=1 << 20),
                              mesh=mesh)
    assert eng2.execute(q) == execute_query_numpy(q, cat)
    bcasts = [e for e in eng2.comm_model if e["strategy"] == "broadcast"]
    assert bcasts
    for e in bcasts:
        assert e["bytes_moved"] == (N_DEV * (N_DEV - 1)
                                  * (e["L_b"] * 8 * (1 + e["npay_b"])
                                     + e["L_b"]))


# ---------------------------------------------------------------------------
# Skew-split joins (SURVEY §2.3 north-star row; VERDICT r4 missing #2)
# ---------------------------------------------------------------------------


def _zipf_catalog(n=4096, hot_frac=0.5, hot_key=7):
    """Relations whose key column 0 carries ONE heavy hitter holding
    `hot_frac` of all rows (the Zipf head): a plain hash shuffle would
    route every one of those rows to chip hot_key % ndev.  Column 1 is
    a uniform medium-domain join column (chain queries), column 2 a
    wide-domain value column."""
    rng = np.random.default_rng(99)

    def keycol(n):
        k = rng.integers(100, 5000, n).astype(np.uint64)
        k[rng.choice(n, int(n * hot_frac), replace=False)] = hot_key
        return k

    rels = [Relation(columns=[keycol(n),
                              rng.integers(0, 500, n).astype(np.uint64),
                              rng.integers(0, 1 << 30, n).astype(np.uint64)])
            for _ in range(3)]
    return Catalog(rels)


def test_skew_split_chosen_and_exact_fused(mesh):
    """A Zipf-keyed single-join query picks the skew strategy (hot build
    rows all_gather'ed, hot probe rows local) and matches the oracle."""
    cat = _zipf_catalog()
    eng = DistCompiledEngine(cat, EngineConfig(bcast_threshold=0),
                             mesh=mesh)
    q = parse_query("0 1|0.0=1.0|0.1 1.1")
    assert eng.execute(q) == execute_query_numpy(q, cat)
    assert eng.join_strategies == ["skew"], eng.join_strategies
    # the comm model carries the split's static shapes
    entry = eng.comm_model[0]
    assert entry["strategy"] == "skew" and entry["hot_cap"] > 0


def test_skew_split_intermediate_join_exact(mesh):
    """The split also serves INTERMEDIATE joins: cold rows shuffle, hot
    rows ride the gathered table, and the concatenated local result
    feeds the next join bit-exactly.  (n scaled down: the hot key's
    true intermediate is hot_count^2 rows.)"""
    cat = _zipf_catalog(n=1024, hot_frac=0.25)
    eng = DistCompiledEngine(cat, EngineConfig(bcast_threshold=0),
                             mesh=mesh)
    q = parse_query("0 1 2|0.0=1.0&1.1=2.1|0.2 2.2")
    assert eng.execute(q) == execute_query_numpy(q, cat)
    assert "skew" in eng.join_strategies, eng.join_strategies


def test_skew_split_with_filter_exact(mesh):
    """Filters run before the split; hot classification applies to the
    surviving rows only."""
    cat = _zipf_catalog()
    eng = DistCompiledEngine(cat, EngineConfig(bcast_threshold=0),
                             mesh=mesh)
    q = parse_query("0 1|0.0=1.0&1.1>100000|0.2 1.2")
    assert eng.execute(q) == execute_query_numpy(q, cat)
    assert "skew" in eng.join_strategies


def test_skew_split_hlo_collective_pattern(mesh):
    """HLO assert (VERDICT r4 done-criterion): the skew program carries
    BOTH an all-gather (hot build rows, [hot_cap] operand) and the cold
    all-to-all — and no skew program exists when S18_SKEW=0."""
    import re

    from sigmod2018_tpu.engine.compiled import _skeletonize

    cat = _zipf_catalog()
    eng = DistCompiledEngine(cat, EngineConfig(bcast_threshold=0),
                             mesh=mesh)
    q = parse_query("0 1|0.0=1.0|0.1 1.1")
    assert eng.execute(q) == execute_query_numpy(q, cat)
    joins, cols_used, n_classes, _ = eng._static_plan(q, True)
    skel, consts = _skeletonize(q)
    cols = tuple(eng.device_column(r, c)[0] for r, c in cols_used)
    ns = tuple(eng.device_column(r, c)[1] for r, c in cols_used)
    fn = eng._spmd_program(skel, joins, (), cols_used, ns, ())
    hlo = fn.lower(jnp.asarray(consts), *cols).compile().as_text()
    assert "all-to-all" in hlo  # the cold shuffle
    hot_cap = eng.comm_model[0]["hot_cap"]
    ag = [ln for ln in hlo.splitlines() if "all-gather" in ln]
    assert any(re.search(rf"u64\[{N_DEV},{hot_cap}\]", ln) for ln in ag), (
        hot_cap, ag[:4])
    # disabled -> plain shuffle, no all_gather of hot rows
    eng2 = DistCompiledEngine(cat, EngineConfig(bcast_threshold=0,
                                                skew_factor=0), mesh=mesh)
    assert eng2.execute(q) == execute_query_numpy(q, cat)
    assert eng2.join_strategies == ["shuffle"]


def test_skew_split_uniform_keys_not_chosen(mesh, catalog):
    """Uniform keys must keep the plain shuffle — the MCV sketch shows
    no key past the skew_factor x average-share bar."""
    eng = DistCompiledEngine(catalog, EngineConfig(bcast_threshold=0),
                             mesh=mesh)
    q = parse_query("0 1|0.0=1.0|0.1 1.2")
    assert eng.execute(q) == execute_query_numpy(q, catalog)
    assert "skew" not in eng.join_strategies
