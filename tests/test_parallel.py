"""Multi-device SPMD tests on the 8-device virtual CPU mesh (conftest.py).

The same programs run on a real multi-GPU mesh; here they validate the shuffle
and the distributed join against a NumPy oracle (SURVEY §4 implication (c)).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sigmod2018_tpu.parallel import (
    make_dist_checksum,
    make_dist_join_checksum,
    make_exchange_counts,
    make_mesh,
    row_sharding,
)

N_DEV = 8
_MASK64 = (1 << 64) - 1


@pytest.fixture(scope="module")
def mesh():
    if len(jax.devices()) < N_DEV:
        pytest.skip(f"need {N_DEV} devices")
    return make_mesh(N_DEV)


def _put(mesh, arr):
    return jax.device_put(jnp.asarray(arr), row_sharding(mesh))


def test_dist_checksum_matches_numpy(mesh):
    rng = np.random.default_rng(0)
    col = rng.integers(0, 1 << 63, size=1024, dtype=np.uint64)
    f = make_dist_checksum(mesh)
    got = int(f(_put(mesh, col)))
    want = int(np.add.reduce(col, dtype=np.uint64)) & _MASK64
    assert got == want


def test_exchange_counts_exact(mesh):
    rng = np.random.default_rng(1)
    keys = rng.integers(0, 1000, size=512, dtype=np.uint64)
    f = make_exchange_counts(mesh)
    got = int(f(_put(mesh, keys)))
    # oracle: per (source shard, destination) histogram
    shards = keys.reshape(N_DEV, -1)
    want = max(
        int(np.sum(shard % N_DEV == d))
        for shard in shards
        for d in range(N_DEV)
    )
    assert got == want


def _oracle_join_checksum(r_key, r_val, s_key, s_val, const):
    live = r_val > const
    rk, rv = r_key[live], r_val[live]
    order = np.argsort(rk, kind="stable")
    srk, srv = rk[order], rv[order]
    lo = np.searchsorted(srk, s_key, side="left")
    hi = np.searchsorted(srk, s_key, side="right")
    cnt = (hi - lo).astype(np.uint64)
    pref = np.concatenate([[np.uint64(0)], np.cumsum(srv, dtype=np.uint64)])
    total = int(cnt.sum(dtype=np.uint64))
    sum_b = int(np.sum(pref[hi] - pref[lo], dtype=np.uint64)) & _MASK64
    sum_p = int(np.sum(cnt * s_val.astype(np.uint64), dtype=np.uint64)) & _MASK64
    return total, sum_b, sum_p


@pytest.mark.parametrize("seed,nr,ns,keyspace", [
    (2, 512, 1024, 64),     # many duplicates
    (3, 1024, 512, 100000), # mostly unique
    (4, 256, 256, 1),       # single hot key (extreme skew)
])
def test_dist_join_checksum_matches_oracle(mesh, seed, nr, ns, keyspace):
    rng = np.random.default_rng(seed)
    r_key = rng.integers(0, keyspace, size=nr, dtype=np.uint64)
    r_val = rng.integers(0, 1 << 40, size=nr, dtype=np.uint64)
    s_key = rng.integers(0, keyspace, size=ns, dtype=np.uint64)
    s_val = rng.integers(0, 1 << 40, size=ns, dtype=np.uint64)
    const = np.uint64(1 << 39)

    cap = max(nr, ns) // N_DEV * 4  # generous for the skewed case
    cap = max(cap, nr, ns) if keyspace == 1 else cap
    f = make_dist_join_checksum(mesh, cap=cap)
    total, sum_b, sum_p, overflow = f(
        _put(mesh, r_key), _put(mesh, r_val),
        _put(mesh, s_key), _put(mesh, s_val),
        jnp.uint64(const),
    )
    assert int(overflow) == 0
    w_total, w_sum_b, w_sum_p = _oracle_join_checksum(r_key, r_val, s_key, s_val, const)
    assert int(total) == w_total
    assert int(sum_b) & _MASK64 == w_sum_b
    assert int(sum_p) & _MASK64 == w_sum_p


def test_pad_key_value_joins_correctly(mesh):
    """2^64-1 is the padding sentinel; a real key with that value must
    still join (the live-prefix clamp keeps exactly the valid copies)."""
    top = np.uint64(_MASK64)
    r_key = np.array([top, 1, 2, top] * 2 * N_DEV, dtype=np.uint64)
    r_val = np.arange(r_key.size, dtype=np.uint64)
    s_key = np.array([top, 3, 1, top] * 2 * N_DEV, dtype=np.uint64)
    s_val = np.arange(s_key.size, dtype=np.uint64)
    const = np.uint64(0)  # keeps all but r_val==0 rows

    f = make_dist_join_checksum(mesh, cap=r_key.size)
    total, sum_b, sum_p, _overflow = f(
        _put(mesh, r_key), _put(mesh, r_val),
        _put(mesh, s_key), _put(mesh, s_val),
        jnp.uint64(const),
    )
    w = _oracle_join_checksum(r_key, r_val, s_key, s_val, const)
    assert (int(total), int(sum_b) & _MASK64, int(sum_p) & _MASK64) == w


@pytest.mark.parametrize("alpha", [1.1, 2.0])
def test_skew_join_matches_oracle(mesh, alpha):
    """Zipf-distributed probe keys: the heavy-hitter split must stay
    bit-exact (BASELINE.json skewed-key stress config)."""
    from sigmod2018_tpu.parallel import make_dist_join_checksum_skew

    rng = np.random.default_rng(11)
    nr, ns = 512, 2048
    r_key = rng.integers(0, 200, size=nr, dtype=np.uint64)
    r_val = rng.integers(0, 1 << 40, size=nr, dtype=np.uint64)
    s_key = np.minimum(rng.zipf(alpha, size=ns), 200).astype(np.uint64)
    s_val = rng.integers(0, 1 << 40, size=ns, dtype=np.uint64)
    const = np.uint64(1 << 38)

    f = make_dist_join_checksum_skew(mesh, cap=nr + ns, hot_k=16,
                                     hot_cap=nr, hot_threshold=4)
    total, sum_b, sum_p, overflow = f(
        _put(mesh, r_key), _put(mesh, r_val),
        _put(mesh, s_key), _put(mesh, s_val),
        jnp.uint64(const),
    )
    assert int(overflow) == 0
    w = _oracle_join_checksum(r_key, r_val, s_key, s_val, const)
    assert (int(total), int(sum_b) & _MASK64, int(sum_p) & _MASK64) == w


@pytest.mark.parametrize("alpha", [1.1, 2.0])
def test_skew_join_build_side_hot_keys(mesh, alpha):
    """Zipf-distributed BUILD keys with uniform probe keys: detection
    must fire on the build side too (VERDICT r1 weak #5 — a hot build
    key with uniform probe keys previously routed all its build rows to
    one chip undetected)."""
    from sigmod2018_tpu.parallel import make_dist_join_checksum_skew

    rng = np.random.default_rng(17)
    nr, ns = 2048, 512
    r_key = np.minimum(rng.zipf(alpha, size=nr), 200).astype(np.uint64)
    r_val = rng.integers(0, 1 << 40, size=nr, dtype=np.uint64)
    s_key = rng.integers(0, 200, size=ns, dtype=np.uint64)
    s_val = rng.integers(0, 1 << 40, size=ns, dtype=np.uint64)
    const = np.uint64(1 << 38)

    f = make_dist_join_checksum_skew(mesh, cap=nr + ns, hot_k=16,
                                     hot_cap=nr, hot_threshold=4)
    total, sum_b, sum_p, overflow = f(
        _put(mesh, r_key), _put(mesh, r_val),
        _put(mesh, s_key), _put(mesh, s_val),
        jnp.uint64(const),
    )
    assert int(overflow) == 0
    w = _oracle_join_checksum(r_key, r_val, s_key, s_val, const)
    assert (int(total), int(sum_b) & _MASK64, int(sum_p) & _MASK64) == w


def test_skew_join_uniform_keys_no_false_positives(mesh):
    """Uniform keys: detector may fire or not, result must be identical."""
    from sigmod2018_tpu.parallel import make_dist_join_checksum_skew

    rng = np.random.default_rng(12)
    nr = ns = 1024
    r_key = rng.integers(0, 100000, size=nr, dtype=np.uint64)
    r_val = rng.integers(0, 1 << 40, size=nr, dtype=np.uint64)
    s_key = rng.integers(0, 100000, size=ns, dtype=np.uint64)
    s_val = rng.integers(0, 1 << 40, size=ns, dtype=np.uint64)
    const = np.uint64(0)

    f = make_dist_join_checksum_skew(mesh, cap=nr + ns, hot_cap=nr)
    total, sum_b, sum_p, overflow = f(
        _put(mesh, r_key), _put(mesh, r_val),
        _put(mesh, s_key), _put(mesh, s_val),
        jnp.uint64(const),
    )
    assert int(overflow) == 0
    w = _oracle_join_checksum(r_key, r_val, s_key, s_val, const)
    assert (int(total), int(sum_b) & _MASK64, int(sum_p) & _MASK64) == w


def test_dist_engine_full_queries(mesh):
    """GSPMD full-query engine on the 8-device mesh == NumPy oracle."""
    from sigmod2018_tpu.config import EngineConfig
    from sigmod2018_tpu.engine.oracle import execute_query_numpy
    from sigmod2018_tpu.frontend.parser import parse_query
    from sigmod2018_tpu.parallel.dist_engine import DistJaxEngine
    from sigmod2018_tpu.storage.catalog import Catalog
    from sigmod2018_tpu.storage.relation import Relation

    rng = np.random.default_rng(21)
    rels = []
    for n in (400, 250, 130):
        cols = [rng.integers(0, 50, size=n).astype(np.uint64) for _ in range(3)]
        rels.append(Relation(columns=cols))
    cat = Catalog(rels)
    eng = DistJaxEngine(cat, EngineConfig(), mesh=mesh)
    for qtext in [
        "0 1|0.0=1.0|0.1 1.2",
        "0 1 2|0.0=1.0&1.1=2.1|0.2 2.0",
        "0 1|0.0=1.0&0.1>25|0.0 1.1",
        "0 1 2|0.0=1.0&1.1=2.1&0.1=2.0|0.0",
        "0|0.0=0.1|0.2",
    ]:
        q = parse_query(qtext)
        assert eng.execute(q) == execute_query_numpy(q, cat), qtext


def test_dist_engine_shuffle_fused_join(mesh):
    """The mesh engine's fused final join routes through the shard_map
    hash shuffle (all_to_all) and stays bit-exact."""
    from sigmod2018_tpu.config import EngineConfig
    from sigmod2018_tpu.engine.oracle import execute_query_numpy
    from sigmod2018_tpu.frontend.parser import parse_query
    from sigmod2018_tpu.parallel.dist_engine import DistJaxEngine
    from sigmod2018_tpu.storage.catalog import Catalog
    from sigmod2018_tpu.storage.relation import Relation

    rng = np.random.default_rng(33)
    rels = []
    for n in (640, 320):
        cols = [rng.integers(0, 60, size=n).astype(np.uint64) for _ in range(3)]
        rels.append(Relation(columns=cols))
    cat = Catalog(rels)
    eng = DistJaxEngine(cat, EngineConfig(), mesh=mesh)
    for qtext in [
        "0 1|0.0=1.0|0.1 1.2",
        "0 1|0.0=1.0&0.1>30|0.1 1.2 0.2",
        "0 1|0.0=1.0&0.0>100|0.0",        # empty -> NULL
    ]:
        q = parse_query(qtext)
        assert eng.execute(q) == execute_query_numpy(q, cat), qtext
    # the override is actually exercised
    assert any(k[0] == "fused" for k in eng._dist_programs)


def test_dist_join_4_device_mesh():
    """Mesh-shape agnosticism: the same programs on a 4-device mesh."""
    if len(jax.devices()) < 4:
        pytest.skip("need 4 devices")
    mesh4 = make_mesh(4)
    rng = np.random.default_rng(44)
    nr = ns = 512
    r_key = rng.integers(0, 100, size=nr, dtype=np.uint64)
    r_val = rng.integers(0, 1 << 40, size=nr, dtype=np.uint64)
    s_key = rng.integers(0, 100, size=ns, dtype=np.uint64)
    s_val = rng.integers(0, 1 << 40, size=ns, dtype=np.uint64)
    const = np.uint64(1 << 39)
    f = make_dist_join_checksum(mesh4, cap=nr)
    total, sum_b, sum_p, _overflow = f(
        _put(mesh4, r_key), _put(mesh4, r_val),
        _put(mesh4, s_key), _put(mesh4, s_val),
        jnp.uint64(const),
    )
    w = _oracle_join_checksum(r_key, r_val, s_key, s_val, const)
    assert (int(total), int(sum_b) & _MASK64, int(sum_p) & _MASK64) == w


def test_dist_join_overflow_reported(mesh):
    """Undersized send caps must set the overflow flag (ADVICE r1: silent
    truncation produced wrong psum'd checksums)."""
    rng = np.random.default_rng(55)
    nr = ns = 64 * N_DEV
    r_key = np.zeros(nr, dtype=np.uint64)  # every row routes to chip 0
    r_val = rng.integers(1, 1 << 40, size=nr, dtype=np.uint64)
    s_key = np.zeros(ns, dtype=np.uint64)
    s_val = rng.integers(1, 1 << 40, size=ns, dtype=np.uint64)
    f = make_dist_join_checksum(mesh, cap=8)  # < 64 rows/chip to chip 0
    *_ , overflow = f(
        _put(mesh, r_key), _put(mesh, r_val),
        _put(mesh, s_key), _put(mesh, s_val),
        jnp.uint64(0),
    )
    assert int(overflow) > 0


def test_skew_join_hot_cap_overflow_reported(mesh):
    """Hot build rows beyond hot_cap must flag, not silently drop."""
    from sigmod2018_tpu.parallel import make_dist_join_checksum_skew

    nr = ns = 64 * N_DEV
    r_key = np.zeros(nr, dtype=np.uint64)   # one key, all build rows hot
    r_val = np.ones(nr, dtype=np.uint64)
    s_key = np.zeros(ns, dtype=np.uint64)
    s_val = np.ones(ns, dtype=np.uint64)
    f = make_dist_join_checksum_skew(mesh, cap=nr, hot_k=16, hot_cap=4,
                                     hot_threshold=4)
    *_, overflow = f(
        _put(mesh, r_key), _put(mesh, r_val),
        _put(mesh, s_key), _put(mesh, s_val),
        jnp.uint64(0),
    )
    assert int(overflow) > 0


def test_scaling_model_parts_pinned(mesh):
    """Scaling-table v2 model (VERDICT r4 #7): the comp-only half of
    make_dist_join_parts runs the SAME per-chip work as the full
    program minus the exchange.  Pinned two ways: (a) at n=1 there is
    nothing to exchange, so comp-only's aggregates equal the full
    program's exactly; (b) at n=8 both halves execute deterministically
    (two runs bit-identical) — the model's timing decomposition rests
    on these programs actually running the claimed work."""
    from sigmod2018_tpu.parallel.dist import make_dist_join_parts

    rng = np.random.default_rng(17)
    rows = 1 << 12
    r_key = rng.integers(0, 1 << 10, rows, dtype=np.uint64)
    r_val = rng.integers(0, 1 << 30, rows, dtype=np.uint64)
    s_key = rng.integers(0, 1 << 10, rows, dtype=np.uint64)
    s_val = rng.integers(0, 1 << 30, rows, dtype=np.uint64)
    const = jnp.uint64(1 << 29)

    m1 = make_mesh(1)
    sh1 = row_sharding(m1)
    args1 = [jax.device_put(jnp.asarray(a), sh1)
             for a in (r_key, r_val, s_key, s_val)]
    full1 = make_dist_join_checksum(m1, cap=rows)
    comp1, _ = make_dist_join_parts(m1, cap=rows)
    want = full1(*args1, const)
    got = comp1(*args1, const)
    assert [int(x) for x in got] == [int(x) for x in want[:3]]

    sh = row_sharding(mesh)
    args = [jax.device_put(jnp.asarray(a), sh)
            for a in (r_key, r_val, s_key, s_val)]
    comp8, comm8 = make_dist_join_parts(mesh, cap=rows // N_DEV)
    a = [int(x) for x in comp8(*args, const)]
    b = [int(x) for x in comp8(*args, const)]
    assert a == b
    c1 = int(comm8(args[0], args[2]))
    c2 = int(comm8(args[0], args[2]))
    assert c1 == c2
