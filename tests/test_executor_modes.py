"""Executor-mode coverage: fused final join on/off, batch threading,
deferred-count NULL semantics, and the protocol driver (reference:
TestOperators.cpp:197-285 e2e cases + harness.cpp behavior)."""

import io

import numpy as np
import pytest

from sigmod2018_tpu.config import EngineConfig
from sigmod2018_tpu.engine.executor import JaxEngine, NullResult, PendingResult
from sigmod2018_tpu.engine.oracle import execute_query_numpy
from sigmod2018_tpu.frontend.parser import parse_query
from sigmod2018_tpu.io.repl import run_protocol
from sigmod2018_tpu.storage.catalog import Catalog
from sigmod2018_tpu.storage.relation import (
    Relation,
    make_identity_relation,
    store_relation,
)


@pytest.fixture(scope="module")
def rand_catalog():
    rng = np.random.default_rng(7)
    rels = []
    for n in (300, 200, 150, 80):
        cols = [rng.integers(0, 40, size=n).astype(np.uint64) for _ in range(3)]
        rels.append(Relation(columns=cols))
    return Catalog(rels)


QUERIES = [
    "0 1|0.0=1.0|0.1 1.2",                            # single join -> fused
    "0 1|0.0=1.0&0.1>20|0.1 1.2",                     # filter + fused join
    "0 1 2|0.0=1.0&1.1=2.1|0.2 1.0 2.2",              # chain, last join fused
    "0 1 2|0.0=1.0&1.1=2.1&0.1=1.2|0.2 2.2",          # cycle edge
    "0 1|0.0=1.0&0.0>100|0.0 1.1",                    # empty via filter
    "0 0|0.0=1.1|0.2 1.0",                            # same relation twice
    "3 3|0.0=1.0&0.1=15|0.1 1.2",                     # dup relation + filter
    "0 1 2 3|0.0=1.0&1.1=2.1&2.2=3.0|3.1 0.1",        # 4-relation chain
]


@pytest.mark.parametrize("fuse", [True, False])
def test_fused_matches_oracle(rand_catalog, fuse):
    eng = JaxEngine(rand_catalog, EngineConfig(fuse_final_join=fuse))
    for qtext in QUERIES:
        q = parse_query(qtext)
        assert eng.execute(q) == execute_query_numpy(q, rand_catalog), (qtext, fuse)


@pytest.mark.parametrize("fuse", [True, False])
def test_compiled_engine_fuse_modes(rand_catalog, fuse):
    """S18_FUSE=0 with the compiled engine must produce real answers, not
    silent NULLs (ADVICE r1: the fused branch ran unconditionally and the
    host's int() on the packed vector raised, caught as a NULL line)."""
    from sigmod2018_tpu.engine.compiled import CompiledEngine

    eng = CompiledEngine(rand_catalog, EngineConfig(fuse_final_join=fuse))
    for qtext in QUERIES:
        q = parse_query(qtext)
        assert eng.execute(q) == execute_query_numpy(q, rand_catalog), (qtext, fuse)


def test_fused_path_taken(rand_catalog):
    eng = JaxEngine(rand_catalog, EngineConfig(fuse_final_join=True))
    res = eng.execute_async(parse_query("0 1|0.0=1.0|0.1 1.2"))
    assert isinstance(res, PendingResult)


def test_deferred_null_final_count_zero(rand_catalog):
    # Filter kills everything; the count stays on device until line().
    eng = JaxEngine(rand_catalog, EngineConfig())
    res = eng.execute_async(parse_query("0|0.0>9999|0.0 0.1"))
    assert res.line() == "NULL NULL"


def test_views_only_cartesian(rand_catalog):
    q = parse_query("0 1 2|0.0=1.0|2.0")  # view on a binding with no predicate
    eng = JaxEngine(rand_catalog, EngineConfig())
    assert eng.execute(q) == execute_query_numpy(q, rand_catalog)


def test_protocol_driver_end_to_end(tmp_path):
    paths = []
    for i, n in enumerate((20, 10)):
        rel = make_identity_relation(n, 3)
        p = tmp_path / f"r{i}"
        store_relation(rel, p)
        paths.append(str(p))
    stdin = io.StringIO(
        "\n".join(paths) + "\nDone\n"
        "0 1|0.0=1.0|0.0 1.1\n"
        "garbage query line\n"            # must yield NULL, not kill batch
        "F\n"
        "0|0.1>4|0.2\n"
        "F\n"
        "Exit\n"
    )
    stdout = io.StringIO()
    run_protocol(stdin, stdout, EngineConfig(batch_workers=4))
    lines = stdout.getvalue().splitlines()
    assert lines[0] == "45 45"          # identity join: sum 0..9 twice
    assert lines[1] == "NULL"
    assert lines[2] == str(sum(range(5, 20)))


def test_batch_threading_order_stable(rand_catalog):
    from concurrent.futures import ThreadPoolExecutor

    eng = JaxEngine(rand_catalog, EngineConfig())
    queries = [parse_query(t) for t in QUERIES * 3]
    with ThreadPoolExecutor(8) as pool:
        results = list(pool.map(eng.execute_async, queries))
    got = [r.line() for r in results]
    want = [execute_query_numpy(q, rand_catalog) for q in queries]
    assert got == want


def test_compiled_engine_matches_oracle(rand_catalog):
    from sigmod2018_tpu.engine.compiled import CompiledEngine

    eng = CompiledEngine(rand_catalog, EngineConfig())
    for qtext in QUERIES + [
        "0|0.0>20|0.0 0.1",                    # filters only
        "0|0.0=0.1|0.2",                       # self-join only
        "0 1 2|0.0=1.0|2.0",                   # cartesian -> fallback
        "0 1 2 3|0.0=1.0&1.1=2.1&2.2=3.0&0.1>10|3.1 0.1 1.0 2.2",
    ]:
        q = parse_query(qtext)
        assert eng.execute(q) == execute_query_numpy(q, rand_catalog), qtext


def test_compiled_engine_small_workload(small_workload, small_catalog):
    from sigmod2018_tpu.engine.compiled import CompiledEngine
    from sigmod2018_tpu.frontend.parser import parse_work_file

    _, work, expected = small_workload
    eng = CompiledEngine(small_catalog, EngineConfig())
    got = [eng.execute(q) for b in parse_work_file(work) for q in b]
    bad = [(g, e) for g, e in zip(got, expected) if g != e.strip()]
    assert not bad, bad[:3]


def test_protocol_numpy_backend(tmp_path):
    paths = []
    for i, n in enumerate((20, 10)):
        p = tmp_path / f"r{i}"
        store_relation(make_identity_relation(n, 3), p)
        paths.append(str(p))
    stdin = io.StringIO(
        "\n".join(paths) + "\nDone\n0 1|0.0=1.0|0.0 1.1\nF\nExit\n"
    )
    stdout = io.StringIO()
    run_protocol(stdin, stdout, EngineConfig(backend="numpy"))
    assert stdout.getvalue().splitlines() == ["45 45"]


def test_protocol_serial_workers(tmp_path):
    paths = []
    for i, n in enumerate((20, 10)):
        p = tmp_path / f"r{i}"
        store_relation(make_identity_relation(n, 3), p)
        paths.append(str(p))
    stdin = io.StringIO(
        "\n".join(paths) + "\nDone\n0 1|0.0=1.0|0.0 1.1\nF\nExit\n"
    )
    stdout = io.StringIO()
    run_protocol(stdin, stdout, EngineConfig(batch_workers=1))
    assert stdout.getvalue().splitlines() == ["45 45"]


def test_learned_classes_persist_across_processes(tmp_path, monkeypatch):
    """Learned intermediate size classes survive a process restart via the
    prep-cache dir (SURVEY §5 checkpoint row): a cold engine serving the
    same relation set speculates with the previous run's EXACT classes —
    no learning sync — and still answers bit-exactly."""
    from sigmod2018_tpu.engine.compiled import CompiledEngine

    monkeypatch.setenv("S18_PREP_CACHE", str(tmp_path / "prep"))
    rng = np.random.default_rng(11)
    paths = []
    for i, n in enumerate((300, 200, 150)):
        p = tmp_path / f"r{i}"
        cols = [rng.integers(0, 40, size=n).astype(np.uint64)
                for _ in range(3)]
        store_relation(Relation(columns=cols), p)
        paths.append(str(p))

    qtext = "0 1 2|0.0=1.0&1.1=2.1|0.2 1.0 2.2"  # 1 intermediate join
    q = parse_query(qtext)

    cat1 = Catalog.from_files(paths)
    eng1 = CompiledEngine(cat1, EngineConfig())
    expected = execute_query_numpy(q, cat1)
    assert eng1.execute(q) == expected
    learned = eng1._learned(q)
    assert learned is not None and len(learned) == 1

    # "new process": fresh catalog + engine, same files
    cat2 = Catalog.from_files(paths)
    eng2 = CompiledEngine(cat2, EngineConfig())
    assert eng2._learned(q) == learned  # loaded from disk, pre-execution
    assert eng2.execute(q) == expected

    # a different relation set must NOT see these classes
    p3 = tmp_path / "r3"
    store_relation(make_identity_relation(50, 3), p3)
    cat3 = Catalog.from_files(paths[:2] + [str(p3)])
    eng3 = CompiledEngine(cat3, EngineConfig())
    assert eng3._learned(q) is None


def test_warm_replay_prefetch(tmp_path, monkeypatch):
    """S18_WARM_REPLAY: prefetch replays the persisted serving history
    (all programs warmed before the timed phase) without changing
    results."""
    from sigmod2018_tpu.engine.compiled import CompiledEngine

    monkeypatch.setenv("S18_PREP_CACHE", str(tmp_path / "prep"))
    rng = np.random.default_rng(12)
    paths = []
    for i, n in enumerate((200, 150, 100)):
        p = tmp_path / f"r{i}"
        cols = [rng.integers(0, 30, size=n).astype(np.uint64)
                for _ in range(3)]
        store_relation(Relation(columns=cols), p)
        paths.append(str(p))
    qtext = "0 1 2|0.0=1.0&1.1=2.1|0.2 2.2"
    q = parse_query(qtext)

    cat1 = Catalog.from_files(paths)
    eng1 = CompiledEngine(cat1, EngineConfig())
    expected = execute_query_numpy(q, cat1)
    assert eng1.execute(q) == expected  # learns + persists

    cat2 = Catalog.from_files(paths)
    eng2 = CompiledEngine(cat2, EngineConfig(warm_replay=True))
    eng2.prefetch()  # must replay the persisted text without error
    assert eng2.execute(q) == expected


def test_compiled_fused_table_program_is_sort_free():
    """With a key table + prefix tables on the build side, the compiled
    single-join program must contain NO sort at all — the fused join is
    probe-only gathers (ops.join_checksum_fused_table_pref).  Asserted
    on the lowered HLO, like the dist engine's no-gather contract."""
    import sigmod2018_tpu.engine.compiled as C

    rng = np.random.default_rng(13)
    rels = []
    for n in (500, 400):
        cols = [rng.integers(0, 64, size=n).astype(np.uint64)
                for _ in range(3)]
        rels.append(Relation(columns=cols))
    cat = Catalog(rels)
    eng = C.CompiledEngine(cat, EngineConfig())
    q = parse_query("0 1|0.0=1.0|0.1 1.2")

    joins, cols_used, n_classes, class_idx = eng._static_plan(q, True)
    assert n_classes == 0  # fused single join
    skel, consts = C._skeletonize(q)
    cols = tuple(eng.device_column(r, c)[0] for r, c in cols_used)
    ns = tuple(eng.device_column(r, c)[1] for r, c in cols_used)
    key32 = tuple(eng._key32(q, jp) for jp in joins)
    jkeys = tuple(sorted(
        {(q.relations[jp.binding1], jp.column1) for jp in joins}
        | {(q.relations[jp.binding2], jp.column2) for jp in joins}))
    spairs = tuple(eng.device_sorted_column(r, c) for r, c in jkeys)
    tkeys = tuple(rc for rc in jkeys
                  if eng.device_key_table(*rc) is not None)
    assert tkeys, "fixture must be under the key-table gate"
    tcols = tuple(eng.device_key_table(*rc) for rc in tkeys)
    jp = joins[-1]
    fset = set()
    for b, cjoin in ((jp.binding1, jp.column1), (jp.binding2, jp.column2)):
        rel = q.relations[b]
        if eng.device_key_table(rel, cjoin) is not None:
            for vb, vc in q.views:
                if vb == b:
                    fset.add((rel, cjoin, vc))
    fkeys = tuple(sorted(fset))
    fprefs = tuple(eng.device_prefix_table(*t) for t in fkeys)
    scols = tuple(p[0] for p in spairs)
    sperms = tuple(p[1] for p in spairs)
    hlo = C._run_segments.lower(
        skel, joins, key32, (), cols_used, ns, eng.config.min_pad,
        True, consts, cols,
        jkeys, scols, sperms, tkeys, tcols, fkeys, fprefs,
    ).as_text()
    assert "sort(" not in hlo and " sort" not in hlo.lower(), \
        "fused table+prefs program must not sort"
    # and it must still answer correctly
    assert eng.execute(q) == execute_query_numpy(q, cat)


def test_warmup_oracle_tier_exact(tmp_path, monkeypatch):
    """Tiered warm-up serving (round 5): while the device engine warms
    up, small-input queries answer from the exact host oracle.  Force
    the window to stay open for the whole run (slow prefetch) and
    assert outputs stay bit-exact, including fault isolation."""
    import time as _time

    from sigmod2018_tpu.engine.executor import JaxEngine

    monkeypatch.setenv("S18_ASYNC_PREP", "1")
    monkeypatch.setenv("S18_WARMUP_ORACLE", str(1 << 30))
    orig = JaxEngine.prefetch

    def slow_prefetch(self):
        _time.sleep(3.0)  # keep the warm-up window open
        orig(self)

    monkeypatch.setattr(JaxEngine, "prefetch", slow_prefetch)
    paths = []
    for i, n in enumerate((20, 10)):
        rel = make_identity_relation(n, 3)
        p = tmp_path / f"r{i}"
        store_relation(rel, p)
        paths.append(str(p))
    stdin = io.StringIO(
        "\n".join(paths) + "\nDone\n"
        "0 1|0.0=1.0|0.0 1.1\n"
        "garbage query line\n"
        "F\n"
        "0|0.1>4|0.2\n"
        "F\n"
        "Exit\n"
    )
    stdout = io.StringIO()
    run_protocol(stdin, stdout, EngineConfig(batch_workers=4))
    lines = stdout.getvalue().splitlines()
    assert lines[0] == "45 45"
    assert lines[1] == "NULL"
    assert lines[2] == str(sum(range(5, 20)))


def test_warmup_oracle_disabled(tmp_path, monkeypatch):
    """S18_WARMUP_ORACLE=0 keeps every query on the device path."""
    monkeypatch.setenv("S18_WARMUP_ORACLE", "0")
    paths = []
    for i, n in enumerate((20, 10)):
        rel = make_identity_relation(n, 3)
        p = tmp_path / f"r{i}"
        store_relation(rel, p)
        paths.append(str(p))
    stdin = io.StringIO("\n".join(paths) + "\nDone\n"
                        "0 1|0.0=1.0|0.0 1.1\nF\nExit\n")
    stdout = io.StringIO()
    run_protocol(stdin, stdout, EngineConfig(batch_workers=4))
    assert stdout.getvalue().splitlines()[0] == "45 45"
