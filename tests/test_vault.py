"""Program vault (engine/vault.py): cross-process program restore.

The suite-wide default is S18_VAULT=0 (conftest) because the vault is
pure overhead for single-use engines; these tests opt in and check the
three contracts that matter:

  1. build-then-serve: a fresh signature is exported, persisted, and
     answers bit-exactly (vs the NumPy oracle);
  2. restore: a second engine over the same data restores the program
     WITHOUT tracing (the exported-wrapper path is taken, asserted via
     the vault's ready table) and answers bit-exactly;
  3. resilience: a corrupt vault file is dropped and the query still
     answers via the jit fallback.
"""

import os

import numpy as np
import pytest

from sigmod2018_tpu.config import EngineConfig
from sigmod2018_tpu.engine.oracle import execute_query_numpy
from sigmod2018_tpu.frontend.parser import parse_query
from sigmod2018_tpu.storage.catalog import Catalog
from sigmod2018_tpu.storage.relation import Relation, store_relation


QUERIES = [
    "0 1|0.0=1.0|0.1 1.2",            # fused single join
    "0 1 2|0.0=1.0&1.1=2.1|0.2 2.2",  # intermediate join -> size class
    "0 1|0.0=1.0&0.1>30|1.1",         # filter + join (consts vector)
]


def _catalog(tmp_path, seed=5):
    rng = np.random.default_rng(seed)
    paths = []
    for i, n in enumerate((600, 500, 400)):
        cols = [rng.integers(0, 64, size=n).astype(np.uint64)
                for _ in range(3)]
        p = tmp_path / f"r{i}"
        store_relation(Relation(columns=cols), str(p))
        paths.append(str(p))
    return Catalog.from_files(paths)


@pytest.fixture()
def vault_env(tmp_path, monkeypatch):
    monkeypatch.setenv("S18_PREP_CACHE", str(tmp_path / "prep"))
    monkeypatch.setenv("S18_VAULT", "1")
    return tmp_path


def _vault_files(tmp_path):
    base = tmp_path / "prep"
    return [p for d in base.glob("vault*") for p in d.glob("*.jexp")]


def test_vault_build_restore_bit_exact(vault_env, tmp_path):
    from sigmod2018_tpu.engine.compiled import CompiledEngine

    cat = _catalog(tmp_path)
    expected = {}
    eng1 = CompiledEngine(cat, EngineConfig.from_env())
    eng1.prefetch()
    for text in QUERIES:
        q = parse_query(text)
        expected[text] = execute_query_numpy(q, cat)
        assert eng1.execute(q) == expected[text]
    files = _vault_files(tmp_path)
    assert files, "first engine must persist exported programs"

    # Fresh engine (new process stand-in): restores, serves from vault.
    eng2 = CompiledEngine(cat, EngineConfig.from_env())
    eng2.prefetch()
    eng2._vault().wait_loaded()
    restored = dict(eng2._vault()._ready)
    assert restored, "prefetch must restore vaulted programs"
    for text in QUERIES:
        assert eng2.execute(parse_query(text)) == expected[text]
    # the signatures it served came from the restore table, not tracing
    assert set(eng2._vault()._ready) >= set(restored)


def test_vault_needs_no_flatbuffers(vault_env, tmp_path, monkeypatch):
    """jax.export's own serializer needs the flatbuffers package, which
    GPU hosts may lack; the vault must build and restore without it."""
    import sys

    from sigmod2018_tpu.engine.compiled import CompiledEngine

    monkeypatch.setitem(sys.modules, "flatbuffers", None)  # import fails
    cat = _catalog(tmp_path)
    q = parse_query(QUERIES[0])
    eng1 = CompiledEngine(cat, EngineConfig.from_env())
    assert eng1.execute(q) == execute_query_numpy(q, cat)
    assert eng1._vault().counters["built"] == 1
    eng2 = CompiledEngine(cat, EngineConfig.from_env())
    eng2.prefetch()
    eng2._vault().wait_loaded()
    assert eng2._vault().counters["restored"] == 1
    assert eng2.execute(q) == execute_query_numpy(q, cat)


def test_vault_corrupt_file_falls_back(vault_env, tmp_path):
    from sigmod2018_tpu.engine.compiled import CompiledEngine

    cat = _catalog(tmp_path)
    eng1 = CompiledEngine(cat, EngineConfig.from_env())
    q = parse_query(QUERIES[0])
    expected = execute_query_numpy(q, cat)
    assert eng1.execute(q) == expected
    files = _vault_files(tmp_path)
    assert files
    for p in files:
        p.write_bytes(b"garbage not a flatbuffer")

    eng2 = CompiledEngine(cat, EngineConfig.from_env())
    eng2.prefetch()
    eng2._vault().wait_loaded()
    assert eng2.execute(q) == expected  # jit fallback
    assert not _vault_files(tmp_path) or all(
        p.read_bytes() != b"garbage not a flatbuffer"
        for p in _vault_files(tmp_path)), "corrupt files must be dropped"


def test_vault_foreign_platform_entries_survive(vault_env, tmp_path,
                                                monkeypatch):
    """The vault dir can be shared between backends (CPU test runs, GPU
    serving runs).  A process on another backend must SKIP foreign
    entries without deleting them — the old behavior ran the zeros-run,
    caught the platform error, and wiped the other platform's warm
    vault on every backend switch."""
    import jax

    from sigmod2018_tpu.engine.compiled import CompiledEngine
    from sigmod2018_tpu.engine.vault import ProgramVault

    cat = _catalog(tmp_path)
    eng1 = CompiledEngine(cat, EngineConfig.from_env())
    q = parse_query(QUERIES[0])
    eng1.execute(q)
    files = _vault_files(tmp_path)
    assert files
    vdir = str(files[0].parent)

    monkeypatch.setattr(jax.export, "default_export_platform",
                        lambda: "cuda")
    v = ProgramVault(vdir)
    v.load_async(workers=2)
    v.wait_loaded()
    assert not v._ready, "foreign-platform entries must not register"
    assert _vault_files(tmp_path) == files, \
        "foreign-platform entries must not be deleted"


def test_vault_disabled_by_flag(tmp_path, monkeypatch):
    from sigmod2018_tpu.engine.compiled import CompiledEngine

    monkeypatch.setenv("S18_PREP_CACHE", str(tmp_path / "prep"))
    monkeypatch.setenv("S18_VAULT", "0")
    cat = _catalog(tmp_path)
    eng = CompiledEngine(cat, EngineConfig.from_env())
    q = parse_query(QUERIES[0])
    assert eng.execute(q) == execute_query_numpy(q, cat)
    assert not _vault_files(tmp_path)


def test_fastpath_invalidation_on_learned_divergence(vault_env, tmp_path):
    """The per-text fast path must drop its cached classes when the
    learned classes diverge (the slow path would pick the new ones) and
    still answer bit-exactly either way."""
    from sigmod2018_tpu.engine.compiled import CompiledEngine

    cat = _catalog(tmp_path)
    eng = CompiledEngine(cat, EngineConfig.from_env())
    q = parse_query(QUERIES[1])  # has one intermediate size class
    expected = execute_query_numpy(q, cat)
    assert eng.execute(q) == expected          # slow path, learns classes
    assert eng.execute(q) == expected          # fast path (cached closure)
    fast = eng.__dict__["_fastpath"]
    assert q.text in fast
    cached_classes = fast[q.text][0]
    assert cached_classes == eng._learned(q)
    # Simulate divergence: a bigger learned class must evict the entry
    # and re-run the slow path with the new class.
    eng._learn(q.text, tuple(c * 2 for c in cached_classes))
    assert eng.execute(q) == expected
    assert fast[q.text][0] == tuple(c * 2 for c in cached_classes)


def test_fastpath_wrong_speculation_still_retries(vault_env, tmp_path):
    """A fast-path execution with too-small classes must self-heal via
    SpecResult validation -> incremental retry, like the slow path."""
    from sigmod2018_tpu.engine.compiled import CompiledEngine

    cat = _catalog(tmp_path)
    eng = CompiledEngine(cat, EngineConfig.from_env())
    q = parse_query(QUERIES[1])
    expected = execute_query_numpy(q, cat)
    assert eng.execute(q) == expected
    assert eng.execute(q) == expected          # populate fast path
    fast = eng.__dict__["_fastpath"]
    classes, n_classes, call, args = fast[q.text]
    # Poison both the learned cache and the fast-path entry with a
    # too-small class: validation sees totals > class and retries.
    too_small = tuple(max(c // 64, 1) for c in classes)
    eng._learn(q.text, too_small)
    small_call = eng._prepare_call(args[0], args[1], args[2], too_small,
                                   *args[3:])
    fast[q.text] = (too_small, n_classes, small_call, args)
    assert eng.execute(q) == expected


def test_big_bypass_texts_recorded_for_prep_replay(vault_env, tmp_path):
    """There is no at-scale vault bypass: every program goes through the
    vault whatever its size, so nothing is left for the prep replay.  A
    second engine restores the program from disk and answers
    bit-exactly."""
    from sigmod2018_tpu.engine.compiled import CompiledEngine

    cat = _catalog(tmp_path)
    eng = CompiledEngine(cat, EngineConfig.from_env())
    for _ in range(2):  # the second pass runs the learned size classes
        for text in QUERIES:
            q = parse_query(text)
            assert eng.execute(q) == execute_query_numpy(q, cat)
    assert eng._vault().counters["built"] >= len(QUERIES)
    assert not eng._vault().bad_texts()
    eng2 = CompiledEngine(cat, EngineConfig.from_env())
    eng2.prefetch()
    eng2.quiesce()
    assert eng2._vault().counters["restored"] >= len(QUERIES)
    for text in QUERIES:
        q = parse_query(text)
        assert eng2.execute(q) == execute_query_numpy(q, cat)
    assert eng2._vault().counters["built"] == 0
