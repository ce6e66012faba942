"""What the engine says about where it ran and who answered: the chip
smoke test's refusal without a GPU, the compile-cache location, the
REPL's per-tier query counts, the tracer's bandwidth share, and the
workload generator's relations-only mode and committed digests."""

import io
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from sigmod2018_tpu.config import EngineConfig
from sigmod2018_tpu.io.repl import SERVE_SUMMARY_TAG, run_protocol
from sigmod2018_tpu.storage.relation import (make_identity_relation,
                                             store_relation)

REPO = Path(__file__).resolve().parents[1]


def _env(**extra):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO), **extra)
    return env


# ---- chip_smoke.py ---------------------------------------------------------

def test_chip_smoke_refuses_cpu(tmp_path):
    out = subprocess.run([sys.executable, str(REPO / "chip_smoke.py"),
                          "--out", str(tmp_path)],
                         capture_output=True, text=True, timeout=300,
                         cwd=REPO, env=_env())
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    assert "no GPU" in out.stdout


def test_chip_smoke_fails_outside_the_repo(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = _env()
    env.pop("PYTHONPATH")
    out = subprocess.run([sys.executable, "chip_smoke.py"],
                         capture_output=True, text=True, timeout=300,
                         cwd=tmp_path, env=env)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


# ---- compile cache ------------------------------------------------------------

_CACHE_PROBE = ("import sigmod2018_tpu, jax; "
                "print(jax.config.jax_compilation_cache_dir)")


@pytest.mark.parametrize("from_env", [True, False],
                         ids=["env-dir", "repo-default"])
def test_compile_cache_location(tmp_path, from_env):
    """JAX_COMPILATION_CACHE_DIR, when set, is the only cache directory;
    without it the cache is <repo>/.jax_cache (a fixed path, so cache
    keys stay stable between runs)."""
    extra = ({"JAX_COMPILATION_CACHE_DIR": str(tmp_path / "cc")}
             if from_env else {})
    out = subprocess.run([sys.executable, "-c", _CACHE_PROBE],
                         capture_output=True, text=True, timeout=120,
                         cwd=tmp_path, env=_env(**extra))
    assert out.returncode == 0, out.stderr
    want = tmp_path / "cc" if from_env else REPO / ".jax_cache"
    assert out.stdout.strip() == str(want)


# ---- serving tiers -------------------------------------------------------------

def _serve(tmp_path, capsys, queries, config=None):
    paths = []
    for i, n in enumerate((20, 10)):
        p = tmp_path / f"r{i}"
        store_relation(make_identity_relation(n, 3), p)
        paths.append(str(p))
    stdin = io.StringIO("\n".join(paths) + "\nDone\n"
                        + "\n".join(queries) + "\nF\n")
    stdout = io.StringIO()
    capsys.readouterr()
    run_protocol(stdin, stdout, config or EngineConfig(batch_workers=2))
    err = capsys.readouterr().err
    lines = [l for l in err.splitlines()
             if l.startswith(SERVE_SUMMARY_TAG + " ")]
    assert len(lines) == 1, err
    return (stdout.getvalue().splitlines(),
            json.loads(lines[0][len(SERVE_SUMMARY_TAG) + 1:]), err)


QUERIES = ["0 1|0.0=1.0|0.0 1.1", "0|0.1>4|0.2"]
ANSWERS = ["45 45", str(sum(range(5, 20)))]


def test_tier_summary_all_device(tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("S18_WARMUP_ORACLE", "0")
    lines, s, _ = _serve(tmp_path, capsys, QUERIES + ["garbage line"])
    assert lines == ANSWERS + ["NULL"]
    assert (s["queries"], s["device"], s["errors"]) == (3, 2, 1)
    assert (s["warmup_host"], s["failure_host"], s["fetch_failed"]) \
        == (0, 0, 0)
    assert s["compile_s"] > 0
    assert len(s["peak_bytes"]) == len(s["bytes_limit"]) >= 1


def test_tier_summary_counts_warmup_host(tmp_path, capsys, monkeypatch):
    import time

    from sigmod2018_tpu.engine.executor import JaxEngine

    monkeypatch.setenv("S18_ASYNC_PREP", "1")
    monkeypatch.setenv("S18_WARMUP_ORACLE", str(1 << 30))
    orig = JaxEngine.prefetch

    def slow_prefetch(self):
        time.sleep(3.0)  # keep the warm-up window open
        orig(self)

    monkeypatch.setattr(JaxEngine, "prefetch", slow_prefetch)
    lines, s, _ = _serve(tmp_path, capsys, QUERIES)
    assert lines == ANSWERS
    assert (s["warmup_host"], s["device"]) == (2, 0)


def test_tier_summary_counts_failure_host(tmp_path, capsys, monkeypatch):
    from sigmod2018_tpu.engine.compiled import CompiledEngine

    monkeypatch.setenv("S18_WARMUP_ORACLE", "0")

    def broken(self, query):
        raise RuntimeError("simulated device failure")

    monkeypatch.setattr(CompiledEngine, "_execute_async_device", broken)
    lines, s, err = _serve(tmp_path, capsys, QUERIES)
    assert lines == ANSWERS  # exact answers from the host oracle
    assert (s["failure_host"], s["device"]) == (2, 0)
    assert "device dispatch failed" in err


def test_fetch_failure_counted_and_logged(capsys):
    from sigmod2018_tpu.engine.executor import JaxEngine, PendingResult
    from sigmod2018_tpu.storage.catalog import Catalog

    class Poisoned:
        def __array__(self, *a, **k):
            raise RuntimeError("deferred device failure")

    eng = JaxEngine(Catalog([make_identity_relation(4, 1)]))
    res = PendingResult(Poisoned(), 1)
    res.fetch_retry = eng._counted(lambda: "7")
    assert res.line() == "7"
    assert eng.counters.snapshot()["fetch_failed"] == 1
    assert "result fetch failed" in capsys.readouterr().err


def test_tier_summary_numpy_backend(tmp_path, capsys):
    lines, s, _ = _serve(tmp_path, capsys, QUERIES,
                         EngineConfig(backend="numpy"))
    assert lines == ANSWERS
    assert s["numpy_backend"] == 2 and "device" not in s


# ---- tracer ------------------------------------------------------------------

def test_trace_peak_table_knows_h100_only():
    from sigmod2018_tpu.engine.trace import peak_bytes_per_sec

    assert peak_bytes_per_sec("NVIDIA H100 80GB HBM3") == 3.35e12
    assert peak_bytes_per_sec("cpu") is None
    assert peak_bytes_per_sec("Some Future GPU") is None


@pytest.mark.parametrize("mode", ["table", "json"])
def test_trace_prints_no_share_for_unknown_device(mode):
    from sigmod2018_tpu.engine.trace import Tracer

    for kind, has_share in (("Some Future GPU", False),
                            ("NVIDIA H100 80GB HBM3", True)):
        out = io.StringIO()
        tr = Tracer(out=out, mode=mode, device_kind=kind)
        tr.records = [("join_build", "(1024,)", 2.0, 1 << 20)]
        tr.report("q")
        text = out.getvalue()
        if mode == "json":
            share = json.loads(text)["ops"][0]["bw_share"]
            assert (share is not None) == has_share
        else:
            assert ("bw=" in text) == has_share


# ---- workload generator ---------------------------------------------------------

def test_gen_workload_relations_only_is_byte_identical(tmp_path):
    args = ["--profile", "zipfbig", "--rows", "3000", "--relations", "3",
            "--queries", "2", "--keyspace", "500", "--seed", "13"]
    for name, extra in (("full", []), ("rel", ["--relations-only"])):
        out = subprocess.run(
            [sys.executable, str(REPO / "tools" / "gen_workload.py"),
             str(tmp_path / name / "w"), *args, *extra],
            capture_output=True, text=True, timeout=300, env=_env())
        assert out.returncode == 0, out.stderr
    full, rel = tmp_path / "full" / "w", tmp_path / "rel" / "w"
    assert sorted(p.name for p in rel.iterdir()) == ["r0", "r1", "r2",
                                                     "w.init"]
    for p in rel.iterdir():
        assert p.read_bytes() == (full / p.name).read_bytes(), p.name
    assert (full / "w.result").exists()


@pytest.mark.parametrize("name", ["scaled", "zipf"])
def test_committed_fixture_digests_regenerate(tmp_path, name):
    """The committed .result files answer the committed binaries: a
    relations-only regeneration must reproduce their digests on this
    NumPy (the generator avoids samplers whose stream differs between
    NumPy versions)."""
    import hashlib
    import shlex

    script = (REPO / "tools" / "regen_workloads.sh").read_text()
    line = next(l for l in script.splitlines()
                if f"workloads/{name} " in l)
    args = shlex.split(line)[3:]
    out = subprocess.run(
        [sys.executable, str(REPO / "tools" / "gen_workload.py"),
         str(tmp_path / name), *args, "--relations-only"],
        capture_output=True, text=True, timeout=300, env=_env())
    assert out.returncode == 0, out.stderr
    for entry in (REPO / "workloads" / name / f"{name}.sha1").read_text() \
            .splitlines():
        digest, rel = entry.split()
        got = hashlib.sha1((tmp_path / name / rel).read_bytes()).hexdigest()
        assert got == digest, rel
