"""Test configuration: run JAX on CPU with 8 simulated devices.

Multi-device sharding logic is tested on a virtual CPU mesh
(--xla_force_host_platform_device_count=8) exactly as it would run on a
real mesh (SURVEY §4 implication (c)).  Must run before jax imports.
"""

import os

# Tests run on the CPU even on a machine with a GPU: the suite's
# timings and device counts assume the 8-device virtual CPU mesh.
os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import pathlib

import pytest


@pytest.fixture(scope="session", autouse=True)
def _isolated_prep_cache(tmp_path_factory):
    """Point every prep artifact (learned classes, program vault) at a
    per-run tmp dir: the suite must not read stale serving state from —
    or leak hundreds of per-fixture cache dirs into — ~/.cache.  Tests
    exercising persistence set S18_PREP_CACHE themselves (monkeypatch
    wins over this session default)."""
    os.environ.setdefault(
        "S18_PREP_CACHE", str(tmp_path_factory.mktemp("prep_cache")))
    # The vault doubles compile work for single-use engines (export +
    # wrapper compile per signature) — pure overhead for throwaway test
    # fixtures.  Dedicated tests (test_vault.py) enable it explicitly.
    os.environ.setdefault("S18_VAULT", "0")


REFERENCE = pathlib.Path("/root/reference")
SMALL = REFERENCE / "submission" / "workloads" / "small"


@pytest.fixture(scope="session")
def small_workload():
    if not SMALL.exists():
        pytest.skip("reference small workload not available")
    init = [
        str(SMALL / line.strip().split("/")[-1])
        for line in (SMALL / "small.init").read_text().splitlines()
        if line.strip()
    ]
    work = (SMALL / "small.work").read_text().splitlines()
    result = (SMALL / "small.result").read_text().splitlines()
    return init, work, result


@pytest.fixture(scope="session")
def small_catalog(small_workload):
    from sigmod2018_tpu.storage.catalog import Catalog

    init, _, _ = small_workload
    return Catalog.from_files(init)
