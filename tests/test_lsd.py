"""LSD u64 sort / rank primitives (ops/lsd.py) vs NumPy + lax oracles.

The engine ranks u64 keys through one stable sort of the combined
array instead of searchsorted's method="sort" lowering; these tests
pin bit-identical behavior, including the stability guarantees callers
rely on (pad rows at 2^64-1 staying behind live 2^64-1 keys)."""

import numpy as np
import jax.numpy as jnp
import pytest

from sigmod2018_tpu.ops import lsd


def _rand_u64(rng, n, hi=None):
    hi = (1 << 63) if hi is None else hi
    return rng.integers(0, hi, n, dtype=np.uint64)


@pytest.mark.parametrize("n,dom", [(64, 8), (1000, 1 << 40),
                                   (4096, 1 << 20), (513, 4)])
def test_sort_u64_matches_numpy(n, dom):
    rng = np.random.default_rng(n)
    k = _rand_u64(rng, n, dom)
    v = rng.integers(0, 1 << 50, n, dtype=np.uint64)
    sk, sv = lsd.sort_u64_with(jnp.asarray(k), (jnp.asarray(v),))
    order = np.argsort(k, kind="stable")
    np.testing.assert_array_equal(np.asarray(sk), k[order])
    np.testing.assert_array_equal(np.asarray(sv), v[order])


def test_argsort_u64_stable_matches_jnp():
    rng = np.random.default_rng(7)
    # heavy duplicates across BOTH limbs to stress stability
    k = (_rand_u64(rng, 2048, 4) << np.uint64(32)) | _rand_u64(rng, 2048, 4)
    got = np.asarray(lsd.argsort_u64(jnp.asarray(k)))
    exp = np.asarray(jnp.argsort(jnp.asarray(k)))
    np.testing.assert_array_equal(got, exp)


def test_sort_keeps_live_maxkey_before_pads():
    # The sort_join contract: pads forced to 2^64-1 sit at suffix
    # positions; a LIVE 2^64-1 key must keep preceding them (stability).
    k = np.array([5, 2**64 - 1, 3, 2**64 - 1, 2**64 - 1], dtype=np.uint64)
    # positions 3, 4 are "pads"; position 1 is a live max key
    idx = jnp.arange(5, dtype=jnp.int32)
    _, perm = lsd.sort_u64_with(jnp.asarray(k), (idx,))
    assert list(np.asarray(perm)) == [2, 0, 1, 3, 4]


@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ranks_u64_matches_searchsorted(side, seed):
    rng = np.random.default_rng(seed)
    hay = np.sort(_rand_u64(rng, 777, 64))          # dense duplicates
    q = _rand_u64(rng, 513, 80)
    got = np.asarray(lsd.ranks_u64(jnp.asarray(hay), jnp.asarray(q), side))
    exp = np.searchsorted(hay, q, side=side)
    np.testing.assert_array_equal(got, exp)


def test_ranks_u64_two_limb_keys():
    rng = np.random.default_rng(3)
    hay = np.sort((_rand_u64(rng, 300, 8) << np.uint64(32))
                  | _rand_u64(rng, 300, 8))
    q = (_rand_u64(rng, 200, 10) << np.uint64(32)) | _rand_u64(rng, 200, 10)
    for side in ("left", "right"):
        got = np.asarray(lsd.ranks_u64(jnp.asarray(hay), jnp.asarray(q),
                                       side))
        np.testing.assert_array_equal(got, np.searchsorted(hay, q, side=side))


def test_ranks_u64_extremes():
    hay = np.array([0, 0, 1, 2**64 - 1, 2**64 - 1], dtype=np.uint64)
    q = np.array([0, 2**64 - 1, 2**63, 1], dtype=np.uint64)
    for side in ("left", "right"):
        got = np.asarray(lsd.ranks_u64(jnp.asarray(hay), jnp.asarray(q),
                                       side))
        np.testing.assert_array_equal(got, np.searchsorted(hay, q, side=side))
