"""Join members vs a brute-force NumPy oracle, over every data shape the
engine must get right: the fused-checksum contract (ops.fused_join over
its sort, presorted, key-table and key-table + prefix-table members)
and the emitting-count contract (ops.join_probe_count and
ops.join_probe_count_table).

Each shape runs with u64 keys, and with the single-limb u32 path where
every key is < 2^32; the key-table members run where the build side's
domain is small enough for a rank table.  Padding rows hold keys that
would match if liveness were ignored."""

import re

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from sigmod2018_tpu import ops

MAX = np.iinfo(np.uint64).max
P = 1024  # padded length of every side


def _shape(name, rng):
    """(build keys, probe keys, value bias) of one data shape, live rows
    only."""
    u = lambda lo, hi, n: rng.integers(lo, hi, n, dtype=np.uint64)  # noqa
    if name == "uniform":
        return u(0, 300, 700), u(0, 300, 900), 0
    if name == "single_key":  # every build row joins every probe row
        return np.full(300, 7, np.uint64), np.full(350, 7, np.uint64), 0
    if name == "keys_0_and_max":
        kb = np.array([0, 5, MAX, MAX, 0, 9, MAX - 1], np.uint64)
        kp = np.array([0, MAX, 5, MAX, 3, MAX - 1, 0], np.uint64)
        return kb, kp, 0
    if name == "empty_build":
        return np.zeros(0, np.uint64), u(0, 50, 100), 0
    if name == "empty_probe":
        return u(0, 50, 100), np.zeros(0, np.uint64), 0
    if name == "disjoint":
        return (np.arange(0, 300, dtype=np.uint64),
                np.arange(5000, 5300, dtype=np.uint64), 0)
    if name == "tiny_build":
        return np.array([3], np.uint64), u(0, 8, 400), 0
    if name == "tiny_probe":
        return u(0, 8, 400), np.array([3], np.uint64), 0
    if name == "domain_2_36":  # 64 distinct keys spread over 2^36
        pool = u(0, 1 << 36, 64)
        return (pool[rng.integers(0, 64, 600)],
                pool[rng.integers(0, 64, 700)], 0)
    if name == "straddling_runs":  # equal-key runs across 2^k boundaries
        return (np.repeat(np.arange(10, dtype=np.uint64), 37),
                np.repeat(np.arange(5, 15, dtype=np.uint64), 29), 0)
    if name == "wraparound_sums":  # values near 2^64: every sum wraps
        return u(0, 40, 500), u(0, 40, 600), 1 << 63
    raise ValueError(name)


SHAPES = ["uniform", "single_key", "keys_0_and_max", "empty_build",
          "empty_probe", "disjoint", "tiny_build", "tiny_probe",
          "domain_2_36", "straddling_runs", "wraparound_sums"]
# Shapes whose build keys fit a rank table (domain bounded by key_table_max)
TABLE_SHAPES = [s for s in SHAPES if s not in ("keys_0_and_max",
                                                "domain_2_36")]
U32_SHAPES = TABLE_SHAPES  # every key < 2^32


def _cases(members, table_members):
    out = []
    for m in members:
        for s in SHAPES:
            if m in table_members:
                if s in TABLE_SHAPES:
                    out.append(pytest.param(m, s, False, id=f"{m}-{s}"))
                continue
            out.append(pytest.param(m, s, False, id=f"{m}-{s}-u64"))
            if s in U32_SHAPES:
                out.append(pytest.param(m, s, True, id=f"{m}-{s}-u32"))
    return out


def _padded(live, rng, fill_from):
    """Live keys then padding rows drawn from the live keys (so a pad
    would join if liveness were ignored)."""
    out = np.empty(P, np.uint64)
    out[:live.size] = live
    pool = fill_from if fill_from.size else np.array([1], np.uint64)
    out[live.size:] = pool[rng.integers(0, pool.size, P - live.size)]
    return out


def _data(shape, seed=0):
    rng = np.random.default_rng(seed)
    kb, kp, bias = _shape(shape, rng)
    both = np.concatenate([kb, kp])
    kbp, kpp = _padded(kb, rng, both), _padded(kp, rng, both)
    vb = rng.integers(0, 1 << 62, (2, P), dtype=np.uint64) + np.uint64(bias)
    vp = rng.integers(0, 1 << 62, (1, P), dtype=np.uint64) + np.uint64(bias)
    return kbp, kb.size, kpp, kp.size, vb, vp


def _oracle(kb, kp, vb, vp):
    eq = kb[:, None] == kp[None, :]
    mb = eq.sum(axis=1).astype(np.uint64)
    mp = eq.sum(axis=0).astype(np.uint64)
    return (int(eq.sum()),
            [int((mb * v).sum(dtype=np.uint64)) for v in vb],
            [int((mp * v).sum(dtype=np.uint64)) for v in vp])


def _key_table(kb_live):
    """The engine's device_key_table: cumcnt[k] = #build rows < k."""
    u = int(kb_live.max()) if kb_live.size else 0
    cum = np.zeros(u + 3, np.int32)
    cum[1:u + 2] = np.cumsum(np.bincount(kb_live.astype(np.int64),
                                         minlength=u + 1))
    cum[u + 2] = cum[u + 1]
    return jnp.asarray(cum)


@pytest.mark.parametrize(
    "member,shape,key32",
    _cases(("sort", "presorted", "table", "table_pref"),
           ("table", "table_pref")))
def test_fused_join_matches_oracle(member, shape, key32):
    kb, nb, kp, npr, vb, vp = _data(shape)
    d_kb, d_vb = jnp.asarray(kb), jnp.asarray(vb)
    n_b = jnp.int32(nb)
    kw = {}
    if member != "sort":
        sk, perm = ops.join_build(d_kb, n_b)
        kw["presorted"] = (sk, perm)
        if member.startswith("table"):
            kw = {"table": (_key_table(kb[:nb]), perm)}
        if member == "table_pref":
            kw["table_prefs"] = jnp.stack(
                [ops.prefix_by_perm(d_vb[v], perm, n_b) for v in range(2)])
            d_vb = None  # probe-only: the build payload is not needed
    count, sums_b, sums_p = ops.fused_join(
        d_kb, d_vb, nb, jnp.asarray(kp), jnp.asarray(vp), npr,
        key32=key32, **kw)
    want = _oracle(kb[:nb], kp[:npr], vb[:, :nb], vp[:, :npr])
    assert int(count) == want[0]
    assert [int(x) for x in np.asarray(sums_b)] == want[1]
    assert [int(x) for x in np.asarray(sums_p)] == want[2]


@pytest.mark.parametrize("member,shape,key32",
                         _cases(("sort", "table"), ("table",)))
def test_emitting_count_matches_oracle(member, shape, key32):
    kb, nb, kp, npr, _, _ = _data(shape, seed=1)
    d_kb, d_kp = jnp.asarray(kb), jnp.asarray(kp)
    sk, perm = ops.join_build(d_kb, jnp.int32(nb), key32=key32)
    if member == "table":
        out = ops.join_probe_count_table(_key_table(kb[:nb]), d_kp,
                                         jnp.int32(npr))
    else:
        out = ops.join_probe_count(sk, jnp.int32(nb), d_kp, jnp.int32(npr))
    lo, cnt, ccum, total = (np.asarray(x) for x in out)
    sb = np.sort(kb[:nb], kind="stable")
    want_lo = np.searchsorted(sb, kp[:npr], "left")
    want_cnt = np.searchsorted(sb, kp[:npr], "right") - want_lo
    np.testing.assert_array_equal(cnt[:npr], want_cnt)
    assert not cnt[npr:].any(), "padding probe rows must not match"
    assert int(total) == int(want_cnt.sum())
    np.testing.assert_array_equal(ccum, np.cumsum(cnt))
    hit = want_cnt > 0
    np.testing.assert_array_equal(lo[:npr][hit], want_lo[hit])
    # lo indexes the build side's sorted order: perm maps it back to
    # build rows that carry the probe row's key.
    rows = np.asarray(perm)[lo[:npr][hit]]
    np.testing.assert_array_equal(kb[rows], kp[:npr][hit])


# ---- compile-time hygiene ----------------------------------------------------

_CONST = re.compile(r"= \w+\[([\d,]*)\]\S* constant\(")


def _largest_constant(fn, *avals):
    """Elements of the largest literal XLA left in the compiled program."""
    text = jax.jit(fn).lower(*avals).compile().as_text()
    sizes = [int(np.prod([int(d) for d in m.group(1).split(",") if d]))
             for m in _CONST.finditer(text)]
    return max(sizes, default=0)


def _program_cases():
    from sigmod2018_tpu.ops import lsd

    n = 1 << 14
    u64 = jax.ShapeDtypeStruct((n,), jnp.uint64)
    u32 = jax.ShapeDtypeStruct((n,), jnp.uint32)
    vals = jax.ShapeDtypeStruct((2, n), jnp.uint64)
    i32 = jax.ShapeDtypeStruct((n,), jnp.int32)
    cnt = jax.ShapeDtypeStruct((), jnp.int32)
    return {
        "fused_sort_u64": (lambda kb, vb, nb, kp, vp, np_:
                           ops.join_checksum_fused(kb, vb, nb, kp, vp, np_),
                           (u64, vals, cnt, u64, vals, cnt)),
        "fused_sort_u32": (lambda kb, vb, nb, kp, vp, np_:
                           ops.join_checksum_fused(kb, vb, nb, kp, vp, np_,
                                                   key32=True),
                           (u64, vals, cnt, u64, vals, cnt)),
        "emit_sort_u64": (ops.join_probe_count, (u64, cnt, u64, cnt)),
        "emit_sort_u32": (ops.join_probe_count, (u32, cnt, u64, cnt)),
        "ranks_u64_left": (lambda s, q: lsd.ranks_u64(s, q, side="left"),
                           (u64, u64)),
        "ranks_u64_right": (lambda s, q: lsd.ranks_u64(s, q, side="right"),
                            (u64, u64)),
        "join_build": (ops.join_build, (u64, cnt)),
        "join_emit": (lambda p, lo, c, t: ops.join_emit(p, lo, c, t,
                                                        out_size=n),
                      (i32, i32, i32, jax.ShapeDtypeStruct((), jnp.int64))),
    }


@pytest.mark.parametrize("name", sorted(_program_cases()))
def test_no_row_sized_literals_in_join_programs(name):
    """XLA must not fold row-sized index arrays into literals: on the GPU
    a folded (N+Q)-element constant costs minutes of compile time per
    program and bloats every executable and cache entry."""
    fn, avals = _program_cases()[name]
    assert _largest_constant(fn, *avals) < 1024
