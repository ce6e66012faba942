"""Multi-device SPMD join: hash-shuffle over a device mesh + local sort-join.

The reference engine's only parallelism is a 4-thread pthread pool with
fork/join barriers on one shared-memory node (scheduler.c, preprocess.c).
This restatement scales across devices instead (SURVEY §2.3):

- every relation column is row-sharded over a 1-D `jax.sharding.Mesh`
  (each chip owns a contiguous ~T/n slice),
- the radix partition's first level becomes a cross-chip hash shuffle:
  each chip buckets its local rows by `key mod n_devices` and exchanges
  the buckets with `jax.lax.all_to_all` (within a node, and across
  nodes on a multi-host mesh),
- after the shuffle every chip owns *all* rows of its key range, so the
  join is chip-local: XLA sort + searchsorted, identical to the
  single-chip path in ops/sort_join.py,
- global scalars (cardinalities, checksums) leave the chips via `psum`
  — the reference's condvar barrier (scheduler.c:76-86) has no analog
  because SPMD programs synchronize at collective boundaries.

Static-shape discipline: the per-destination send capacity `cap` must be
a compile-time constant.  `exchange_counts` is the cheap first pass that
returns the exact per-destination histogram (psum-reduced) so the host
can pick the smallest adequate power-of-two `cap`; `cap = local_len` is
always sufficient (a chip cannot send more rows than it owns).

Everything here is shard_map-first: functions take *local* shard views
and are meant to be wrapped by `shard_map(..., mesh, P(AXIS), ...)` —
see `make_dist_join_checksum` for the fused end-to-end program.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

try:  # jax>=0.4.35 exposes shard_map at the top level
    from jax import shard_map  # type: ignore[attr-defined]
except ImportError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map  # type: ignore

AXIS = "shards"
_PAD_KEY = np.uint64(0xFFFFFFFFFFFFFFFF)


def make_mesh(n_devices: Optional[int] = None) -> Mesh:
    """A 1-D mesh over the first n available devices (default: all)."""
    devs = jax.devices()
    if n_devices is not None:
        if len(devs) < n_devices:
            raise ValueError(f"need {n_devices} devices, have {len(devs)}")
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (AXIS,))


def row_sharding(mesh: Mesh) -> NamedSharding:
    """Row-sharded layout for a 1-D column array."""
    return NamedSharding(mesh, P(AXIS))


# ---------------------------------------------------------------------------
# Local-shard building blocks (call inside shard_map)
# ---------------------------------------------------------------------------


def _exclusive_cumsum(x: jax.Array) -> jax.Array:
    c = jnp.cumsum(x)
    return jnp.concatenate([jnp.zeros((1,), c.dtype), c[:-1]])


def _dest_of(keys: jax.Array, live: jax.Array, ndev: int) -> jax.Array:
    """Destination chip per row: low-bits hash of the join key
    (reference H1 = value & (2^N_LSB - 1), rhjoin.c:311-325); dead rows
    route to the out-of-range bucket `ndev` and are dropped."""
    d = (keys % jnp.uint64(ndev)).astype(jnp.int32)
    return jnp.where(live, d, jnp.int32(ndev))


def send_hist_max(keys: jax.Array, live: jax.Array, ndev: int) -> jax.Array:
    """Max per-destination send count on this chip, UNTRUNCATED (i32
    scalar).  The validation value for learned exchange caps
    (dist_compiled.py): a send buffer sized below this value dropped
    rows, so the host must retry with full caps.  Shares its
    destination/histogram subexpressions with partition_multi — XLA
    CSEs them inside one program."""
    dest = _dest_of(keys, live, ndev)
    hist = jnp.bincount(dest, length=ndev + 1).astype(jnp.int32)
    return jnp.max(hist[:ndev])


def partition_for_exchange(keys: jax.Array, payload: jax.Array,
                           live: jax.Array, ndev: int, cap: int):
    """Group local rows into [ndev, cap] per-destination send buffers.

    One stable counting-sort pass (argsort on the destination id), then a
    scatter into (dest, rank-within-dest) slots — the data-parallel restatement of
    the reference's rescanning PartitionJob (preprocess.c:222-299).

    Returns (send_keys [ndev,cap] u64 PAD-filled, send_payload [ndev,cap],
    counts [ndev] i32, overflow scalar bool).
    """
    L = keys.shape[0]
    dest = _dest_of(keys, live, ndev)
    order = jnp.argsort(dest, stable=True).astype(jnp.int32)
    sdest = dest[order]
    hist = jnp.bincount(dest, length=ndev + 1).astype(jnp.int32)
    starts = _exclusive_cumsum(hist)
    rank = jnp.arange(L, dtype=jnp.int32) - starts[sdest]
    # Out-of-bounds first-axis index (sdest == ndev) and rank >= cap are
    # dropped by the scatter; `overflow` reports the latter.
    send_keys = jnp.full((ndev, cap), _PAD_KEY, dtype=jnp.uint64)
    send_keys = send_keys.at[sdest, rank].set(keys[order], mode="drop")
    send_pay = jnp.zeros((ndev, cap), dtype=payload.dtype)
    send_pay = send_pay.at[sdest, rank].set(payload[order], mode="drop")
    counts = jnp.minimum(hist[:ndev], cap)
    overflow = jnp.any(hist[:ndev] > cap)
    return send_keys, send_pay, counts, overflow


def exchange(send_keys: jax.Array, send_pay: jax.Array, counts: jax.Array):
    """all_to_all the per-destination buffers; compact received rows into a
    PAD-suffixed prefix.  Returns (keys [ndev*cap], payload, n_local)."""
    ndev, cap = send_keys.shape
    recv_keys = jax.lax.all_to_all(send_keys, AXIS, split_axis=0, concat_axis=0)
    recv_pay = jax.lax.all_to_all(send_pay, AXIS, split_axis=0, concat_axis=0)
    recv_cnt = jax.lax.all_to_all(counts[:, None], AXIS, split_axis=0,
                                  concat_axis=0)[:, 0]
    total = ndev * cap
    starts = _exclusive_cumsum(recv_cnt)
    slot = jnp.arange(cap, dtype=jnp.int32)[None, :]
    valid = slot < recv_cnt[:, None]
    idx = jnp.where(valid, starts[:, None] + slot, total)  # total = dropped
    keys = jnp.full((total,), _PAD_KEY, dtype=jnp.uint64)
    keys = keys.at[idx.reshape(-1)].set(recv_keys.reshape(-1), mode="drop")
    pay = jnp.zeros((total,), dtype=send_pay.dtype)
    pay = pay.at[idx.reshape(-1)].set(recv_pay.reshape(-1), mode="drop")
    return keys, pay, jnp.sum(recv_cnt)


def local_join_checksum(bkeys: jax.Array, bvals: jax.Array, n_build: jax.Array,
                        pkeys: jax.Array, pvals: jax.Array, n_probe: jax.Array):
    """Chip-local join with the checksum fused into the probe.

    Instead of materializing (row_idR, row_idS) pairs (reference
    GetResults, rhjoin.c:141-217), the aggregate is pushed into the probe:
    per probe row the contiguous sorted-build match range [lo, hi) yields

        count     += hi - lo
        sum_build += prefix[hi] - prefix[lo]     (prefix-sums of values)
        sum_probe += (hi - lo) * probe_value

    all in wrap-around uint64 — no intermediate pair list, no second pass.
    """
    Pb = bkeys.shape[0]
    live_b = jnp.arange(Pb, dtype=jnp.int32) < n_build
    k = jnp.where(live_b, bkeys, _PAD_KEY)
    perm = jnp.argsort(k)
    sk = k[perm]
    sv = jnp.where(live_b, bvals, 0)[perm].astype(jnp.uint64)
    pref = jnp.concatenate([jnp.zeros((1,), jnp.uint64), jnp.cumsum(sv)])
    # method="sort": see ops/sort_join.py.
    lo = jnp.minimum(jnp.searchsorted(sk, pkeys, side="left", method="sort"), n_build)
    hi = jnp.minimum(jnp.searchsorted(sk, pkeys, side="right", method="sort"), n_build)
    Pp = pkeys.shape[0]
    live_p = jnp.arange(Pp, dtype=jnp.int32) < n_probe
    cnt = jnp.where(live_p, hi - lo, 0).astype(jnp.uint64)
    sum_build = jnp.sum(jnp.where(live_p, pref[hi] - pref[lo], 0))
    sum_probe = jnp.sum(cnt * pvals.astype(jnp.uint64))
    total = jnp.sum(cnt)
    return total, sum_build, sum_probe


# ---------------------------------------------------------------------------
# End-to-end SPMD programs
# ---------------------------------------------------------------------------


def make_dist_join_checksum(mesh: Mesh, cap: int):
    """Build the jitted SPMD program: filter → hash shuffle → local join →
    psum'd (count, sum_build_col, sum_probe_col).

    Inputs are row-sharded columns; `filter_const` applies `> const` to the
    build side's payload column before the join (a representative one-join
    query: `SELECT SUM(r.b), SUM(s.c) FROM r, s WHERE r.a = s.a AND r.b > k`).
    Outputs are replicated scalars (count, sum_build, sum_probe, overflow):
    the first three are bit-exact wrap-around uint64, identical on every
    chip; `overflow` is nonzero iff any chip's per-destination send buffer
    truncated (undersized `cap`) — the result is then invalid and the
    caller must retry with a bigger cap instead of trusting it silently.
    """
    ndev = mesh.devices.size

    def step(r_key, r_val, s_key, s_val, filter_const):
        live_r = r_val > filter_const
        live_s = jnp.ones(s_key.shape, dtype=bool)
        sk_r, sp_r, cnt_r, ov_r = partition_for_exchange(r_key, r_val, live_r, ndev, cap)
        sk_s, sp_s, cnt_s, ov_s = partition_for_exchange(s_key, s_val, live_s, ndev, cap)
        bk, bv, nb = exchange(sk_r, sp_r, cnt_r)
        pk, pv, npr = exchange(sk_s, sp_s, cnt_s)
        total, sum_b, sum_p = local_join_checksum(bk, bv, nb, pk, pv, npr)
        overflow = (ov_r | ov_s).astype(jnp.int32)
        return (jax.lax.psum(total, AXIS), jax.lax.psum(sum_b, AXIS),
                jax.lax.psum(sum_p, AXIS), jax.lax.psum(overflow, AXIS))

    sharded = shard_map(
        step, mesh=mesh,
        in_specs=(P(AXIS), P(AXIS), P(AXIS), P(AXIS), P()),
        out_specs=(P(), P(), P(), P()),
    )
    return jax.jit(sharded)


def make_dist_join_parts(mesh: Mesh, cap: int):
    """The two measured halves of make_dist_join_checksum's cost model
    (scaling table v2, VERDICT r4 #7): `comp_only` runs the identical
    per-chip work (filter, partition scatter, local sort-join,
    checksum psum) with the exchange REPLACED by the chip's own send
    buffers flattened locally — zero cross-chip traffic; `comm_only`
    runs ONLY the partition + all_to_all exchange of both key columns.
    predicted(n) = comp_only(n) + comm_only(n); measured/predicted on
    the full program separates algorithmic overhead from core-sharing
    noise on virtual meshes."""
    ndev = mesh.devices.size

    def comp_step(r_key, r_val, s_key, s_val, filter_const):
        live_r = r_val > filter_const
        live_s = jnp.ones(s_key.shape, dtype=bool)
        sk_r, sp_r, cnt_r, _ = partition_for_exchange(r_key, r_val, live_r,
                                                      ndev, cap)
        sk_s, sp_s, cnt_s, _ = partition_for_exchange(s_key, s_val, live_s,
                                                      ndev, cap)
        # local flatten in place of the exchange: same shapes, same
        # downstream work, no collective
        bk, bv = sk_r.reshape(-1), sp_r.reshape(-1)
        pk, pv = sk_s.reshape(-1), sp_s.reshape(-1)
        total, sum_b, sum_p = local_join_checksum(
            bk, bv, jnp.sum(cnt_r), pk, pv, jnp.sum(cnt_s))
        return (jax.lax.psum(total, AXIS), jax.lax.psum(sum_b, AXIS),
                jax.lax.psum(sum_p, AXIS))

    def comm_step(r_key, s_key):
        live = jnp.ones(r_key.shape, dtype=bool)
        sk_r, sp_r, cnt_r, _ = partition_for_exchange(r_key, r_key, live,
                                                      ndev, cap)
        sk_s, sp_s, cnt_s, _ = partition_for_exchange(s_key, s_key,
                                                      jnp.ones(s_key.shape,
                                                               bool),
                                                      ndev, cap)
        bk, _, nb = exchange(sk_r, sp_r, cnt_r)
        pk, _, npr = exchange(sk_s, sp_s, cnt_s)
        # tiny reduction so nothing is DCE'd; the partition runs in both
        # halves, so comp+comm double-counts it — conservative (the
        # prediction errs slow, never fabricates efficiency)
        return jax.lax.psum(bk[0] + pk[0] + nb.astype(jnp.uint64)
                            + npr.astype(jnp.uint64), AXIS)

    comp = jax.jit(shard_map(
        comp_step, mesh=mesh,
        in_specs=(P(AXIS), P(AXIS), P(AXIS), P(AXIS), P()),
        out_specs=(P(), P(), P())))
    comm = jax.jit(shard_map(
        comm_step, mesh=mesh, in_specs=(P(AXIS), P(AXIS)),
        out_specs=P()))
    return comp, comm


def partition_multi(keys: jax.Array, payloads, live: jax.Array,
                    ndev: int, cap: int):
    """partition_for_exchange with a tuple of payload columns: the
    destination/rank computation runs once, every payload rides it."""
    L = keys.shape[0]
    dest = _dest_of(keys, live, ndev)
    order = jnp.argsort(dest, stable=True).astype(jnp.int32)
    sdest = dest[order]
    hist = jnp.bincount(dest, length=ndev + 1).astype(jnp.int32)
    starts = _exclusive_cumsum(hist)
    rank = jnp.arange(L, dtype=jnp.int32) - starts[sdest]
    send_keys = jnp.full((ndev, cap), _PAD_KEY, dtype=jnp.uint64)
    send_keys = send_keys.at[sdest, rank].set(keys[order], mode="drop")
    send_pay = tuple(
        jnp.zeros((ndev, cap), dtype=p.dtype).at[sdest, rank].set(
            p[order], mode="drop")
        for p in payloads
    )
    counts = jnp.minimum(hist[:ndev], cap)
    return send_keys, send_pay, counts


def _ring_all_to_all(x: jax.Array) -> jax.Array:
    """all_to_all over the first axis, decomposed into ndev-1 `ppermute`
    neighbor-distance hops (SURVEY §5 "long-axis" row: the ring
    alternative for meshes whose links cannot carry a full-fanout
    all_to_all at once — each hop k moves every chip's row for its distance-k
    peer directly, so traffic per step is one [cap] row per chip and
    the collective never concentrates on a single link).

    Contract identical to `all_to_all(x, split_axis=0, concat_axis=0)`:
    returned row s on chip d is row d of chip s's input."""
    ndev = x.shape[0]
    me = jax.lax.axis_index(AXIS)
    out = jnp.zeros_like(x)
    out = out.at[me].set(jnp.take(x, me, axis=0))
    for k in range(1, ndev):
        row = jnp.take(x, jnp.mod(me + k, ndev), axis=0)
        perm = [(i, (i + k) % ndev) for i in range(ndev)]
        got = jax.lax.ppermute(row, AXIS, perm)  # arrives from (me-k)%ndev
        out = out.at[jnp.mod(me - k, ndev)].set(got)
    return out


def _transport(via: str):
    if via == "ring":
        return _ring_all_to_all
    return partial(jax.lax.all_to_all, axis_name=AXIS, split_axis=0,
                   concat_axis=0)


def exchange_multi(send_keys: jax.Array, send_pays, counts: jax.Array,
                   via: str = "a2a"):
    """`exchange` for a tuple of payload buffers.  `via`: "a2a" (XLA
    all_to_all, full fanout) or "ring" (ppermute hops, neighbor-only)."""
    ndev, cap = send_keys.shape
    a2a = _transport(via)
    recv_keys = a2a(send_keys)
    recv_pays = tuple(a2a(p) for p in send_pays)
    recv_cnt = a2a(counts[:, None])[:, 0]
    total = ndev * cap
    starts = _exclusive_cumsum(recv_cnt)
    slot = jnp.arange(cap, dtype=jnp.int32)[None, :]
    valid = slot < recv_cnt[:, None]
    idx = jnp.where(valid, starts[:, None] + slot, total)
    keys = jnp.full((total,), _PAD_KEY, dtype=jnp.uint64)
    keys = keys.at[idx.reshape(-1)].set(recv_keys.reshape(-1), mode="drop")
    pays = tuple(
        jnp.zeros((total,), dtype=p.dtype)
        .at[idx.reshape(-1)].set(p.reshape(-1), mode="drop")
        for p in recv_pays
    )
    return keys, pays, jnp.sum(recv_cnt)


def local_join_checksum_multi(bkeys, bcols, n_build, pkeys, pcols, n_probe):
    """Chip-local fused join with V view columns per side (the multi-view
    generalization of local_join_checksum; same prefix-sum pushdown as
    ops/agg_join.py)."""
    Pb = bkeys.shape[0]
    live_b = jnp.arange(Pb, dtype=jnp.int32) < n_build
    k = jnp.where(live_b, bkeys, _PAD_KEY)
    perm = jnp.argsort(k).astype(jnp.int32)
    sk = k[perm]
    sv = jnp.where(live_b[None, :], bcols, jnp.uint64(0))[:, perm]
    pref = jnp.concatenate(
        [jnp.zeros((sv.shape[0], 1), jnp.uint64), jnp.cumsum(sv, axis=1)],
        axis=1,
    )
    lo = jnp.minimum(jnp.searchsorted(sk, pkeys, side="left", method="sort"),
                     n_build)
    hi = jnp.minimum(jnp.searchsorted(sk, pkeys, side="right", method="sort"),
                     n_build)
    Pp = pkeys.shape[0]
    live_p = jnp.arange(Pp, dtype=jnp.int32) < n_probe
    cnt = jnp.where(live_p, hi - lo, 0).astype(jnp.uint64)
    count = jnp.sum(cnt)
    sums_b = jnp.sum(
        jnp.where(live_p[None, :], pref[:, hi] - pref[:, lo], jnp.uint64(0)),
        axis=1,
    )
    sums_p = jnp.sum(cnt[None, :] * pcols, axis=1)
    return count, sums_b, sums_p


def make_fused_shuffle_join(mesh: Mesh, cap: int, n_views: int):
    """The distributed fused final join: hash-shuffle both sides (keys +
    n_views view columns each), chip-local multi-view join+checksum,
    psum'd [1 + n_views] packed result — the SPMD twin of the
    single-chip ops/join_checksum_fused, used by DistJaxEngine.

    Inputs are row-sharded GLOBAL padded arrays plus replicated live
    counts (live prefix is global: shard i owns rows [i*L, (i+1)*L))."""
    ndev = mesh.devices.size

    def step(bk, bcols, n_b, pk, pcols, n_p):
        L = bk.shape[0]
        me = jax.lax.axis_index(AXIS)
        gidx = me * L + jnp.arange(L, dtype=jnp.int32)
        live_b = gidx < n_b
        live_p = (me * pk.shape[0]
                  + jnp.arange(pk.shape[0], dtype=jnp.int32)) < n_p

        sk_b, sp_b, cnt_b = partition_multi(bk, tuple(bcols), live_b, ndev, cap)
        sk_p, sp_p, cnt_p = partition_multi(pk, tuple(pcols), live_p, ndev, cap)
        kb, vb, nb = exchange_multi(sk_b, sp_b, cnt_b)
        kp, vp, npr = exchange_multi(sk_p, sp_p, cnt_p)
        count, sums_b, sums_p = local_join_checksum_multi(
            kb, jnp.stack(vb), nb, kp, jnp.stack(vp), npr,
        )
        packed = jnp.concatenate([count.reshape(1), sums_b + sums_p])
        return jax.lax.psum(packed, AXIS)

    v = P(None, AXIS)
    sharded = shard_map(
        step, mesh=mesh,
        in_specs=(P(AXIS), v, P(), P(AXIS), v, P()),
        out_specs=P(),
    )
    return jax.jit(sharded)


def make_shuffle_caps(mesh: Mesh):
    """Max per-(source, destination) row count for BOTH sides in one
    readback (sizes make_fused_shuffle_join's static cap)."""
    ndev = mesh.devices.size

    def one(keys, n, L):
        me = jax.lax.axis_index(AXIS)
        live = (me * L + jnp.arange(L, dtype=jnp.int32)) < n
        dest = _dest_of(keys, live, ndev)
        hist = jnp.bincount(dest, length=ndev + 1).astype(jnp.int32)[:ndev]
        return jax.lax.pmax(jnp.max(hist), AXIS)

    def step(bk, n_b, pk, n_p):
        return jnp.stack([one(bk, n_b, bk.shape[0]),
                          one(pk, n_p, pk.shape[0])])

    return jax.jit(shard_map(step, mesh=mesh,
                             in_specs=(P(AXIS), P(), P(AXIS), P()),
                             out_specs=P()))


def make_exchange_counts(mesh: Mesh):
    """First-pass program: exact per-destination row counts after the
    shuffle, so the host can pick the send capacity (SURVEY §7.1 two-phase
    rule).  Returns max rows any chip receives from any single peer."""
    ndev = mesh.devices.size

    def step(keys):
        live = jnp.ones(keys.shape, dtype=bool)
        dest = _dest_of(keys, live, ndev)
        hist = jnp.bincount(dest, length=ndev + 1).astype(jnp.int32)[:ndev]
        return jax.lax.pmax(jnp.max(hist), AXIS)

    return jax.jit(shard_map(step, mesh=mesh, in_specs=(P(AXIS),), out_specs=P()))


def _local_key_counts(keys: jax.Array, live: jax.Array):
    """Per-row multiplicity of its own key within the local shard, and a
    first-occurrence mask (for candidate extraction)."""
    L = keys.shape[0]
    k = jnp.where(live, keys, _PAD_KEY)
    sk = jnp.sort(k)
    lo = jnp.searchsorted(sk, k, side="left", method="sort")
    hi = jnp.searchsorted(sk, k, side="right", method="sort")
    cnt = jnp.where(live, hi - lo, 0).astype(jnp.int32)
    # first occurrence in *unsorted* order: my position == min position of
    # my key.  Approximate via sorted ranks: a row is "first" if its key's
    # range start maps back to it after the sort permutation — cheaper:
    # mark the sorted first-of-run and scatter back through argsort.
    perm = jnp.argsort(k).astype(jnp.int32)
    first_sorted = jnp.concatenate(
        [jnp.ones((1,), bool), sk[1:] != sk[:-1]]
    )
    first = jnp.zeros((L,), bool).at[perm].set(first_sorted)
    return cnt, first & live


def make_dist_join_checksum_skew(mesh: Mesh, cap: int, hot_k: int = 16,
                                 hot_cap: int = 256,
                                 hot_threshold: int = 4):
    """Skew-aware variant of make_dist_join_checksum.

    A plain hash shuffle routes every row of a hot key to one chip — a
    Zipf-distributed key column turns the all_to_all into a hot spot and
    the owning chip into the critical path (north-star skew requirement,
    BASELINE.json).  The split:

      1. detect ≤hot_k global heavy hitters: per-chip top-k candidates by
         local multiplicity (sort + run lengths + top_k), all_gather the
         candidate keys, psum exact global counts, keep keys whose count
         exceeds hot_threshold × (rows/chip average share),
      2. build rows with hot keys are all_gather'ed (≤hot_cap per chip) —
         every chip holds the full hot build table (duplicate build rows,
         the classic broadcast side of a skew split),
      3. probe rows with hot keys stay local and join against the
         gathered hot table — the hot key's probe work is spread evenly
         over all chips instead of landing on one,
      4. everything else takes the normal hash shuffle + local join.

    Aggregates from both paths psum into the same three scalars; a fourth
    `overflow` output is nonzero iff any chip truncated hot build rows
    (more than `hot_cap` local hot rows) or overflowed a cold send buffer
    (undersized `cap`) — silent truncation would corrupt the psum'd
    checksums, so the caller must check it and retry with bigger caps.
    """
    ndev = mesh.devices.size

    def step(r_key, r_val, s_key, s_val, filter_const):
        live_r = r_val > filter_const
        live_s = jnp.ones(s_key.shape, dtype=bool)

        # --- 1. heavy-hitter detection on BOTH key columns ---------------
        # A hot key on either side turns the plain hash shuffle into a
        # one-chip hot spot: hot probe keys pile probe rows there, hot
        # BUILD keys pile build rows there just the same (VERDICT r1
        # weak #5 — probe-only detection missed the latter).
        def side_candidates(keys, live):
            cnt, first = _local_key_counts(keys, live)
            score = jnp.where(first, cnt, 0)
            _, idx = jax.lax.top_k(score, hot_k)
            return jnp.where(score[idx] > 0, keys[idx], _PAD_KEY)

        all_cand = jnp.sort(jnp.concatenate([
            jax.lax.all_gather(side_candidates(r_key, live_r),
                               AXIS).reshape(-1),
            jax.lax.all_gather(side_candidates(s_key, live_s),
                               AXIS).reshape(-1),
        ]))
        dup = jnp.concatenate(
            [jnp.zeros((1,), bool), all_cand[1:] == all_cand[:-1]])

        def global_counts(keys, live):
            # exact global count per candidate via my sorted local keys
            skl = jnp.sort(jnp.where(live, keys, _PAD_KEY))
            lo = jnp.searchsorted(skl, all_cand, side="left", method="sort")
            hi = jnp.searchsorted(skl, all_cand, side="right", method="sort")
            return jax.lax.psum((hi - lo).astype(jnp.int32), AXIS)

        gc_r = global_counts(r_key, live_r)
        gc_s = global_counts(s_key, live_s)
        # Heavy iff routing all of this key's rows (either side) to one
        # chip would add more than 1/hot_threshold of a chip's average
        # row share of that side.
        share_r = max(1, r_key.shape[0] // max(1, hot_threshold))
        share_s = max(1, s_key.shape[0] // max(1, hot_threshold))
        valid = (all_cand != _PAD_KEY) & ~dup
        is_heavy = valid & ((gc_r > jnp.int32(share_r))
                            | (gc_s > jnp.int32(share_s)))
        score = jnp.where(is_heavy, jnp.maximum(gc_r, gc_s), 0)
        _, hot_idx = jax.lax.top_k(score, hot_k)
        hot_keys = jnp.sort(jnp.where(score[hot_idx] > 0, all_cand[hot_idx],
                                      _PAD_KEY))

        def is_hot(keys, live):
            pos = jnp.searchsorted(hot_keys, keys, side="left", method="sort")
            pos = jnp.minimum(pos, hot_k - 1)
            return (hot_keys[pos] == keys) & (keys != _PAD_KEY) & live

        hot_r = is_hot(r_key, live_r)
        hot_s = is_hot(s_key, live_s)

        # --- 2. all_gather the hot build rows ----------------------------
        n_hot_local = jnp.sum(hot_r.astype(jnp.int32))
        hot_overflow = n_hot_local > jnp.int32(hot_cap)
        hp = jnp.argsort(~hot_r, stable=True).astype(jnp.int32)[:hot_cap]
        sel = hot_r[hp]
        hk = jnp.where(sel, r_key[hp], _PAD_KEY)
        hv = jnp.where(sel, r_val[hp], 0)
        gk = jax.lax.all_gather(hk, AXIS).reshape(-1)
        gv = jax.lax.all_gather(hv, AXIS).reshape(-1)
        n_hot_build = jnp.sum((gk != _PAD_KEY).astype(jnp.int32))
        # compact PAD rows to the suffix for the live-prefix contract
        order = jnp.argsort(gk == _PAD_KEY, stable=True).astype(jnp.int32)
        gk, gv = gk[order], gv[order]

        # --- 3. local probe of hot rows ----------------------------------
        pk_hot = jnp.where(hot_s, s_key, _PAD_KEY)
        pv_hot = jnp.where(hot_s, s_val, 0)
        # PAD probe keys find no live build row (build PADs are clamped out)
        t_h, sb_h, sp_h = local_join_checksum(
            gk, gv, n_hot_build, pk_hot, pv_hot,
            jnp.int32(pk_hot.shape[0]),
        )

        # --- 4. normal shuffle for the cold rows -------------------------
        cold_r = live_r & ~hot_r
        cold_s = live_s & ~hot_s
        sk_r, sp_r, cnt_r, ov_r = partition_for_exchange(r_key, r_val, cold_r,
                                                         ndev, cap)
        sk_s, sp_s, cnt_s2, ov_s = partition_for_exchange(s_key, s_val, cold_s,
                                                          ndev, cap)
        bk, bv, nb = exchange(sk_r, sp_r, cnt_r)
        pk, pv, npr = exchange(sk_s, sp_s, cnt_s2)
        t_c, sb_c, sp_c = local_join_checksum(bk, bv, nb, pk, pv, npr)

        overflow = (hot_overflow | ov_r | ov_s).astype(jnp.int32)
        return (jax.lax.psum(t_h + t_c, AXIS),
                jax.lax.psum(sb_h + sb_c, AXIS),
                jax.lax.psum(sp_h + sp_c, AXIS),
                jax.lax.psum(overflow, AXIS))

    sharded = shard_map(
        step, mesh=mesh,
        in_specs=(P(AXIS), P(AXIS), P(AXIS), P(AXIS), P()),
        out_specs=(P(), P(), P(), P()),
    )
    return jax.jit(sharded)


def make_dist_checksum(mesh: Mesh):
    """Distributed wrap-around uint64 SUM of a row-sharded column."""
    def step(col):
        return jax.lax.psum(jnp.sum(col, dtype=jnp.uint64), AXIS)

    return jax.jit(shard_map(step, mesh=mesh, in_specs=(P(AXIS),), out_specs=P()))
