"""Bring-up smoke test: the join engine's main path on NVIDIA GPUs.

Drives the engine the way a user does, `python -m sigmod2018_tpu` fed the
contest protocol, over every committed workload at its full size, and
checks every answer exactly.  Phases, on one card (no arguments):

  device   every JAX device must be a GPU (no CPU fallback); prints the
           card's name and power limit as nvidia-smi reports them
  data     generates each workload's relation binaries from its seed
           (tools/regen_workloads.sh parameters, gen_workload.py
           --relations-only) under build/workloads/, and checks the
           generated .init and the binaries' digests (NAME.sha1)
           against the committed ones
  serve    serves each workload through `python -m sigmod2018_tpu` in a
           child process with S18_WARMUP_ORACLE=0, twice: cold, then with
           the compile cache, learned size classes and program vault
           warm.  Every output line must equal the committed .result
           line (exact u64: the device path has no floating point), and
           the REPL's exit summary must show every query answered by the
           device, none by a host tier and no failed fetch
  vault    big's second run must have restored its programs from the
           vault its first run built (a fresh S18_PREP_CACHE per
           workload), with no load or build failure
  members  the XLA join members (fused: sort, presorted, key table, key
           table + prefix tables; emitting: sort, key table) at 2^21 to
           2^24 rows per side, u32 and u64 keys and a hot-key case,
           exact against a NumPy oracle; prints the median device time
           of 5 runs after one warm-up call

The children run one at a time and the parent opens the card only for
the last phase, after every child has ended: a JAX process reserves
most of the card's memory when it starts.

`--cards 4` runs only the multi-card path: big and zipfbig served with
S18_MESH=4 (row-sharded relations, shard_map joins) and compared with
the committed .result, with each card's peak bytes in use (all must be
nonzero).

The last line of stdout is {"ok": true, "device": {...}} only when every
phase passed; any failure exits nonzero without it.

Usage: python chip_smoke.py [--cards 4] [--out DIR]
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import shlex
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

from sigmod2018_tpu.io.repl import SERVE_SUMMARY_TAG
from sigmod2018_tpu.utils.device import card_name_and_power

REPO = Path(__file__).resolve().parent
WORKLOADS = ("scaled", "zipf", "big", "bigdom", "zipfbig")
MESH_WORKLOADS = ("big", "zipfbig")
MEMBER_SIZES = (21, 22, 23, 24)  # log2 rows per side
HOT_SIZE = 23
DEADLINE_S = 1150.0
_T0 = time.monotonic()


class SmokeFailure(Exception):
    pass


def log(msg: str) -> None:
    print(f"[smoke +{time.monotonic() - _T0:6.1f}s] {msg}", flush=True)


def remaining(cap: float) -> float:
    left = DEADLINE_S - (time.monotonic() - _T0)
    if left < 10:
        raise SmokeFailure("out of time")
    return min(cap, left)


# ---- device ---------------------------------------------------------------

_DEVICE_PROBE = """
import json, jax
d = jax.devices()
print(json.dumps({"platforms": sorted({x.platform for x in d}),
                  "platform": d[0].platform, "kind": d[0].device_kind,
                  "count": len(d)}))
"""


def phase_device(cards: int) -> dict:
    out = subprocess.run([sys.executable, "-c", _DEVICE_PROBE],
                         capture_output=True, text=True,
                         timeout=remaining(300))
    if out.returncode != 0:
        raise SmokeFailure(f"JAX failed to start: {out.stderr[-2000:]}")
    dev = json.loads(out.stdout.strip().splitlines()[-1])
    if dev["platforms"] != ["gpu"]:
        raise SmokeFailure(f"no GPU: JAX devices are {dev['platforms']}")
    if dev["count"] != cards:
        raise SmokeFailure(f"{dev['count']} GPUs, need {cards}")
    card = card_name_and_power()
    if card is None:
        raise SmokeFailure("nvidia-smi did not report the card")
    log(f"device: {dev['count']} x {dev['kind']}")
    print(card, flush=True)
    return {"platform": dev["platform"], "kind": dev["kind"],
            "count": dev["count"]}


# ---- data -----------------------------------------------------------------

def regen_args() -> dict:
    """Workload name -> gen_workload.py arguments, from the committed
    tools/regen_workloads.sh (the one place the seeds live)."""
    args = {}
    script = REPO / "tools" / "regen_workloads.sh"
    for line in script.read_text().splitlines():
        if line.startswith("python tools/gen_workload.py "):
            words = shlex.split(line)
            args[Path(words[2]).name] = words[3:]
    return args


def phase_data(names, data_dir: Path) -> None:
    gen = regen_args()
    procs = {}
    for name in names:
        out = data_dir / name
        shutil.rmtree(out, ignore_errors=True)
        procs[name] = subprocess.Popen(
            [sys.executable, str(REPO / "tools" / "gen_workload.py"),
             str(out), *gen[name], "--relations-only"],
            cwd=REPO, env=dict(os.environ, PYTHONPATH=str(REPO)),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, p in procs.items():
        text, _ = p.communicate(timeout=remaining(300))
        if p.returncode != 0:
            raise SmokeFailure(f"data {name}: generator failed: "
                               f"{text[-2000:]}")
        got = (data_dir / name / f"{name}.init").read_text()
        want = (REPO / "workloads" / name / f"{name}.init").read_text()
        if got != want:
            raise SmokeFailure(f"data {name}: .init differs from committed")
        # The committed .result answers the committed binaries: a
        # generator whose stream drifted (another NumPy) must fail here,
        # not as a wrong answer of the engine.
        sums = (REPO / "workloads" / name / f"{name}.sha1").read_text()
        for line in sums.splitlines():
            digest, rel = line.split()
            data = (data_dir / name / rel).read_bytes()
            if hashlib.sha1(data).hexdigest() != digest:
                raise SmokeFailure(f"data {name}: {rel} differs from the "
                                   f"committed digest")
        log(f"data {name}: {text.strip()}, digests match")


# ---- serve ----------------------------------------------------------------

def serve(name: str, data_dir: Path, env: dict, log_path: Path) -> dict:
    """One `python -m sigmod2018_tpu` run over a workload: checks every
    line against the committed .result; returns timings and the REPL's
    exit summary."""
    wl = REPO / "workloads" / name
    rels = [str(data_dir / name / line.strip())
            for line in (wl / f"{name}.init").read_text().splitlines()
            if line.strip()]
    stdin = "\n".join(rels) + "\nDone\n" + (wl / f"{name}.work").read_text()
    want = [l for l in (wl / f"{name}.result").read_text().splitlines()
            if l.strip()]
    t0 = time.perf_counter()
    with open(log_path, "w") as err:  # streamed: a crash keeps its log
        out = subprocess.run([sys.executable, "-m", "sigmod2018_tpu"],
                             input=stdin, stdout=subprocess.PIPE,
                             stderr=err, text=True, cwd=REPO, env=env,
                             timeout=remaining(600))
    wall = time.perf_counter() - t0
    stderr = log_path.read_text()
    if out.returncode != 0:
        raise SmokeFailure(f"serve {name}: exit {out.returncode}: "
                           f"{stderr[-2000:]}")
    got = out.stdout.splitlines()
    mismatches = sum(g != w for g, w in zip(got, want))
    mismatches += abs(len(got) - len(want))
    summary = None
    for line in stderr.splitlines():
        if line.startswith(SERVE_SUMMARY_TAG + " "):
            summary = json.loads(line[len(SERVE_SUMMARY_TAG) + 1:])
    if summary is None:
        raise SmokeFailure(f"serve {name}: no tier summary on stderr")
    return {"wall_s": wall, "mismatches": mismatches, "queries": len(want),
            "summary": summary}


def check_served(name: str, run: dict, tag: str, cards: int = 1) -> None:
    s = run["summary"]
    peaks = s["peak_bytes"]
    share = ", ".join(
        f"{p / lim * 100:.1f}%" if p and lim else "n/a"
        for p, lim in zip(peaks, s["bytes_limit"]))
    log(f"serve {name} ({tag}): {run['wall_s']:.2f} s wall, "
        f"compile {s['compile_s']:.2f} s, {run['mismatches']} mismatches "
        f"of {run['queries']}; tiers device={s['device']} "
        f"warmup_host={s['warmup_host']} failure_host={s['failure_host']} "
        f"fetch_failed={s['fetch_failed']} errors={s['errors']}; "
        f"peak bytes {peaks} ({share} of the allocator limit)")
    if run["mismatches"]:
        raise SmokeFailure(f"serve {name} ({tag}): {run['mismatches']} "
                           f"mismatches")
    if (s["device"] != run["queries"] or s["warmup_host"]
            or s["failure_host"] or s["fetch_failed"] or s["errors"]):
        raise SmokeFailure(f"serve {name} ({tag}): not every query was "
                           f"answered by the device: {s}")
    if len(peaks) != cards or not all(peaks):
        raise SmokeFailure(f"serve {name} ({tag}): peak bytes {peaks} — "
                           f"not every card held data")


def phase_serve(names, data_dir: Path, out_dir: Path) -> dict:
    runs = {}
    for name in names:
        prep = out_dir / f"prep-{name}"
        shutil.rmtree(prep, ignore_errors=True)
        env = dict(os.environ, S18_WARMUP_ORACLE="0",
                   S18_PREP_CACHE=str(prep))
        for tag in ("cold", "warm"):
            run = serve(name, data_dir, env, out_dir / f"{name}-{tag}.log")
            check_served(name, run, tag)
            runs[(name, tag)] = run
    return runs


def phase_vault(runs: dict) -> None:
    built = runs[("big", "cold")]["summary"]["vault"]
    restored = runs[("big", "warm")]["summary"]["vault"]
    log(f"vault big: build run {built}; restore run {restored}")
    if built["built"] < 1 or restored["restored"] < 1:
        raise SmokeFailure("vault big: no program built and restored")
    for v in (built, restored):
        if v["build_failed"] or v["load_failed"] or v["disabled"]:
            raise SmokeFailure(f"vault big: failures {v}")


# ---- members --------------------------------------------------------------

def _oracle_fused(kb, vb, kp, vp):
    """(count, sums_build, sums_probe) from per-row match counts on both
    sides — exact wrap-around u64 in NumPy."""
    sb, sp = np.sort(kb), np.sort(kp)
    cnt_p = (np.searchsorted(sb, kp, "right")
             - np.searchsorted(sb, kp, "left")).astype(np.uint64)
    cnt_b = (np.searchsorted(sp, kb, "right")
             - np.searchsorted(sp, kb, "left")).astype(np.uint64)
    return (int(cnt_p.sum(dtype=np.uint64)),
            [int((cnt_b * v).sum(dtype=np.uint64)) for v in vb],
            [int((cnt_p * v).sum(dtype=np.uint64)) for v in vp])


def _keys(rng, kind: str, n: int, lut):
    if kind == "u64":  # 2^20 distinct keys spread over 2^40 (bigdom)
        return lut[rng.integers(0, lut.size, n)]
    if kind == "hot":  # Zipf(1.3) ranks, clipped to 2^20 keys (zipf)
        return np.minimum(rng.zipf(1.3, n), 1 << 20).astype(np.uint64) - 1
    return rng.integers(0, 1 << 20, n, dtype=np.uint64)  # u32 (big)


def phase_members(out_dir: Path) -> None:
    import jax
    import jax.numpy as jnp

    from sigmod2018_tpu import ops

    rng = np.random.default_rng(0)
    lut = rng.permutation(np.unique(
        rng.integers(0, 1 << 40, 1 << 21, dtype=np.uint64)))[:1 << 20]
    cases = [(kind, log2) for log2 in MEMBER_SIZES
             for kind in ("u32", "u64")] + [("hot", HOT_SIZE)]
    records = []

    def timed(name, kind, log2, fn, check):
        out = jax.block_until_ready(fn())  # compile + warm-up
        if not check(out):
            raise SmokeFailure(f"members {name} {kind} 2^{log2}: wrong")
        ts = []
        for _ in range(5):
            t0 = time.perf_counter()
            jax.block_until_ready(fn())
            ts.append((time.perf_counter() - t0) * 1e3)
        ms = statistics.median(ts)
        records.append({"member": name, "keys": kind, "rows": 1 << log2,
                        "median_ms": ms, "runs_ms": ts})
        log(f"members {name:14s} {kind} 2^{log2}: {ms:9.3f} ms "
            f"(median of 5), exact")

    for kind, log2 in cases:
        P = 1 << log2
        n = P - 1000  # live prefix: the tail is padding
        kb = np.zeros(P, np.uint64)
        kp = np.zeros(P, np.uint64)
        kb[:n] = _keys(rng, kind, n, lut)
        kp[:n] = _keys(rng, kind, n, lut)
        vb = rng.integers(0, 1 << 63, (2, P), dtype=np.uint64)
        vp = rng.integers(0, 1 << 63, (1, P), dtype=np.uint64)
        want = _oracle_fused(kb[:n], vb[:, :n], kp[:n], vp[:, :n])
        sb = np.sort(kb[:n])
        lo_want = np.searchsorted(sb, kp[:n], "left")
        cnt_want = np.searchsorted(sb, kp[:n], "right") - lo_want
        key32 = kind != "u64"
        d_kb, d_kp = jnp.asarray(kb), jnp.asarray(kp)
        d_vb, d_vp = jnp.asarray(vb), jnp.asarray(vp)
        nb = npr = jnp.int32(n)
        sk, perm = ops.join_build(d_kb, nb)
        sk_emit = sk.astype(jnp.uint32) if key32 else sk

        def fused_ok(out):
            c, s_b, s_p = out
            return (int(c) == want[0]
                    and [int(x) for x in np.asarray(s_b)] == want[1]
                    and [int(x) for x in np.asarray(s_p)] == want[2])

        def emit_ok(out):
            lo, cnt, _, total = out
            cnt = np.asarray(cnt)
            hit = cnt_want > 0
            return (np.array_equal(cnt[:n], cnt_want)
                    and not cnt[n:].any()
                    and int(total) == int(cnt_want.sum())
                    and np.array_equal(np.asarray(lo)[:n][hit],
                                       lo_want[hit]))

        fused = {
            "fused_sort": lambda: ops.join_checksum_fused(
                d_kb, d_vb, nb, d_kp, d_vp, npr, key32=key32),
            "fused_presort": lambda: ops.join_checksum_fused_presorted(
                sk, perm, d_vb, nb, d_kp, d_vp, npr, key32=key32),
        }
        emit = {"emit_sort": lambda: ops.join_probe_count(
            sk_emit, nb, d_kp, npr)}
        if key32:  # bounded domain: the key-table members apply
            u = int(kb[:n].max())
            cum = np.zeros(u + 3, np.int32)
            cum[1:u + 2] = np.cumsum(np.bincount(kb[:n].astype(np.int64),
                                                 minlength=u + 1))
            cum[u + 2] = cum[u + 1]
            d_cum = jnp.asarray(cum)
            prefs = jnp.stack([ops.prefix_by_perm(d_vb[v], perm, nb)
                               for v in range(2)])
            fused["fused_table"] = lambda: ops.join_checksum_fused_table(
                d_cum, perm, d_vb, nb, d_kp, d_vp, npr)
            fused["fused_table_pref"] = (
                lambda: ops.join_checksum_fused_table_pref(
                    d_cum, prefs, d_kp, d_vp, npr))
            emit["emit_table"] = lambda: ops.join_probe_count_table(
                d_cum, d_kp, npr)
        for name, fn in fused.items():
            timed(name, kind, log2, fn, fused_ok)
        for name, fn in emit.items():
            timed(name, kind, log2, fn, emit_ok)
    (out_dir / "members.json").write_text(json.dumps(records, indent=1))


# ---- main -----------------------------------------------------------------

def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cards", type=int, choices=(1, 4), default=1)
    ap.add_argument("--out", default=str(REPO / "build" / "smoke"),
                    help="directory for logs and the member timings")
    args = ap.parse_args()
    out_dir = Path(args.out).resolve()
    data_dir = REPO / "build" / "workloads"
    out_dir.mkdir(parents=True, exist_ok=True)
    try:
        device = phase_device(args.cards)
        if args.cards == 4:
            phase_data(MESH_WORKLOADS, data_dir)
            env = dict(os.environ, S18_WARMUP_ORACLE="0", S18_MESH="4",
                       S18_PREP_CACHE=str(out_dir / "prep-mesh"))
            for name in MESH_WORKLOADS:
                run = serve(name, data_dir, env, out_dir / f"{name}-mesh.log")
                check_served(name, run, "mesh x4", cards=4)
        else:
            phase_data(WORKLOADS, data_dir)
            runs = phase_serve(WORKLOADS, data_dir, out_dir)
            phase_vault(runs)
            phase_members(out_dir)
            import jax

            d = jax.devices()
            device = {"platform": d[0].platform, "kind": d[0].device_kind,
                      "count": len(d)}
    except (SmokeFailure, subprocess.TimeoutExpired) as exc:
        log(f"FAIL: {exc}")
        return 1
    log("all phases passed")
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
