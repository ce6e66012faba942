"""Synthetic workload generator (BASELINE.json stress configs).

Generates a directory shaped exactly like workloads/small: NAME.init
(relation files), NAME.work (query batches), NAME.result (expected lines
from the NumPy oracle).  Profiles:

  uniform — independent uniform keys (the contest's shape)
  zipf    — Zipf-distributed join keys (heavy-hitter stress)
  scaled  — uniform at SCALE x the small workload's row counts

Usage: python tools/gen_workload.py OUT_DIR [--profile uniform|zipf|scaled]
       [--relations N] [--rows N] [--queries N] [--seed N] [--scale N]
       [--relations-only]

--relations-only stops after the relation binaries and NAME.init: the
random stream up to that point is the full run's, so the binaries are
byte-identical to a full run's, without the oracle's query answers.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from sigmod2018_tpu.engine.oracle import execute_query_numpy
from sigmod2018_tpu.frontend.parser import parse_query
from sigmod2018_tpu.storage.catalog import Catalog
from sigmod2018_tpu.storage.relation import Relation, store_relation


ZIPF_A = 1.3  # Zipf exponent of the skewed profiles


def zipf_ranks(rng, n: int, keyspace: int, a: float = ZIPF_A) -> np.ndarray:
    """n Zipf(a) ranks in [1, keyspace]: P(r) ~ r^-a below the keyspace,
    the rest of the unbounded law's mass (the clipped tail) on rank
    `keyspace`.  Drawn by inverse CDF from `rng.integers` with an
    integer CDF, so the stream is the same on every NumPy version
    (`Generator.zipf`'s sampler differs between versions)."""
    scale = 1 << 52
    w = np.array([int(r ** -a * scale) for r in range(1, keyspace)],
                 dtype=np.int64)
    # zeta(a) - sum_{r<k} r^-a, by the Euler-Maclaurin tail at k
    tail = (keyspace ** (1 - a) / (a - 1) + 0.5 * keyspace ** -a)
    cdf = np.cumsum(np.append(w, int(tail * scale)), dtype=np.int64)
    u = rng.integers(0, int(cdf[-1]), size=n, dtype=np.int64)
    return np.searchsorted(cdf, u, side="right").astype(np.uint64) + 1


def gen_relation(rng, rows: int, cols: int, profile: str, keyspace: int,
                 lut=None) -> Relation:
    data = []
    for _ in range(cols):
        if profile == "zipf":
            col = zipf_ranks(rng, rows, keyspace)
        elif profile == "bigdom":
            # Same collision structure as uniform (keyspace distinct
            # values, shared across relations via the workload LUT) but
            # spread over a ~2^40 domain: key tables (bounded-domain
            # rank tables, config.key_table_max) are impossible, so the
            # at-scale joins take the sort members.
            col = lut[rng.integers(0, keyspace, size=rows)]
        elif profile == "zipfbig":
            # Heavy-hitter ranks over the huge domain: hot keys at scale
            # with no key tables, exercising the sort members on long
            # duplicate runs and the skew machinery end-to-end.
            col = lut[zipf_ranks(rng, rows, keyspace).astype(np.int64) - 1]
        else:
            col = rng.integers(0, keyspace, size=rows, dtype=np.uint64)
        data.append(col)
    return Relation(columns=data)


def gen_query(rng, num_relations: int, lut=None, sample_const=None) -> str:
    nrel = int(rng.integers(2, 5))
    bindings = rng.integers(0, num_relations, size=nrel)
    preds = []
    for b in range(1, nrel):
        preds.append(f"{b-1}.{rng.integers(0,3)}={b}.{rng.integers(0,3)}")
    if rng.random() < 0.8:
        op = rng.choice(["<", ">", "="])
        # bigdom: constants must come from the value domain or every
        # filter is degenerate (values sit near 2^40).  zipfbig goes
        # further (sample_const): constants are drawn from the DATA, so
        # hot values are proportionally likely and equality filters
        # select real row sets instead of the lut's never-present tail.
        const = (sample_const() if sample_const is not None
                 else int(rng.choice(lut)) if lut is not None
                 else int(rng.integers(1, 1000)))
        preds.append(f"{rng.integers(0,nrel)}.{rng.integers(0,3)}{op}{const}")
    views = " ".join(
        f"{rng.integers(0, nrel)}.{rng.integers(0, 3)}"
        for _ in range(int(rng.integers(1, 4)))
    )
    return f"{' '.join(map(str, bindings))}|{'&'.join(preds)}|{views}"


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("out")
    ap.add_argument("--profile", default="uniform",
                    choices=["uniform", "zipf", "scaled", "bigdom", "zipfbig"])
    ap.add_argument("--domain", type=int, default=1 << 40,
                    help="bigdom: value domain the keyspace distinct "
                         "keys are spread over")
    ap.add_argument("--relations", type=int, default=6)
    ap.add_argument("--rows", type=int, default=20000)
    ap.add_argument("--queries", type=int, default=30)
    ap.add_argument("--batch", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--scale", type=int, default=10)
    ap.add_argument("--keyspace", type=int, default=1000)
    ap.add_argument("--cap", type=int, default=0,
                    help="max intermediate rows before a query is "
                         "regenerated (default: max(2M, rows*50))")
    ap.add_argument("--relations-only", action="store_true",
                    help="write the relations and NAME.init only")
    args = ap.parse_args()

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    name = out.name
    rng = np.random.default_rng(args.seed)
    rows = args.rows * (args.scale if args.profile == "scaled" else 1)

    lut = None
    if args.profile in ("bigdom", "zipfbig"):
        # replace=False over a 2^40 population is infeasible; oversample
        # and unique (collision odds ~(2k)^2/domain — negligible).
        lut = np.unique(rng.integers(0, args.domain, size=2 * args.keyspace,
                                     dtype=np.uint64))
        assert lut.size >= args.keyspace
        lut = rng.permutation(lut)[:args.keyspace]
    rels, init_lines = [], []
    for i in range(args.relations):
        rel = gen_relation(rng, rows, 3, args.profile, args.keyspace, lut)
        store_relation(rel, out / f"r{i}")
        rels.append(rel)
        init_lines.append(f"r{i}")
    (out / f"{name}.init").write_text("\n".join(init_lines) + "\n")
    if args.relations_only:
        print(f"{name}: {args.relations} relations x {rows} rows -> {out}")
        return

    from sigmod2018_tpu.engine.factorized import execute_query_factorized_np
    from sigmod2018_tpu.engine.oracle import OracleOverflow

    catalog = Catalog(rels)
    cap = args.cap or max(2_000_000, rows * 50)
    sample_const = None
    if args.profile == "zipfbig":
        # Constants from the data itself: hot values are proportionally
        # likely, so filters select real row sets and blowup queries
        # (answered by the factorized oracle below) are first-class
        # fixture content instead of being regenerated away.
        pool = np.concatenate([c[rng.integers(0, len(c), size=4096)]
                               for r in rels for c in r.columns])
        sample_const = lambda: int(rng.choice(pool))  # noqa: E731
    work, results = [], []
    for qi in range(args.queries):
        while True:  # regenerate queries whose results explode
            qtext = gen_query(rng, args.relations, lut, sample_const)
            try:
                res = execute_query_numpy(parse_query(qtext), catalog,
                                          max_rows=cap)
                break
            except OracleOverflow:
                # Materialization-infeasible: exact answer via the
                # factorized twin when the join graph is a forest —
                # these are the queries the reference C engine cannot
                # answer at all.
                res = execute_query_factorized_np(parse_query(qtext),
                                                  catalog)
                if res is not None:
                    break
                continue  # cyclic blowup: regenerate
        work.append(qtext)
        results.append(res)
        if (qi + 1) % args.batch == 0:
            work.append("F")
    if work and work[-1] != "F":
        work.append("F")
    (out / f"{name}.work").write_text("\n".join(work) + "\n")
    (out / f"{name}.result").write_text("\n".join(results) + "\n")
    print(f"{name}: {args.relations} relations x {rows} rows, "
          f"{args.queries} queries -> {out}")


if __name__ == "__main__":
    main()
