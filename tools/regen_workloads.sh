#!/usr/bin/env bash
# Regenerate the synthetic benchmark workloads (relation binaries are not
# committed; generation is deterministic by seed so .work/.result match).
# NAME.sha1 records the binaries' digests, so a regenerated copy (e.g.
# gen_workload.py --relations-only on another machine) can be checked.
set -euo pipefail
cd "$(dirname "$0")/.."
python tools/gen_workload.py workloads/scaled --profile scaled --rows 20000 --scale 10 --relations 6 --queries 12 --keyspace 20000 --seed 3
python tools/gen_workload.py workloads/zipf --profile zipf --rows 50000 --relations 6 --queries 12 --keyspace 5000 --seed 4 --cap 1000000
python tools/gen_workload.py workloads/big --profile uniform --rows 2000000 --relations 4 --queries 8 --batch 4 --keyspace 1048576 --seed 7 --cap 30000000
python tools/gen_workload.py workloads/bigdom --profile bigdom --rows 2000000 --relations 4 --queries 8 --batch 4 --keyspace 1048576 --seed 11 --cap 30000000
python tools/gen_workload.py workloads/zipfbig --profile zipfbig --rows 2000000 --relations 4 --queries 6 --batch 3 --keyspace 1048576 --seed 13 --cap 30000000
for w in scaled zipf big bigdom zipfbig; do
  (cd "workloads/$w" && sha1sum r[0-9]* > "$w.sha1")
done
