"""Catalog: the set of loaded relations + per-column statistics.

The reference's relation_map (relation_map.c:13-98) mmaps every file and
computes per-column stats in three host passes: min/max scan, then a capped
boolean-array distinct count (relation_map.c:52-83; the cap/fold quirk there
makes d an estimate).  Here stats are computed vectorized — NumPy on host by
default, or the optional native C++ loader (storage/native) which overlaps
mmap + stats across threads.  Distinct counts are exact (sort-unique): stats
feed only the planner, so better estimates only improve plans and cannot
affect result correctness.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np

from .relation import Relation, load_relation


@dataclasses.dataclass
class ColumnStats:
    """l/u = min/max value, f = row count, d = distinct count
    (reference: structs.h:120-126), plus a 1-bucket MCV sketch the
    reference lacks: fmax = multiplicity of the most common value, mode =
    that value.  The sketch exists because the reference's span-based
    equi-join estimate (stats.c:212-234) under-predicts Zipf hot-key
    fanout by orders of magnitude, steering the DP into plans with
    billion-row intermediates."""

    l: int
    u: int
    f: int
    d: int
    fmax: int = 1
    mode: int = 0

    def copy(self) -> "ColumnStats":
        return ColumnStats(self.l, self.u, self.f, self.d, self.fmax,
                           self.mode)


def compute_column_stats(col: np.ndarray, exact_distinct: bool = True) -> ColumnStats:
    n = int(col.shape[0])
    if n == 0:
        return ColumnStats(0, 0, 0, 0)
    cmin = int(col.min())
    cmax = int(col.max())
    if exact_distinct:
        uniq, counts = np.unique(col, return_counts=True)
        d = int(uniq.size)
        top = int(np.argmax(counts))
        fmax, mode = int(counts[top]), int(uniq[top])
    else:
        # cheap estimate: distinct <= min(n, value range)
        d = min(n, cmax - cmin + 1)
        fmax, mode = max(1, n // max(d, 1)), cmin
    return ColumnStats(cmin, cmax, n, d, fmax, mode)


# ---------------------------------------------------------------------------
# Prep-artifact cache (SURVEY §5 checkpoint/resume row): the untimed prep
# phase's expensive artifact is the per-column exact stats + MCV sketch.
# Cache them on disk keyed by the init file list's identity (path basename
# + size + mtime per file), so a re-serve of the same relation set skips
# the full stats scan.  Relations themselves stay mmap'd (already lazy).
# Stats feed only the planner, and staleness is guarded by the size+mtime
# key — a stale hit can only happen if a file is rewritten bytes-and-
# mtime-identically, in which case its stats are identical anyway.
# Disable with S18_PREP_CACHE=0; S18_PREP_CACHE=<dir> relocates it.
# ---------------------------------------------------------------------------

_STAT_FIELDS = ("l", "u", "f", "d", "fmax", "mode")


def identity_digest(paths: Sequence[str]):
    """Identity of a relation set: sha1 over (basename, size, mtime_ns)
    per file.  Keys every prep artifact (stats cache here, learned size
    classes in engine/compiled.py).  None when any file is unstatable."""
    import hashlib
    import os

    h = hashlib.sha1()
    try:
        for p in paths:
            st = os.stat(p)
            h.update(f"{os.path.basename(p)}:{st.st_size}:"
                     f"{st.st_mtime_ns}\n".encode())
    except OSError:
        return None
    return h.hexdigest()


def prep_cache_dir():
    """Directory for prep artifacts, or None when disabled
    (S18_PREP_CACHE=0; S18_PREP_CACHE=<dir> relocates)."""
    import os

    loc = os.environ.get("S18_PREP_CACHE", "")
    if loc == "0":
        return None
    return loc or os.path.join(os.path.expanduser("~"), ".cache",
                               "sigmod2018_tpu")


def _stats_cache_path(paths: Sequence[str]):
    import os

    base = prep_cache_dir()
    digest = identity_digest(paths) if base else None
    if digest is None:
        return None
    return os.path.join(base, f"stats-{digest}.npz")


def _stats_cache_load(paths: Sequence[str]):
    import numpy as _np

    fp = _stats_cache_path(paths)
    if fp is None:
        return None
    try:
        with _np.load(fp) as z:
            ncols = z["ncols"]
            flat = {f: z[f] for f in _STAT_FIELDS}
    except (OSError, KeyError, ValueError):
        return None
    stats, k = [], 0
    for nc in ncols:
        stats.append([ColumnStats(*(int(flat[f][k + c])
                                    for f in _STAT_FIELDS))
                      for c in range(int(nc))])
        k += int(nc)
    return stats


def _stats_cache_store(paths: Sequence[str], stats) -> None:
    import os
    import tempfile

    import numpy as _np

    fp = _stats_cache_path(paths)
    if fp is None:
        return
    # uint64: l/u/mode are key values and may exceed int64
    flat = {f: _np.array([getattr(s, f) for rel in stats for s in rel],
                         dtype=_np.uint64) for f in _STAT_FIELDS}
    try:
        os.makedirs(os.path.dirname(fp), exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(fp), suffix=".npz")
        with os.fdopen(fd, "wb") as fh:
            _np.savez(fh, ncols=_np.array([len(r) for r in stats]), **flat)
        os.replace(tmp, fp)  # atomic: concurrent servers race benignly
    except OSError:
        pass


class Catalog:
    """All loaded relations, indexed by relation id (file order on stdin)."""

    def __init__(self, relations: Sequence[Relation], compute_stats: bool = True):
        self.relations: List[Relation] = list(relations)
        self.stats: List[List[ColumnStats]] = []
        self.source_paths: List[str] = []
        if compute_stats:
            self._compute_stats()

    @staticmethod
    def from_files(paths: Sequence[str], compute_stats: bool = True) -> "Catalog":
        cached = _stats_cache_load(paths) if compute_stats else None
        if cached is not None:
            cat = Catalog.__new__(Catalog)
            cat.relations = [load_relation(p) for p in paths]  # mmap only
            cat.stats = cached
            cat.source_paths = list(paths)
            return cat
        try:
            from .native import load_relations_native

            rels = load_relations_native(paths)
            if rels is not None:
                cat = Catalog.__new__(Catalog)
                cat.relations = [r for r, _ in rels]
                cat.stats = [s for _, s in rels]
                cat.source_paths = list(paths)
                _stats_cache_store(paths, cat.stats)
                return cat
        except ImportError:
            pass
        cat = Catalog([load_relation(p) for p in paths],
                      compute_stats=compute_stats)
        cat.source_paths = list(paths)
        if compute_stats:
            _stats_cache_store(paths, cat.stats)
        return cat

    def _compute_stats(self) -> None:
        self.stats = [
            [compute_column_stats(col) for col in rel.columns]
            for rel in self.relations
        ]

    def relation(self, rid: int) -> Relation:
        return self.relations[rid]

    def column(self, rid: int, cid: int) -> np.ndarray:
        return self.relations[rid].columns[cid]

    def dense_column(self, rid: int, cid: int) -> np.ndarray:
        """The column as a materialized in-memory array, cached.

        Base columns are np.memmap views; NumPy fancy indexing through
        a memmap goes via its Python __getitem__ with extra copies —
        most of the host oracle's small-workload pass was memmap
        gathers.  The host serving tiers (warm-up oracle,
        poisoned-device last resort, factorized NumPy twin) gather per
        query, so one materialization pays for itself immediately.
        In-memory relations pass through without a copy."""
        cache = self.__dict__.setdefault("_dense_columns", {})
        key = (rid, cid)
        hit = cache.get(key)
        if hit is None:
            raw = self.relations[rid].columns[cid]
            if isinstance(raw, np.memmap):
                # np.ascontiguousarray on a contiguous memmap returns a
                # VIEW — force the copy into an anonymous array.
                hit = np.array(raw, dtype=raw.dtype, copy=True)
            else:
                hit = np.ascontiguousarray(raw)
            cache[key] = hit
        return hit

    def column_stats(self, rid: int, cid: int) -> ColumnStats:
        return self.stats[rid][cid]

    def __len__(self) -> int:
        return len(self.relations)
