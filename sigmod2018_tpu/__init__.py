"""sigmod2018_tpu — a vectorized multi-way equi-join engine on JAX/XLA.

A from-scratch JAX/XLA re-design of the SIGMOD-2018 contest multi-way
equi-join engine (reference: VagelisN/Sigmod-2018, C/pthreads).  The engine
speaks the contest's stdin protocol bit-exactly (reference: handler.c,
query.c) but executes every operator as a static-shape XLA program:

- storage/   columnar uint64 relations + per-column statistics
             (reference: relation_map.c)
- frontend/  query text -> typed IR  (reference: query.c:15-313, Parser.cpp)
- planner/   selectivity propagation + DP join enumeration
             (reference: stats.c, best_tree.c)
- ops/       device operators: filter compaction, gather, checksum,
             sort/searchsorted and key-table joins
             (reference: filter.c, rhjoin.c, preprocess.c)
- engine/    the query VM: dense row-id intermediate results + executor
             (reference: inter_res.c, query.c:325-467)
- parallel/  multi-device SPMD: mesh, hash-shuffle all_to_all, sharded join
             (reference: scheduler.c's thread pool, re-thought as SPMD)
- io/        stdin/stdout REPL driver (reference: handler.c)

uint64 columns and wrap-around checksums require 64-bit JAX types, so x64
mode is enabled at import, before any JAX computation runs.
"""

import os

import jax

jax.config.update("jax_enable_x64", True)

# Persistent compilation cache: the engine compiles one program per
# (operator, size-class) pair; caching across processes makes the contest's
# untimed prep phase absorb all compilation on reruns.  JAX reads
# JAX_COMPILATION_CACHE_DIR itself; only without it does the engine pick
# a fixed directory in the checkout (a fixed path keeps cache keys stable).
if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    jax.config.update(
        "jax_compilation_cache_dir",
        os.path.abspath(os.path.join(os.path.dirname(__file__), "..",
                                     ".jax_cache")))
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.1)

__version__ = "0.1.0"
