"""Primitive-rate microbench on the device it runs on.

Rates measured, each as the median of several runs timed from dispatch
to `block_until_ready`, after one warm-up call:

  copy        u64 stream (the bandwidth sanity check)
  gather      random / 1K-block u32 and u64 gather
  scatter     random u32 scatter-add (histogram building block)
  sort        u64 single-operand and variadic (key + 2 payloads)
  cumsum      u64 prefix sum (prefix-table build rate)
  searchsorted method="sort" (the sort member's probe primitive)

Prints the device (JAX platform, kind, count; nvidia-smi name and power
limit where present) first, and a bandwidth share only for a device
kind listed in engine/trace.py's peak table.

Usage: python tools/microbench.py [log2_n]   (default 23)
"""

from __future__ import annotations

import statistics
import sys
import time

import numpy as np


def main() -> None:
    logn = int(sys.argv[1]) if len(sys.argv) > 1 else 23
    n = 1 << logn

    import sigmod2018_tpu  # noqa: F401 — x64 + compile cache
    import jax
    import jax.numpy as jnp

    from sigmod2018_tpu.engine.trace import peak_bytes_per_sec
    from sigmod2018_tpu.utils.device import card_name_and_power, jax_device

    dev = jax_device()
    peak = peak_bytes_per_sec(dev["kind"])
    print(f"# device {dev}; card {card_name_and_power()}; n = 2^{logn}")

    def devtime(f, *a, iters=5):
        jax.block_until_ready(f(*a))
        times = []
        for _ in range(iters):
            t0 = time.perf_counter()
            jax.block_until_ready(f(*a))
            times.append(time.perf_counter() - t0)
        return statistics.median(times)

    def rate(nbytes, t):
        s = f"{nbytes / t / 1e9:7.1f} GB/s"
        if peak is not None:
            s += f" ({nbytes / t / peak * 100:5.1f}% of peak)"
        return s

    rng = np.random.default_rng(0)
    x64 = jnp.asarray(rng.integers(0, 1 << 60, n, dtype=np.uint64))
    x32 = x64.astype(jnp.uint32)
    idx_rand = jnp.asarray(rng.permutation(n).astype(np.int32))
    # Blocked locality: random 1024-aligned blocks, sequential inside.
    blocks = rng.permutation(n // 1024).astype(np.int32)
    idx_block = jnp.asarray(
        (blocks[:, None] * 1024 + np.arange(1024, dtype=np.int32)).ravel())

    copy = jax.jit(lambda a: a + jnp.uint64(1))
    t = devtime(copy, x64)
    print(f"copy u64:            {t * 1e3:8.3f} ms  {rate(16 * n, t)}")

    gather = jax.jit(lambda a, i: a[i])
    for name, arr, bytes_row in (("u64", x64, 8), ("u32", x32, 4)):
        for iname, idx in (("random", idx_rand), ("1K-block", idx_block)):
            t = devtime(gather, arr, idx)
            print(f"gather {name} {iname:9s} {t * 1e3:8.3f} ms  "
                  f"{rate((2 * bytes_row + 4) * n, t)}")

    scat = jax.jit(lambda a, i: jnp.zeros_like(a).at[i].add(a))
    t = devtime(scat, x32, idx_rand)
    print(f"scatter-add u32:     {t * 1e3:8.3f} ms  {rate(12 * n, t)}")

    sort1 = jax.jit(lambda a: jax.lax.sort((a,), num_keys=1))
    t = devtime(sort1, x64)
    print(f"sort u64 x1:         {t * 1e3:8.3f} ms  "
          f"({n / t / 1e6:8.1f} Mrows/s)")

    sort3 = jax.jit(lambda a, b, c: jax.lax.sort((a, b, c), num_keys=1))
    t = devtime(sort3, x64, x64, x64)
    print(f"sort u64 +2 payload: {t * 1e3:8.3f} ms  "
          f"({n / t / 1e6:8.1f} Mrows/s)")

    cs = jax.jit(lambda a: jnp.cumsum(a))
    t = devtime(cs, x64)
    print(f"cumsum u64:          {t * 1e3:8.3f} ms  {rate(16 * n, t)}")

    skeys = jnp.sort(x64)
    ss = jax.jit(lambda s, q: jnp.searchsorted(s, q, method="sort"))
    t = devtime(ss, skeys, x64)
    print(f"searchsorted(sort):  {t * 1e3:8.3f} ms  "
          f"({n / t / 1e6:8.1f} Mrows/s)")


if __name__ == "__main__":
    main()
