"""Hardware roofline baselines for the primitives the engines are built on.

The reference frames its leaf-insert microbenchmarks against memcpy and
reduce-distance rooflines (kdtree/src/cpp/benchmarks/
benchmark_insertion.cpp:253-274) so a kernel number can be read as a
fraction of what the hardware allows. This measures, on the GPU, the
primitives PERF.md's stage splits are scored against —

- device-memory copy bandwidth (the memcpy roofline),
- elementwise FMA + reduce throughput (bounds the subcell loop of the
  splat deposit and the kNN distance evaluation),
- multi-operand ``lax.sort`` rate (the splat class sort and the kNN tree
  build ride this),
- ``lax.top_k`` row rate (the kNN selection stage),
- XLA gather per-element cost (the kNN ladder's per-cell candidate fetch),
- float32 scatter-add per-element cost with random indices (the plain
  splat engine's accumulation; the deposit kernel's atomics are the same
  read-modify-write).

Every case runs ITERS iterations inside ONE jitted ``lax.fori_loop`` (with a
carried data dependency so XLA cannot dead-code or overlap them away),
synchronises with ``block_until_ready`` and divides by ITERS. Each case
runs a warmup call first so compile time never lands in the measurement.

Usage: python benchmarks/bench_roofline.py [--quick]
"""
from __future__ import annotations

import argparse
import time


def _sync(x):
    return x.block_until_ready()


def _make_loop(body, iters):
    """One jitted dispatch running ``body`` ``iters`` times with a carried
    dependency (the loop counter is never branched on: jax 0.9.0 has
    miscompiled compares on a fori_loop index)."""
    import jax
    from jax import lax

    def run(*args):
        def step(_, carry):
            return body(carry)

        return lax.fori_loop(0, iters, step, args)

    return jax.jit(run)


def _time(fn, *args, reps=3):
    """Best-of-reps wall time of fn(*args), synchronised."""
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn(*args)
        while isinstance(out, tuple):
            out = out[0]
        _sync(out)
        best = min(best, time.perf_counter() - t0)
    return best


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="smaller arrays (CPU-feasible smoke run)")
    ap.add_argument("--iters", type=int, default=10,
                    help="loop iterations inside each timed dispatch")
    args = ap.parse_args()
    iters = args.iters

    import jax
    import jax.numpy as jnp

    import jax.random as jr

    n = 2**22 if args.quick else 2**28  # 16 MiB / 1 GiB of f32
    rows = 2**12 if args.quick else 2**15  # 512 MiB candidate block max
    ncand = 2**12  # kNN candidate width per row (NRUNS*RCAP scale)
    print(f"backend={jax.default_backend()} n={n} rows={rows} iters={iters}")

    x = jr.normal(jr.key(0), (n,), jnp.float32)
    y = jr.normal(jr.key(1), (n,), jnp.float32)
    _sync(x), _sync(y)

    # 1. device-memory copy (memcpy roofline): read n + write n floats per iter.
    #    The +1.0 carried dependency forbids copy elision across iters.
    cp = _make_loop(lambda c: (c[0] + 1.0,), iters)
    cp(x)
    dt = _time(cp, x) / iters
    print(f"copy: {8 * n / dt / 1e9:.1f} GB/s (r+w)")

    # 2. FMA + reduce: read 2n, 2 flops/elem per iter;
    #    the scalar result is folded back into operand a as the carry
    red = _make_loop(
        lambda c: (c[0] + jnp.sum(c[0] * c[1], dtype=jnp.float32) * 1e-30,
                   c[1]),
        iters,
    )
    red(x, y)
    dt = _time(red, x, y) / iters
    print(f"fma_reduce: {8 * n / dt / 1e9:.1f} GB/s read, "
          f"{2 * n / dt / 1e9:.1f} Gflop/s")

    # 3. select+add chain (the deposit's inner op mix: compare, select,
    #    accumulate per subcell test). 8 chained per iter.
    def selacc(c):
        a, b = c
        for _ in range(8):
            a = a + jnp.where(a < b, a, b)
        return a * 0.25, b  # keep magnitudes bounded across iters

    sa = _make_loop(selacc, iters)
    sa(x, y)
    dt = _time(sa, x, y) / iters
    print(f"select_add: {8 * 3 * n / dt / 1e9:.1f} Gop/s (cmp+sel+add)")

    # 4. multi-operand sort by i32 key, 3 f32 payloads (the tree build's
    #    shape). The carried keys are
    #    re-decorrelated each iter (sorted input would flatter the rate).
    m = n // 4
    keys = jr.randint(jr.key(2), (m,), 0, 1 << 20, jnp.int32)

    def sortit(c):
        k, a, b, d = c
        out = jax.lax.sort((k, a, b, d), num_keys=1)
        k2 = out[0] * 1103515245 + 12345  # LCG rehash: unsorted again
        return (jnp.abs(k2) % (1 << 20), out[1], out[2], out[3])

    srt = _make_loop(sortit, iters)
    srt(keys, x[:m], y[:m], x[m : 2 * m])
    dt = _time(srt, keys, x[:m], y[:m], x[m : 2 * m]) / iters
    print(f"sort_mo4: {m / dt / 1e6:.1f} Mkeys/s "
          f"(i32 key + 3 f32 payloads)")

    # 5. top_k over candidate rows (the kNN selection stage); the row sums
    #    of the previous top-k perturb the next input as the carry
    d2 = jr.normal(jr.key(3), (rows, ncand), jnp.float32)

    def topkit(c):
        a = c[0]
        neg = jax.lax.top_k(-a, 16)[0]
        return (a + jnp.sum(neg, axis=1, keepdims=True) * 1e-30,)

    tk = _make_loop(topkit, iters)
    tk(d2)
    dt = _time(tk, d2) / iters
    print(f"top_k16: {dt / rows * 1e6:.2f} us/row over {ncand} candidates")

    # 6. gather per-element cost (why hot paths avoid it); indices are
    #    rehashed from the gathered values each iter
    ng = n // 16
    idx = jr.randint(jr.key(4), (ng,), 0, n, jnp.int32)

    def gatherit(c):
        a, i = c
        g = a[i]
        i2 = (i * 1103515245 + 12345) % n
        return a + jnp.sum(g) * 1e-30, jnp.abs(i2)

    ga = _make_loop(gatherit, iters)
    ga(x, idx)
    dt = _time(ga, x, idx) / iters
    print(f"gather: {dt / ng * 1e9:.2f} ns/element")

    # 7. scatter-add with random indices (float32 read-modify-write into
    #    a 1 GiB array, the plain splat engine's accumulation); indices are
    #    rehashed each iter
    def scatterit(c):
        a, i = c
        a = a.at[i].add(1e-30)
        i2 = (i * 1103515245 + 12345) % n
        return a, jnp.abs(i2)

    sc = _make_loop(scatterit, iters)
    sc(x, idx)
    dt = _time(sc, x, idx) / iters
    print(f"scatter_add: {dt / ng * 1e9:.2f} ns/element")


if __name__ == "__main__":
    main()
