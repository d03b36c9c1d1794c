"""Splat microbenchmarks: deposition throughput across radius regimes and
grid sizes, for each engine (the analog of the reference's leaf-insert
roofline suite, kdtree/src/cpp/benchmarks/benchmark_insertion.cpp:253-274,
applied to the rasterizer's hot loop).

Usage: python benchmarks/bench_splat.py [--quick] [--engine kernel|plain|auto]
"""
from __future__ import annotations

import argparse
import time

import numpy as np


def bench(n, grid, rpx_lo, rpx_hi, label, engine):
    import jax.numpy as jnp

    from nbodyhpc_jax.ops import deposit

    n = int(n)
    ppu = float(grid)
    rng = np.random.Generator(np.random.Philox(3))
    pos = jnp.asarray(rng.random((n, 3), dtype=np.float32))
    w = jnp.ones(n, jnp.float32)
    r = jnp.asarray(
        (rpx_lo + rng.random(n).astype(np.float32) * (rpx_hi - rpx_lo)) / ppu
    )

    def render():
        return deposit.splat_volume(pos, w, r, ppu, (grid,) * 3,
                                    engine=engine).block_until_ready()

    render()  # compile
    t0 = time.perf_counter()
    vol = render()
    dt = time.perf_counter() - t0
    total = float(jnp.sum(vol))
    print(f"  {label}: {dt:.3f}s ({n / dt / 1e6:.2f} Mparticles/s, "
          f"mass {total / n:.4f})")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--engine", default="auto", choices=("auto", "kernel", "plain"))
    args = ap.parse_args()
    print(f"== splat deposition (engine={args.engine}) ==")
    if args.quick:
        bench(1e6, 128, 0.1, 0.4, "1e6 subpixel 128^3", args.engine)
        bench(1e6, 128, 1.0, 3.0, "1e6 1-3 px 128^3", args.engine)
    else:
        bench(1e7, 512, 0.1, 0.4, "1e7 subpixel 512^3", args.engine)
        bench(1e7, 512, 1.0, 3.0, "1e7 1-3 px 512^3", args.engine)
        bench(1e7, 512, 3.1, 7.0, "1e7 3-7 px 512^3", args.engine)
        bench(1e8, 1024, 1.0, 3.0, "1e8 1-3 px 1024^3", args.engine)


if __name__ == "__main__":
    main()
