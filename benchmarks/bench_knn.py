"""k-NN microbenchmarks, the analog of the reference's google-benchmark suite
(reference: kdtree/src/cpp/benchmarks/benchmark_build.cpp:128-148 sweeps tree
build over 2^20..2^24 points and 4 selection policies;
benchmark_insertion.cpp:253-274 measures leaf-scan throughput).

Here: cell-list build across occupancies (the selection-policy analog is the
occupancy/leafsize trade), and query throughput across k for the host-chunked
``query`` and the device-resident ``query_device``.

Usage: python benchmarks/bench_knn.py [--quick]
"""
from __future__ import annotations

import argparse
import time

import numpy as np


def bench_build(sizes, occupancies):
    from nbodyhpc_jax.core.cells import build_cell_list
    from nbodyhpc_jax.utils.philox import random_points

    print("== build (cell list) ==")
    for n in sizes:
        pts = random_points(int(n), seed=1)
        for occ in occupancies:
            t0 = time.perf_counter()
            build_cell_list(pts, occupancy=occ)
            dt = time.perf_counter() - t0
            print(f"  n={int(n):>9} occ={occ:>4}: {dt:.3f}s "
                  f"({n/dt/1e6:.2f} Mpts/s)")


def bench_query(n, nq, ks):
    import jax

    from nbodyhpc_jax.kdtree import KDTree
    from nbodyhpc_jax.ops import knn
    from nbodyhpc_jax.utils.philox import random_points

    print("== query ==")
    pts = random_points(int(n), seed=2)
    tree = KDTree(pts)
    q = pts[: int(nq)]
    qd = jax.numpy.asarray(q)
    for k in ks:
        knn.cell_knn_query(tree._tree, tree._dev, q[:4096], k)  # warm
        t0 = time.perf_counter()
        knn.cell_knn_query(tree._tree, tree._dev, q, k)
        dt = time.perf_counter() - t0
        print(f"  k={k:>3} query (numpy): {dt:.3f}s ({len(q)/dt:.0f} q/s)")
        tree.query_device(qd, k=k)[0].block_until_ready()  # warm
        t0 = time.perf_counter()
        tree.query_device(qd, k=k)[0].block_until_ready()
        dt = time.perf_counter() - t0
        print(f"  k={k:>3} query_device: {dt:.3f}s ({len(q)/dt:.0f} q/s)")


def bench_ball(n=1e7, nq=1e5, mean_count=32.0, parity_q=512):
    """Fixed-radius (ball) count throughput at BASELINE row-2 scale
    (1e7-point tree), radius sized for ~``mean_count`` neighbors per query
    — the regime of kNN-CDF / correlation statistics. scipy
    ``query_ball_point`` parity on a subset is asserted before timing
    (reference prune analog: kdtree_impl.hpp:239-267)."""
    import jax
    import jax.numpy as jnp

    from nbodyhpc_jax.kdtree import KDTree
    from nbodyhpc_jax.utils.philox import random_points

    print("== ball count (radius queries) ==")
    n, nq = int(n), int(nq)
    pts = random_points(n, seed=5)
    r = float((mean_count * 3.0 / (4.0 * np.pi * n)) ** (1.0 / 3.0))
    tree = KDTree(pts, boxsize=1.0)
    q = pts[:nq]

    from scipy.spatial import cKDTree

    sub = min(parity_q, nq)
    ref = cKDTree(pts, boxsize=1.0).query_ball_point(
        q[:sub], r, return_length=True
    )
    got = tree.query_radius_count(q[:sub], r)
    np.testing.assert_array_equal(got, ref)
    print(f"  scipy parity OK on {sub} queries "
          f"(r={r:.4g}, mean count {ref.mean():.1f})")

    tree.query_radius_count(q[: min(8192, nq)], r)  # warm compiles
    t0 = time.perf_counter()
    cnt = tree.query_radius_count(q, r)
    dt = time.perf_counter() - t0
    print(f"  n={n:.0e} nq={nq:.0e}: {dt:.3f}s ({nq / dt:,.0f} q/s, "
          f"mean count {cnt.mean():.1f})")
    return nq / dt


def bench_roofline(nbytes=1 << 28, rows=1 << 16, cands=512, reps=5):
    """Device rooflines framing the query numbers, the analog of the
    reference's Memcpy / ReduceDistance baselines
    (benchmark_insertion.cpp:253-274): (a) device-memory copy bandwidth, (b) the
    leaf-scan kernel's idealized form — per row, evaluate ``cands``
    squared distances and reduce to the min — which bounds any candidate
    scan at this (rows, candidates) shape."""
    import jax
    import jax.numpy as jnp

    print("== rooflines ==")
    x = jnp.zeros(nbytes // 4, jnp.float32)
    copy = jax.jit(lambda a: a + 1.0)
    copy(x).block_until_ready()  # warm
    t0 = time.perf_counter()
    for _ in range(reps):
        x = copy(x)
    x.block_until_ready()
    dt = (time.perf_counter() - t0) / reps
    # read + write
    print(f"  memcpy-analog: {2 * nbytes / dt / 1e9:.1f} GB/s")

    rng = np.random.Generator(np.random.Philox(9))
    qv = jnp.asarray(rng.random((rows, 3), dtype=np.float32))
    cv = jnp.asarray(rng.random((cands, 3), dtype=np.float32))

    @jax.jit
    def reduce_distance(qv, cv):
        d = qv[:, None, :] - cv[None, :, :]
        return jnp.min(jnp.sum(d * d, axis=-1), axis=1)

    reduce_distance(qv, cv).block_until_ready()
    t0 = time.perf_counter()
    for _ in range(reps):
        reduce_distance(qv, cv).block_until_ready()
    dt = (time.perf_counter() - t0) / reps
    visited = rows * cands
    print(
        f"  reduce-distance ({rows}x{cands}): {dt * 1e3:.2f} ms = "
        f"{visited / dt / 1e9:.2f} G candidate-dists/s "
        f"(~{visited * 8 / dt / 1e12:.2f} Tflop/s)"
    )


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    args = ap.parse_args()
    if args.quick:
        bench_roofline(nbytes=1 << 24, rows=1 << 10, cands=128, reps=2)
        bench_build([1e5], [8.0])
        bench_query(1e5, 2e4, [8])
        bench_ball(1e5, 1e4)
    else:
        bench_roofline()
        bench_build([2**20, 2**22, 2**24], [4.0, 8.0, 16.0, 32.0])
        bench_query(1e7, 5e5, [1, 8, 16])
        bench_ball()


if __name__ == "__main__":
    main()
