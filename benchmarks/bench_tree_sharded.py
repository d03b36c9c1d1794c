"""Sharded-tree overhead vs the replicated path on ONE device.

The slab-sharded tree (parallel/tree_sharded.py) exists to scale past one
device's memory; its cost model on a single device is what multi-device
projections build on. This bench builds the same point set both ways on
the GPU and reports build + query rates:

- replicated: `KDTree(points_jax).query_device` (the expanding-cube
  ladder)
- sharded(1): `build_tree_sharded` + `knn_query_tree_sharded` on a
  1-device mesh — every cross-shard mechanism (routing sort, shard rows,
  hop ladder bookkeeping) still runs, so replicated/sharded(1) is the
  pure overhead of the sharding machinery.

Usage: python benchmarks/bench_tree_sharded.py [n] [nq] [k]
Defaults match the PERF.md kNN workload (1e7 points, 5e5 self-queries,
k=16).
"""
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

def sync(x):
    return jnp.asarray(x).block_until_ready()


def main():
    n = int(float(sys.argv[1])) if len(sys.argv) > 1 else 10_000_000
    nq = int(float(sys.argv[2])) if len(sys.argv) > 2 else 500_000
    k = int(sys.argv[3]) if len(sys.argv) > 3 else 16

    import jax.random as jr

    from nbodyhpc_jax.kdtree import KDTree
    from nbodyhpc_jax.parallel.mesh import make_slab_mesh
    from nbodyhpc_jax.parallel.tree_sharded import (
        build_tree_sharded,
        knn_query_tree_sharded,
    )

    pts_d = jr.uniform(jr.key(99), (n, 3), jnp.float32)
    sync(pts_d)
    q_d = pts_d[:nq]

    # --- replicated production path ---
    best_b = best_q = float("inf")
    for _ in range(2):
        t0 = time.time()
        tree = KDTree(pts_d, boxsize=1.0)
        sync(tree._dev[2])
        best_b = min(best_b, time.time() - t0)
    for _ in range(3):
        t0 = time.time()
        dd, ii = tree.query_device(q_d, k=k)
        sync(dd[:, -1])
        best_q = min(best_q, time.time() - t0)
    print(f"replicated: build {best_b:.3f}s  query {nq / best_q:,.0f} q/s")

    # --- sharded tree on a 1-device mesh ---
    mesh = make_slab_mesh()
    pts_h = np.asarray(pts_d)  # build_tree_sharded partitions via numpy
    best_sb = best_sq = float("inf")
    for _ in range(2):
        t0 = time.time()
        st = build_tree_sharded(pts_h, boxsize=1.0, mesh=mesh)
        sync(st.offsets)
        best_sb = min(best_sb, time.time() - t0)
    for _ in range(3):
        t0 = time.time()
        ds, is_, ov = knn_query_tree_sharded(st, q_d, k)
        sync(ds[:, -1])
        best_sq = min(best_sq, time.time() - t0)
    assert ov == 0
    # cross-check a prefix
    assert np.array_equal(np.asarray(is_[:4096]), np.asarray(ii[:4096]))
    print(f"sharded(1): build {best_sb:.3f}s  query {nq / best_sq:,.0f} q/s"
          f"  (overhead vs replicated: query {best_sq / best_q:.2f}x)")


if __name__ == "__main__":
    main()
