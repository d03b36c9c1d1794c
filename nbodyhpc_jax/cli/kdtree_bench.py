"""k-NN benchmark/validation CLI, mirroring the reference ``kdtree_main``.

Reference behavior (kdtree/src/cpp/main.cpp:51-175): generate Philox-seeded
random points (or load a raw float3 file), build the tree, self-query the
first ``num-queries`` points (distance to self must be 0), and report build
time, query time, queries/s, and the fraction of points visited per query.

Usage: ``python -m nbodyhpc_jax.cli.kdtree_bench --num-points 1e7 ...``
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--num-points", type=float, default=1e7)
    ap.add_argument("--num-neighbors", "-k", type=int, default=16)
    ap.add_argument("--num-queries", type=float, default=5e5)
    ap.add_argument("--leaf-size", type=int, default=128)
    ap.add_argument("--periodic", action="store_true")
    ap.add_argument("--box-size", type=float, default=1.0)
    ap.add_argument("--file", type=str, default=None,
                    help="raw float32 x,y,z triples (reference main.cpp:103-114)")
    ap.add_argument("--seed", type=int, default=42)
    args = ap.parse_args(argv)

    from ..kdtree import KDTree
    from ..utils.philox import random_points

    if args.file:
        pts = np.fromfile(args.file, dtype=np.float32).reshape(-1, 3)
    else:
        pts = random_points(int(args.num_points), args.seed, args.box_size)
    nq = min(int(args.num_queries), len(pts))
    print(f"points: {len(pts)}  queries: {nq}  k: {args.num_neighbors}")

    t0 = time.perf_counter()
    tree = KDTree(pts, leafsize=args.leaf_size,
                  boxsize=args.box_size if args.periodic else None)
    t_build = time.perf_counter() - t0
    print(f"build: {t_build:.3f} s ({len(pts)/t_build/1e6:.2f} Mpts/s)")

    # warm-up with the EXACT query the timed run repeats: the engine picks
    # its chunk shapes from Q, so a smaller warm-up would leave the timed
    # run to compile inside the timed region
    tree.query(pts[:nq], k=args.num_neighbors)

    t0 = time.perf_counter()
    dist, idx = tree.query(pts[:nq], k=args.num_neighbors)
    t_query = time.perf_counter() - t0

    # the reference validates d(p, p) == 0 (main.cpp:69-82) — by DISTANCE,
    # not index: with duplicate points the zero-distance neighbor may
    # legitimately be the duplicate's index
    self_ok = bool(np.all(dist[:, 0] == 0.0))
    # work statistics on a sample (stats now ride the kernel fast path too;
    # the sample just keeps the extra pass cheap)
    _, _, stats = tree.query_with_statistics(
        pts[: min(4096, nq)], k=args.num_neighbors
    )
    visited = float(stats.points_visited.mean()) / len(pts) * 100.0
    pruned = float(stats.cells_pruned.mean()) / max(tree._tree.ncells, 1) * 100.0
    print(f"query: {t_query:.3f} s -> {nq/t_query:.0f} q/s")
    print(f"self-query exact: {self_ok}")
    print(f"% points visited: {visited:.4f}")
    print(f"% cells pruned: {pruned:.2f}")
    return 0 if self_ok else 1


if __name__ == "__main__":
    sys.exit(main())
