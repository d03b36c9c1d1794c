"""Benchmark of the two main paths on one NVIDIA GPU.

    python bench.py [--engine auto|kernel|plain] [--seed N] [--knn-trace DIR]

Splat: the reference's CAMELS shape (rasterization/README.md:27-31) —
16,777,216 particles uniform in the unit box, unit weights, radii lognormal
(sigma 0.35, unclipped above) around the 4 px mean spacing, rendered
periodic into 1024^3 at subsample 4 through the device-resident engine.
Periodic ghost augmentation runs before the timed region, as the
reference's CPU pre-processing does before its 2.5 s (RTX 6000) headline;
the timed render includes the class sort. ``vs_baseline`` is particles/s
over that reference's 6.7e6/s. The rendered mass is audited against the
footprint integral of a sample (reference main.cpp:124-131).

kNN: a 1e7-point periodic tree built from device points, 5e5 self-queries
at k=16 through ``query_device`` (reference harness kdtree/src/cpp/
main.cpp:130-174); self-distances must be exactly 0. ``--knn-trace DIR``
also profiles one warm query pass and prints the device time by operation.

Each result is one JSON line on stdout carrying the card's name and power
limit; times are best of three warm runs.
"""
import argparse
import json
import subprocess
import sys
import time

REF_PARTICLES_PER_S = 1.68e7 / 2.5  # reference rasterizer, RTX 6000
REF_KNN_QPS = 165959.0  # reference kdtree binary, one CPU core (BASELINE.md)


def _card():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=False,
    ).stdout.strip().splitlines()
    return out[0] if out else "unknown"


def _best(fn, reps=3):
    fn()  # compile + warm
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def bench_splat(jax, jnp, np, seed, engine):
    from nbodyhpc_jax.ops import deposit
    from nbodyhpc_jax.ops.ghosts import augment_points_periodic_device
    from nbodyhpc_jax.utils.workloads import camels_particles, expected_mass_ratio

    n, grid = 256**3, 1024
    pos, w, r = camels_particles(jax.random.key(seed), n, grid)
    audit = expected_mass_ratio(np.asarray(pos[:8192]) * grid,
                                np.asarray(r[:8192]) * grid)
    gp, gw, gr = augment_points_periodic_device(pos, w, r, (1.0, 1.0, 1.0),
                                                pad_ok=True)
    del pos, w, r
    vol = None

    def render():
        nonlocal vol
        vol = None
        vol = deposit.splat_volume(gp, gw, gr, float(grid), (grid,) * 3,
                                   engine=engine).block_until_ready()

    t = _best(render)
    ratio = float(jnp.sum(vol)) / n
    if abs(ratio - audit) > 3e-3:
        raise AssertionError(f"mass ratio {ratio} vs expected {audit}")
    return {
        "metric": "splat_camels_16.8M_1024^3_periodic",
        "value": n / t / 1e6, "unit": "Mparticles/s",
        "vs_baseline": n / t / REF_PARTICLES_PER_S, "elapsed_s": t,
        "engine": deposit.resolve_engine(engine),
        "mass_ratio": ratio, "mass_ratio_expected": audit,
    }


def bench_knn(jax, jnp, np, seed, trace_dir=None):
    from nbodyhpc_jax.kdtree import KDTree

    n, nq, k = 10_000_000, 500_000, 16
    pts = jax.random.uniform(jax.random.key(seed + 1), (n, 3), jnp.float32)
    tree = None

    def build():
        nonlocal tree
        tree = KDTree(pts, boxsize=1.0)
        tree._dev[2].block_until_ready()

    t_build = _best(build)
    q = pts[:nq]
    out = None

    def query():
        nonlocal out
        out = tree.query_device(q, k=k)
        out[0].block_until_ready()

    t_query = _best(query)
    if float(jnp.max(out[0][:, 0])) != 0.0:
        raise AssertionError("self-query nearest distance != 0")
    result = {
        "metric": "knn_1e7_tree_5e5_selfqueries_k16_device",
        "value": nq / t_query, "unit": "queries/s",
        "vs_baseline": nq / t_query / REF_KNN_QPS,
        "query_s": t_query, "build_s": t_build,
    }
    if trace_dir:
        result["trace_top_ops_ms"] = _trace_ops(jax, query, trace_dir)
    return result


def _trace_ops(jax, fn, trace_dir, top=20):
    """Device time by operation name over one profiled call, in ms."""
    import glob
    import os

    with jax.profiler.trace(trace_dir):
        fn()
    path = max(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                         recursive=True), key=os.path.getmtime)
    prof = jax.profiler.ProfileData.from_file(path)
    totals = {}
    for plane in prof.planes:
        if plane.name.startswith("/device:GPU"):
            for line in plane.lines:
                for ev in line.events:
                    totals[ev.name] = totals.get(ev.name, 0.0) + ev.duration_ns / 1e6
    ranked = sorted(totals.items(), key=lambda kv: -kv[1])[:top]
    return {name: round(ms, 3) for name, ms in ranked}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--engine", default="auto", choices=("auto", "kernel", "plain"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--knn-trace", default=None, metavar="DIR")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import numpy as np

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"no GPU: JAX sees {dev.platform}", file=sys.stderr)
        return 2
    card = {"card": _card(), "device_kind": dev.device_kind}
    for fn in (lambda: bench_splat(jax, jnp, np, args.seed, args.engine),
               lambda: bench_knn(jax, jnp, np, args.seed, args.knn_trace)):
        print(json.dumps({**fn(), **card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
