#!/usr/bin/env python3
"""Smoke run of the main paths on an NVIDIA GPU, at the reference's sizes.

    python chip_smoke.py [--seed N]      # one card: splat + kNN + gpu tests
    python chip_smoke.py --chips 4       # four cards: the sharded paths only

One card:

1. Splat at the CAMELS shape (reference rasterization/README.md:27-31):
   16,777,216 particles uniform in the unit box, unit weights, radii
   lognormal (sigma 0.35) around the 4 px mean spacing, periodic, 1024^3,
   subsample 4 — once through the public ``render_points_volume`` (numpy
   in and out) and once through the device-resident engine, each with the
   deposit kernel and with the plain engine. Gates: the mass audit against
   the footprint integral, and kernel vs plain on the full grid.
2. Both engines against the oracle (``ops.splat.splat_volume_oracle``) on a
   200,000-particle 256^3 sub-problem that fills every radius class.
3. kNN: a 1e7-point periodic tree built from a device array; 5e5
   self-queries at k=16 through ``query_device`` and 1e5 through ``query``;
   self-distance exactly 0; 2,000 queries against ``brute_force_knn`` on
   the card and scipy's cKDTree on the host.
4. The tests marked ``gpu``.

``--chips 4``: the 1024^3 render over 4 z-slabs against the one-card
render, and the sharded tree and the query-sharded replicated tree against
the one-card ladder.

Data comes from ``--seed``. Every phase prints its wall time (first call,
which compiles, and a second warm call), ``peak_bytes_in_use`` and each
residual beside its tolerance. The last line is one JSON object; the exit
code is non-zero, with no JSON line, when JAX finds no GPU or any phase
fails.
"""
import argparse
import json
import os
import subprocess
import sys
import time
import traceback

N_SPLAT = 256**3          # CAMELS: 256^3 particles ...
GRID = 1024               # ... into 1024^3
SUBSAMPLE = 4
N_ORACLE, GRID_ORACLE = 200_000, 256
N_KNN, Q_DEVICE, Q_HOST, K = 10_000_000, 500_000, 100_000, 16
N_CHECK = 2000            # queries checked against brute force and scipy


def _timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def _twice(label, fn):
    """Run ``fn`` cold then warm; print both wall times."""
    out, cold = _timed(fn)
    del out
    out, warm = _timed(fn)
    print(f"  {label}: first {cold:.3f} s (compile ~{max(cold - warm, 0):.3f} s), "
          f"warm {warm:.3f} s")
    return out, warm


def _check(name, value, tol):
    ok = value <= tol
    print(f"  {name}: {value:.6g} (tolerance {tol:.6g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} {value!r} beyond {tol!r}")


def _peak(jax):
    stats = jax.devices()[0].memory_stats() or {}
    print(f"  peak_bytes_in_use: {stats.get('peak_bytes_in_use', 'n/a')}")


def _parity(name, got, want, quantum):
    """Gate two renders of one particle set (see ``field_parity``)."""
    from nbodyhpc_jax.utils.workloads import field_parity

    p = field_parity(got, want, quantum)
    print(f"  {name}: max-abs {p['max_abs']:.6g} (field max {p['scale']:.6g}), "
          f"rel-L2 {p['rel_l2']:.6g} (tolerance 1e-4), voxels past round-off "
          f"{p['flips']} = {p['flip_frac']:.3g} (tolerance 1e-4), worst past "
          f"round-off {p['worst_over_roundoff']:.6g} (tolerance one subcell "
          f"quantum {quantum:.6g}) {'ok' if p['ok'] else 'FAIL'}")
    if not p["ok"]:
        raise AssertionError(f"{name}: {p}")


def phase_splat(jax, jnp, np, seed):
    from nbodyhpc_jax.ops import deposit
    from nbodyhpc_jax.ops.ghosts import augment_points_periodic_device
    from nbodyhpc_jax.rasterizer import render_points_volume
    from nbodyhpc_jax.utils.workloads import (
        camels_particles,
        expected_mass_ratio,
        subcell_quantum,
    )

    pos, w, r = camels_particles(jax.random.key(seed), N_SPLAT, GRID)
    ns = 8192
    audit = expected_mass_ratio(np.asarray(pos[:ns]) * GRID,
                                np.asarray(r[:ns]) * GRID, SUBSAMPLE)
    print(f"  expected mass ratio (footprint integral, {ns} samples): {audit:.6f}")

    # public API: numpy in, numpy (F-order) out, periodic via host ghosts
    pos_h, w_h, r_h = (np.asarray(a) for a in (pos, w, r))
    vol_h, _ = _twice("render_points_volume (numpy, periodic)",
                      lambda: render_points_volume(pos_h, w_h, r_h, float(GRID),
                                                   GRID, periodic=True))
    assert vol_h.shape == (GRID,) * 3 and vol_h.flags["F_CONTIGUOUS"]
    ratio_h = float(vol_h.sum(dtype=np.float64)) / N_SPLAT
    _check("public mass ratio - expected", abs(ratio_h - audit), 3e-3)
    del vol_h, pos_h, w_h, r_h

    # device-resident engine, both engines on the same augmented set
    gp, gw, gr = augment_points_periodic_device(pos, w, r, (1.0, 1.0, 1.0),
                                                pad_ok=True)
    print(f"  particles after periodic ghosts: {gp.shape[0]}")
    fields = {}
    for engine in ("kernel", "plain"):
        def render(engine=engine):
            v = deposit.splat_volume(gp, gw, gr, float(GRID), (GRID,) * 3,
                                     SUBSAMPLE, engine=engine)
            return v.block_until_ready()
        vol, t = _twice(f"device engine={engine}", render)
        print(f"  engine={engine}: {N_SPLAT / t / 1e6:.3f} Mparticles/s warm")
        fields[engine] = vol
        ratio = float(jnp.sum(vol, dtype=jnp.float32)) / N_SPLAT
        _check(f"{engine} mass ratio - expected", abs(ratio - audit), 3e-3)
    quantum = subcell_quantum(gw[:N_SPLAT], gr[:N_SPLAT] * GRID, SUBSAMPLE)
    _parity("kernel vs plain (full grid)", fields["kernel"], fields["plain"],
            quantum)
    _peak(jax)


def phase_oracle(jax, jnp, np, seed):
    from nbodyhpc_jax.ops import deposit
    from nbodyhpc_jax.ops.splat import splat_volume_oracle
    from nbodyhpc_jax.utils.workloads import subcell_quantum

    n, ppu = N_ORACLE, float(GRID_ORACLE)
    grid = (GRID_ORACLE,) * 3
    rng = np.random.Generator(np.random.Philox(seed))
    pos = rng.random((n, 3), dtype=np.float32)
    w = (rng.random(n) + 0.5).astype(np.float32)
    rpx = np.exp(rng.normal(0.0, 0.35, n)) * (ppu / n ** (1 / 3))
    # every class, the dense tail included, gets at least 16 particles
    edges = (0.0,) + deposit.CLASS_HALF + (deposit.CLASS_HALF[-1] + 10.0,)
    for c in range(len(edges) - 1):
        rpx[16 * c:16 * c + 16] = np.linspace(edges[c] + 0.05, edges[c + 1] - 0.01, 16)
    r = (rpx / ppu).astype(np.float32)
    counts, _ = deposit.class_counts(r * ppu, w)
    print(f"  class counts: {counts}")
    assert min(counts) >= 16

    # the oracle is linear in the particles: render it class by class so
    # each call sizes its window from its own largest radius
    cls = np.asarray(deposit.radius_class(jnp.asarray(r * ppu), jnp.asarray(w)))
    t0 = time.perf_counter()
    want = np.zeros(grid, np.float32)
    for c in range(deposit.DENSE + 1):
        m = cls == c
        F = 2 * int(np.ceil(rpx[m].max())) + 7
        want += splat_volume_oracle(pos[m], w[m], r[m], ppu, grid,
                                    chunk=max(256, (1 << 24) // F**3))
    print(f"  oracle: {time.perf_counter() - t0:.3f} s")
    quantum = subcell_quantum(w, rpx, SUBSAMPLE)
    for engine in ("kernel", "plain"):
        got, _ = _twice(f"engine={engine}",
                        lambda e=engine: deposit.splat_volume(
                            pos, w, r, ppu, grid, SUBSAMPLE, engine=e
                        ).block_until_ready())
        _parity(f"{engine} vs oracle", got, want, quantum)
    _peak(jax)


def _check_knn(np, name, d, i, rd, ri, pts_h, q_h):
    """Distances within rtol 1e-6 of the reference's; an index may differ
    only where its own (min-image) distance ties the reference's."""
    rel = float(np.max(np.abs(d - rd) / np.maximum(rd, 1e-30)))
    _check(f"distances vs {name} (max rel)", rel, 1e-6)
    bad = i != ri
    print(f"  {name}: {int(bad.sum())} index mismatches")
    if bad.any():
        delta = np.abs(pts_h[i[bad].astype(np.int64)] - q_h[np.nonzero(bad)[0]])
        own = np.linalg.norm(np.minimum(delta, 1.0 - delta), axis=1)
        tie = float(np.max(np.abs(own - rd[bad]) / np.maximum(rd[bad], 1e-30)))
        _check(f"mismatched indices tie vs {name} (max rel)", tie, 1e-6)


def phase_knn(jax, jnp, np, seed):
    from scipy.spatial import cKDTree

    from nbodyhpc_jax.kdtree import KDTree
    from nbodyhpc_jax.ops.knn import brute_force_knn

    kp, kq = jax.random.split(jax.random.key(seed + 1))
    pts = jax.random.uniform(kp, (N_KNN, 3), jnp.float32)
    tree, _ = _twice("KDTree build (device points)",
                     lambda: _built(KDTree(pts, boxsize=1.0)))
    q = pts[:Q_DEVICE]
    (d, i), t = _twice(f"query_device {Q_DEVICE} self-queries k={K}",
                       lambda: _ready(tree.query_device(q, k=K)))
    print(f"  query_device: {Q_DEVICE / t:.1f} queries/s warm")
    _check("query_device self-distance", float(jnp.max(d[:, 0])), 0.0)
    q_host = np.asarray(pts[:Q_HOST])
    (dh, ih), t = _twice(f"query (numpy) {Q_HOST} self-queries k={K}",
                         lambda: tree.query(q_host, k=K))
    print(f"  query: {Q_HOST / t:.1f} queries/s warm")
    _check("query self-distance", float(dh[:, 0].max()), 0.0)

    # half self-queries, half fresh points
    half = N_CHECK // 2
    qc = jnp.concatenate([pts[:half], jax.random.uniform(kq, (half, 3), jnp.float32)])
    dc, ic = (np.asarray(a) for a in tree.query_device(qc, k=K))
    brute = jax.jit(lambda p, qq: brute_force_knn(p, qq, K, box=(1.0, 1.0, 1.0)))
    bd, bi = zip(*(brute(pts, qc[s:s + 50]) for s in range(0, N_CHECK, 50)))
    bd, bi = np.concatenate(bd), np.concatenate(bi)
    pts_h, qc_h = np.asarray(pts, np.float64), np.asarray(qc, np.float64)
    sd, si = cKDTree(pts_h, boxsize=1.0).query(qc_h, k=K, workers=-1)
    _check_knn(np, "brute_force_knn", dc, ic, bd, bi, pts_h, qc_h)
    _check_knn(np, "scipy cKDTree", dc, ic, sd, si, pts_h, qc_h)
    _peak(jax)


def _built(tree):
    tree._dev[2].block_until_ready()
    return tree


def _ready(out):
    return [a.block_until_ready() for a in out]


def phase_gpu_tests(jax, jnp, np, seed):
    import pytest

    os.environ["NBODYHPC_TEST_DEVICE"] = "gpu"
    root = os.path.dirname(os.path.abspath(__file__))
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      "-p", "no:xdist", os.path.join(root, "tests")])
    if rc != 0:
        raise AssertionError(f"gpu-marked tests failed (pytest exit {rc})")


def phase_sharded(jax, jnp, np, seed):
    from nbodyhpc_jax.kdtree import KDTree
    from nbodyhpc_jax.ops import deposit
    from nbodyhpc_jax.ops.ghosts import augment_points_periodic_device
    from nbodyhpc_jax.parallel.sharded import (
        knn_query_sharded,
        render_points_volume_sharded,
    )
    from nbodyhpc_jax.parallel.tree_sharded import (
        build_tree_sharded,
        knn_query_tree_sharded,
    )
    from nbodyhpc_jax.utils.workloads import camels_particles, subcell_quantum

    nd = len(jax.devices())
    pos, w, r = camels_particles(jax.random.key(seed), N_SPLAT, GRID)
    vol_s, t = _twice(f"render_points_volume_sharded over {nd} z-slabs",
                      lambda: render_points_volume_sharded(
                          pos, w, r, float(GRID), GRID, periodic=True))
    vol_s, overflow = vol_s
    _check("sharded render halo overflow", overflow, 0)
    gp, gw, gr = augment_points_periodic_device(pos, w, r, (1.0, 1.0, 1.0),
                                                pad_ok=True)
    one, _ = _twice("one-card render", lambda: deposit.splat_volume(
        gp, gw, gr, float(GRID), (GRID,) * 3, SUBSAMPLE).block_until_ready())
    quantum = subcell_quantum(gw[:N_SPLAT], gr[:N_SPLAT] * GRID, SUBSAMPLE)
    del gp, gw, gr
    _parity("sharded vs one-card render", vol_s, one, quantum)
    del vol_s, one

    pts = jax.random.uniform(jax.random.key(seed + 1), (N_KNN, 3), jnp.float32)
    q = pts[:Q_HOST]
    tree = KDTree(pts, boxsize=1.0)
    d1, i1 = (np.asarray(a) for a in tree.query_device(q, k=K))
    pts_h, q_h = np.asarray(pts, np.float64), np.asarray(q, np.float64)
    st, _ = _twice("build_tree_sharded", lambda: build_tree_sharded(pts, boxsize=1.0))
    (ds, is_, ov), _ = _twice(f"knn_query_tree_sharded {Q_HOST} k={K}",
                              lambda: knn_query_tree_sharded(st, np.asarray(q), K))
    _check("sharded tree overflow", ov, 0)
    _check_knn(np, "one-card ladder (sharded tree)", ds, is_, d1, i1, pts_h, q_h)
    (dr, ir), _ = _twice(f"knn_query_sharded (replicated tree) {Q_HOST} k={K}",
                         lambda: knn_query_sharded(tree._tree, tree._dev,
                                                   np.asarray(q), K))
    _check_knn(np, "one-card ladder (query-sharded)", dr, ir, d1, i1, pts_h, q_h)
    _peak(jax)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--chips", type=int, default=1, choices=(1, 4))
    args = ap.parse_args()

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"no GPU: JAX sees {devices[0].platform}", file=sys.stderr)
        return 2
    if len(devices) < args.chips:
        print(f"--chips {args.chips}: JAX sees {len(devices)} GPU(s)",
              file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=False,
    )
    print(smi.stdout.strip() or f"nvidia-smi failed: {smi.stderr.strip()}")

    import jax.numpy as jnp
    import numpy as np

    import nbodyhpc_jax  # noqa: F401  (fails outside a checkout)

    phases = (
        [("sharded", phase_sharded)] if args.chips == 4 else
        [("splat", phase_splat), ("oracle", phase_oracle),
         ("knn", phase_knn), ("gpu tests", phase_gpu_tests)]
    )
    failed = []
    for name, fn in phases:
        print(f"[{name}]", flush=True)
        t0 = time.perf_counter()
        try:
            fn(jax, jnp, np, args.seed)
        except Exception:  # noqa: BLE001 — reported, and the run fails
            traceback.print_exc(file=sys.stdout)
            failed.append(name)
        print(f"[{name}] {'FAILED' if name in failed else 'passed'} in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    if failed:
        print(f"failed phases: {', '.join(failed)}", file=sys.stderr)
        return 1
    used = args.chips
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": used}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
