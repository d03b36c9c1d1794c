"""Deterministic property fuzz: random configurations of both engines vs
their oracles (Philox-seeded, mirroring the reference's deterministic
fixture strategy, reference kdtree/src/cpp/include/kdtree/kdtree_utils.hpp:
16-90). Small populations keep runtimes CI-friendly while sweeping the
config axes the targeted tests pin individually: grid shapes, radius
classes, off-grid particles, batch splits, k values, duplicate points, and
clustered distributions.
"""
import numpy as np
import pytest

from nbodyhpc_jax.kdtree import KDTree
from nbodyhpc_jax.ops import deposit
from nbodyhpc_jax.ops.splat import splat_volume_oracle


@pytest.mark.parametrize("seed", [101, 202, 303])
def test_fuzz_splat_configs(seed):
    rng = np.random.Generator(np.random.Philox(seed))
    grid = tuple(int(v) for v in rng.integers(10, 40, 3))
    ppu = float(rng.integers(8, 33))
    n = int(rng.integers(20, 120))
    box = np.array([g / ppu for g in grid], np.float32)
    pos = (rng.random((n, 3)).astype(np.float32) * box * 1.1 - 0.05 * box)
    pos = pos.astype(np.float32)  # ~10% land outside the grid (clipped)
    w = (rng.random(n).astype(np.float32) * 2.0 - 0.5).astype(np.float32)
    w[rng.random(n) < 0.1] = 0.0  # zero-weight particles deposit nothing
    # radii across sub-pixel and the window classes up to 10 px
    r = (rng.random(n).astype(np.float32) ** 2 * 9.0 + 0.05) / ppu
    batch = int(rng.integers(1, 3)) * 128

    got = np.asarray(
        deposit.splat_volume(pos, w, r, ppu, grid, batch=batch, engine="plain")
    )
    want = np.asarray(splat_volume_oracle(pos, w, r, ppu, grid))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("seed", [11, 22, 33, 44])
def test_fuzz_knn_configs(seed):
    scipy_spatial = pytest.importorskip("scipy.spatial")
    rng = np.random.Generator(np.random.Philox(seed))
    n = int(rng.integers(300, 3000))
    k = int(rng.integers(1, 12))
    periodic = bool(rng.integers(0, 2))
    clustered = bool(rng.integers(0, 2))
    if clustered:
        centers = rng.random((8, 3))
        pts = (
            centers[rng.integers(0, 8, n)]
            + rng.normal(0, 0.02, (n, 3))
        )
        pts = np.mod(pts, 1.0).astype(np.float32)
    else:
        pts = rng.random((n, 3), dtype=np.float32)
    # inject exact duplicates (equal-distance tie handling)
    ndup = n // 50
    if ndup:
        pts[:ndup] = pts[ndup : 2 * ndup]
    q = rng.random((200, 3), dtype=np.float32)

    if periodic:
        tree = KDTree(pts, boxsize=1.0)
        ref = scipy_spatial.KDTree(pts.astype(np.float64), boxsize=1.0)
    else:
        tree = KDTree(pts)
        ref = scipy_spatial.KDTree(pts.astype(np.float64))
    d, i = tree.query(q, k=k)
    dref, iref = ref.query(q, k=k)
    if k == 1:
        dref = dref[:, None] if dref.ndim == 1 else dref
        iref = iref[:, None] if iref.ndim == 1 else iref
    # distances must match scipy; indices may differ only where distances
    # tie (duplicates)
    np.testing.assert_allclose(d, dref, rtol=2e-6, atol=2e-7)
    mismatch = i != iref
    if mismatch.any():
        rows, cols = np.nonzero(mismatch)
        delta = np.abs(
            pts[i[rows, cols]].astype(np.float64) - q[rows].astype(np.float64)
        )
        if periodic:
            delta = np.minimum(delta, 1.0 - delta)  # min-image metric
        pd = np.linalg.norm(delta, axis=1)
        np.testing.assert_allclose(pd, dref[rows, cols], rtol=2e-6, atol=2e-7)
