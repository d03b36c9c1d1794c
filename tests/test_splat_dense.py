"""Dense large-radius deposition (ops/splat_dense.py) vs the oracle.

The reference renders arbitrarily large points (unbounded gl_PointSize,
rasterization/shaders/triangle.vert:43-44,63); the deposit engine's radius
classes stop at 15 px, so radii above that take the dense clamped-window
pass. These tests pin (a) bit-level parity of the dense evaluator with the
oracle, including window clamping at grid edges, (b) the mixed-radius
routing in the deposit engine (device-resident and numpy paths), and (c)
the halfwidth bucket ladder.
"""
import numpy as np
import pytest

from nbodyhpc_jax.ops.splat import required_halfwidth, splat_volume_oracle
from nbodyhpc_jax.ops.splat_dense import (
    HALF_BUCKETS,
    dense_halfwidth,
    splat_volume_dense,
)


def _particles(n, seed, grid, ppu, rpx_lo, rpx_hi):
    rng = np.random.Generator(np.random.Philox(seed))
    box = np.array([g / ppu for g in grid], np.float32)
    pos = (rng.random((n, 3)).astype(np.float32) * box).astype(np.float32)
    w = rng.random(n).astype(np.float32) + 0.5
    r = ((rpx_lo + rng.random(n) * (rpx_hi - rpx_lo)) / ppu).astype(np.float32)
    return pos, w, r


def _quantum_atol(w, rpx, subsample=4):
    """One knife-edge subcell quantum: max over large particles of
    w / (4/3 pi rpx^3) / S^3.

    Separately compiled programs (oracle scatter vs deposit engine) may
    FMA-contract the r^2 - (ax + ay) chain differently, flipping a subcell
    compare whose margin is within ~1 ulp of r^2 — at most one S^-3 quantum
    per voxel (ops/splat.py big-particle docstring; measured one flip per
    ~1.4e6 subcell evaluations at 11 px radii). Engine-vs-oracle checks
    budget exactly that on top of the float32 round-off tolerance. The
    budget covers only rpx >= 4 (ulp(r^2) >= 2e-6, the band where flips
    are reachable); smaller radii keep the tight tolerance so real
    deposit bugs there stay visible."""
    rpx = np.asarray(rpx, np.float64)
    big = rpx >= 4.0
    if not np.any(big):
        return 0.0
    vol = 4.0 / 3.0 * np.pi * rpx[big] ** 3
    return float((np.asarray(w, np.float64)[big] / vol).max()) / subsample**3


def test_dense_matches_oracle_large_radii():
    """Radii 8-18 px on a 40^3-ish grid: footprints larger than the grid
    axes in places, so edge clamping is exercised heavily."""
    grid = (40, 36, 40)
    ppu = 32.0
    pos, w, r = _particles(30, 7, grid, ppu, 8.0, 18.0)
    want = splat_volume_oracle(pos, w, r, ppu, grid)
    got = np.asarray(splat_volume_dense(pos * ppu, w, r * ppu, grid))
    np.testing.assert_array_equal(got, want)  # same fn, same f32 order


def test_dense_window_larger_than_grid():
    """Window F may exceed a grid axis; the padded-volume route must still
    deposit exactly footprint-intersect-grid."""
    grid = (16, 12, 16)
    ppu = 16.0
    pos, w, r = _particles(8, 21, grid, ppu, 10.0, 31.0)
    want = splat_volume_oracle(pos, w, r, ppu, grid)
    got = np.asarray(splat_volume_dense(pos * ppu, w, r * ppu, grid))
    np.testing.assert_array_equal(got, want)


def test_dense_vol0_accumulate():
    grid = (24, 24, 24)
    ppu = 24.0
    pos, w, r = _particles(10, 3, grid, ppu, 8.0, 12.0)
    base = np.asarray(
        splat_volume_oracle(pos, w, r * 0.1, ppu, grid), np.float32
    )
    import jax.numpy as jnp

    got = np.asarray(
        splat_volume_dense(
            pos * ppu, w, r * ppu, grid, vol0=jnp.asarray(base)
        )
    )
    want = base + np.asarray(splat_volume_oracle(pos, w, r, ppu, grid))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_dense_halfwidth_ladder():
    for rpx in (7.5, 9.0, 17.0, 33.0, 65.0, 129.0, 257.0):
        hw = dense_halfwidth(rpx)
        assert hw >= required_halfwidth(rpx)
    # within the ladder: the smallest covering rung
    assert dense_halfwidth(8.0) == HALF_BUCKETS[0]
    assert dense_halfwidth(HALF_BUCKETS[0] - 3.0) == HALF_BUCKETS[0]
    assert dense_halfwidth(HALF_BUCKETS[0] - 2.5) == HALF_BUCKETS[1]
    # beyond the ladder: exact halfwidth (unbounded radii)
    big = HALF_BUCKETS[-1] + 40.0
    assert dense_halfwidth(big) == required_halfwidth(big)


def test_splat_volume_numpy_routes_huge_to_dense():
    """Mixed workload through the engine's host path: the huge tail must
    land on the dense pass (not the scatter oracle) and still match the
    oracle field."""
    from nbodyhpc_jax.ops import deposit

    grid = (24, 20, 24)
    ppu = 24.0
    rng = np.random.Generator(np.random.Philox(9))
    n = 48
    box = np.array([g / ppu for g in grid], np.float32)
    pos = (rng.random((n, 3)).astype(np.float32) * box).astype(np.float32)
    w = rng.random(n).astype(np.float32) + 0.5
    r = np.concatenate(
        [
            (rng.random(16) * 0.4 / ppu),  # sub-pixel
            ((0.6 + rng.random(16) * 5.0) / ppu),  # window classes
            ((15.5 + rng.random(16) * 6.0) / ppu),  # dense tail (> 15 px)
        ]
    ).astype(np.float32)
    want = splat_volume_oracle(pos, w, r, ppu, grid)
    got = np.asarray(deposit.splat_volume(pos, w, r, ppu, grid, engine="plain"))
    np.testing.assert_allclose(
        got, want, rtol=1e-6, atol=1e-7 + _quantum_atol(w, r * ppu)
    )


def test_splat_volume_device_class_sorted_skips_partition():
    """Device inputs already sorted by radius class: the class boundaries
    the engine's one sort finds must match the classes of the input, and
    the render must match the oracle."""
    import jax.numpy as jnp

    from nbodyhpc_jax.ops import deposit

    grid = (24, 20, 24)
    ppu = 24.0
    rng = np.random.Generator(np.random.Philox(21))
    n = 48
    box = np.array([g / ppu for g in grid], np.float32)
    pos = (rng.random((n, 3)).astype(np.float32) * box).astype(np.float32)
    w = rng.random(n).astype(np.float32) + 0.5
    r = np.sort(
        np.concatenate(
            [
                (0.5 + rng.random(16) * 1.4) / ppu,    # classes 0-1 (<= 2 px)
                ((2.2 + rng.random(16) * 0.7) / ppu),  # class 2 (2, 3] px
                ((15.5 + rng.random(16) * 4.0) / ppu),  # dense tail (> 15 px)
            ]
        ).astype(np.float32)
    )
    counts, max_rpx = deposit.class_counts(jnp.asarray(r * ppu), jnp.asarray(w))
    assert sum(counts[:2]) == 16 and counts[2] == 16
    assert counts[deposit.DENSE] == 16 and sum(counts) == n
    assert max_rpx == float(np.max(r * ppu))
    _, bounds, _ = deposit.sort_by_class(
        jnp.asarray(pos * ppu), jnp.asarray(w), jnp.asarray(r * ppu), grid
    )
    bounds = np.asarray(bounds)
    np.testing.assert_array_equal(np.diff(bounds)[: deposit.DENSE + 1], counts)
    want = splat_volume_oracle(pos, w, r, ppu, grid)
    got = np.asarray(
        deposit.splat_volume(
            jnp.asarray(pos), jnp.asarray(w), jnp.asarray(r), ppu, grid,
            engine="plain",
        )
    )
    np.testing.assert_allclose(
        got, want, rtol=1e-6, atol=1e-7 + _quantum_atol(w, r * ppu)
    )


def test_splat_volume_device_mixed_radii():
    """Device-resident mixed workload (sub-pixel + window classes + huge),
    in several batches per class."""
    import jax.numpy as jnp

    from nbodyhpc_jax.ops import deposit

    grid = (24, 20, 24)
    ppu = 24.0
    rng = np.random.Generator(np.random.Philox(11))
    n = 300
    box = np.array([g / ppu for g in grid], np.float32)
    pos = (rng.random((n, 3)).astype(np.float32) * box).astype(np.float32)
    w = rng.random(n).astype(np.float32) + 0.5
    r = np.concatenate(
        [
            (rng.random(100) * 0.4 / ppu),
            ((0.6 + rng.random(100) * 5.0) / ppu),
            ((8.0 + rng.random(100) * 10.0) / ppu),
        ]
    ).astype(np.float32)
    # shuffle so the class sort has real work to do
    perm = rng.permutation(n)
    pos, w, r = pos[perm], w[perm], r[perm]
    want = splat_volume_oracle(pos, w, r, ppu, grid)
    got = np.asarray(
        deposit.splat_volume(
            jnp.asarray(pos), jnp.asarray(w), jnp.asarray(r), ppu, grid,
            batch=128, engine="plain",
        )
    )
    np.testing.assert_allclose(
        got, want, rtol=1e-6, atol=1e-7 + _quantum_atol(w, r * ppu)
    )
