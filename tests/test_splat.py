"""Rasterizer semantics tests.

Strategy mirrors the reference's analytic validation (reference:
rasterization/src/cpp/main.cpp:53-84 — single-sphere mass conservation,
lit-voxel fraction, central value) plus an independent dense per-voxel
evaluator written directly from the shader spec (triangle.vert:26-70,
triangle.frag:14-46) to cross-check the production footprint path, including
anisotropic grids (axis-order) and periodic ghost wrap.
"""
import math

import numpy as np
import pytest

from nbodyhpc_jax.ops.splat import splat_2d_oracle, splat_volume_oracle
from nbodyhpc_jax.rasterizer import (
    render_points,
    render_points_volume,
)


def dense_reference_volume(positions, weights, radii, ppu, grid, subsample=4):
    """Independent O(N * G^3) numpy evaluation of the deposition spec."""
    gx, gy, gz = grid
    out = np.zeros((gx, gy, gz), np.float64)
    S = subsample
    u = (np.arange(S) + 0.5) / S
    sub = np.stack(np.meshgrid(u, u, u, indexing="ij"), -1).reshape(-1, 3)
    for p, w, r in zip(np.asarray(positions), np.asarray(weights), np.asarray(radii)):
        px, py, pz = (np.float32(v * ppu) for v in p)
        rpx = np.float32(r * ppu)
        if rpx < 0.5:
            ix, iy = int(np.floor(px)), int(np.floor(py))
            iz = int(np.ceil(pz)) - 1  # z in (iz, iz+1]
            if 0 <= ix < gx and 0 <= iy < gy and 0 <= iz < gz:
                out[ix, iy, iz] += w
            continue
        vol = 4.0 / 3.0 * math.pi * rpx**3
        for iz in range(gz):
            zoff = pz - (iz + 0.5)
            if abs(zoff) > rpx + 1.0:
                continue
            plane_r = math.sqrt(max(rpx**2 - zoff**2, 0.0))
            half = math.ceil(plane_r) + 1.0
            for ix in range(gx):
                cx = ix + 0.5 - px
                if not (-half <= cx < half):
                    continue
                for iy in range(gy):
                    cy = iy + 0.5 - py
                    if not (-half <= cy < half):
                        continue
                    delta = np.array([px - ix, py - iy, pz - iz])
                    d2 = np.sum((delta[None, :] - sub) ** 2, axis=1)
                    overlap = np.count_nonzero(d2 < rpx**2) / S**3
                    out[ix, iy, iz] += w / vol * overlap
    return out.astype(np.float32)


def test_analytic_sphere_mass_conservation():
    # reference main.cpp:53-84: total deposited mass ~ weight
    ppu = 32.0
    pos = np.array([[0.5, 0.5, 0.5]], np.float32)
    w = np.array([1.0], np.float32)
    r = np.array([0.2], np.float32)
    vol = render_points_volume(pos, w, r, ppu, 32)
    assert vol.shape == (32, 32, 32)
    total = vol.sum()
    assert abs(total - 1.0) < 0.02
    # central voxel should carry ~ uniform density w/(4/3 pi r^3) per voxel
    density = 1.0 / (4.0 / 3.0 * math.pi * 0.2**3) / ppu**3
    assert abs(vol[16, 16, 16] - density) / density < 0.05
    # lit fraction: between the sphere volume fraction and the sphere grown by
    # the ~1.5-voxel anti-aliasing shell
    lit = np.count_nonzero(vol) / vol.size
    rpx = 0.2 * ppu
    inner = 4.0 / 3.0 * math.pi * rpx**3 / vol.size
    outer = 4.0 / 3.0 * math.pi * (rpx + 1.5) ** 3 / vol.size
    assert inner <= lit <= outer


def test_subpixel_snap_and_z_tiebreak():
    # triangle.vert:47-60: sub-pixel particle -> full weight into one voxel,
    # z ties broken to the lower slice
    ppu = 8.0
    pos = np.array(
        [
            [0.3, 0.6, 0.55],      # generic
            [0.25, 0.25, 0.5],     # z*ppu = 4.0 exactly -> slice 3 (lower)
        ],
        np.float32,
    )
    w = np.array([2.0, 3.0], np.float32)
    r = np.array([0.01, 0.01], np.float32)  # rpx = 0.08 < 0.5
    vol = render_points_volume(pos, w, r, ppu, 8)
    assert vol.sum() == pytest.approx(5.0)
    assert vol[2, 4, 4] == pytest.approx(2.0)  # floor(2.4), floor(4.8), ceil(4.4)-1
    assert vol[2, 2, 3] == pytest.approx(3.0)  # tie -> lower slice
    assert np.count_nonzero(vol) == 2


@pytest.mark.parametrize("grid", [(16, 16, 16), (16, 12, 8)])
def test_oracle_matches_dense_reference(grid):
    rng = np.random.Generator(np.random.Philox(99))
    n = 12
    ppu = float(grid[0])  # box x-extent 1.0
    pos = rng.random((n, 3)).astype(np.float32) * np.array(
        [g / ppu for g in grid], np.float32
    )
    w = rng.random(n).astype(np.float32) + 0.5
    r = (rng.random(n).astype(np.float32) * 0.15 + 0.01)  # mix of sub-pixel and big
    got = splat_volume_oracle(pos, w, r, ppu, grid)
    want = dense_reference_volume(pos, w, r, ppu, grid)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_periodic_mass_conservation_corner():
    # sphere straddling the box corner must conserve mass via ghost clones
    # (reference vertex_utilities.cpp:13-43)
    ppu = 24.0
    pos = np.array([[0.02, 0.02, 0.02]], np.float32)
    w = np.array([1.0], np.float32)
    r = np.array([0.15], np.float32)
    vol_np = render_points_volume(pos, w, r, ppu, 24, periodic=False)
    vol_p = render_points_volume(pos, w, r, ppu, 24, periodic=True)
    assert vol_np.sum() < 0.30  # most of the sphere is clipped without wrap
    assert abs(vol_p.sum() - 1.0) < 0.02
    # wrapped mass appears at the far corner region
    assert vol_p[-2:, -2:, -2:].sum() > 0


def test_periodic_equals_manual_ghosts():
    from nbodyhpc_jax.ops.ghosts import augment_points_periodic

    rng = np.random.Generator(np.random.Philox(7))
    n = 20
    ppu = 16.0
    pos = rng.random((n, 3)).astype(np.float32)
    w = np.ones(n, np.float32)
    r = (rng.random(n).astype(np.float32) * 0.1 + 0.02)
    vol_p = render_points_volume(pos, w, r, ppu, 16, periodic=True)
    gp, gw, gr = augment_points_periodic(pos, w, r, (1.0, 1.0, 1.0))
    vol_g = render_points_volume(gp, gw, gr, ppu, 16, periodic=False)
    np.testing.assert_allclose(vol_p, vol_g, rtol=1e-5, atol=1e-6)


def test_device_ghost_augmentation_matches_host():
    import jax.numpy as jnp

    from nbodyhpc_jax.ops.ghosts import (
        augment_points_periodic,
        augment_points_periodic_device,
    )

    rng = np.random.Generator(np.random.Philox(31))
    n = 500
    pos = rng.random((n, 3)).astype(np.float32)
    w = rng.random(n).astype(np.float32)
    # radii large enough that corner-crossers spawn multi-dim clone chains
    r = rng.random(n).astype(np.float32) * 0.15 + 0.01
    for box in ((1.0, 1.0, 1.0), (1.0, -1.0, 1.0), (-1.0, -1.0, -1.0)):
        hp, hw, hr = augment_points_periodic(pos, w, r, box)
        dp, dw, dr = augment_points_periodic_device(
            jnp.asarray(pos), jnp.asarray(w), jnp.asarray(r), box
        )
        # identical clone ordering, bit-identical values
        np.testing.assert_array_equal(np.asarray(dp), hp)
        np.testing.assert_array_equal(np.asarray(dw), hw)
        np.testing.assert_array_equal(np.asarray(dr), hr)


def test_period_normalization_variants():
    pos = np.array([[0.05, 0.5, 0.5]], np.float32)
    w = np.array([1.0], np.float32)
    r = np.array([0.1], np.float32)
    a = render_points_volume(pos, w, r, 16.0, 16, periodic=True)
    b = render_points_volume(pos, w, r, 16.0, 16, periodic=1.0)
    c = render_points_volume(pos, w, r, 16.0, 16, periodic=(1.0, 1.0, 1.0))
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(a, c)
    # x-only periodicity: mass conserved (sphere crosses x face only)
    d = render_points_volume(pos, w, r, 16.0, 16, periodic=(1.0, -1.0, -1.0))
    np.testing.assert_allclose(d.sum(), 1.0, atol=0.02)


def test_output_shapes_and_order():
    pos = np.array([[0.5, 0.5, 0.5]], np.float32)
    w = np.array([1.0], np.float32)
    r = np.array([0.1], np.float32)
    vol = render_points_volume(pos, w, r, 8.0, (8, 12, 16))
    assert vol.shape == (8, 12, 16)
    assert vol.flags["F_CONTIGUOUS"]
    assert vol.dtype == np.float32
    img = render_points(pos, w, r, 8.0, (8, 12))
    assert img.shape == (8, 12)
    assert img.flags["F_CONTIGUOUS"]


def test_anisotropic_axis_mapping():
    """A particle at distinct coordinates must land at (x, y, z) indices in
    the (grid_x, grid_y, slices) output — catches transposition bugs."""
    pos = np.array([[0.1, 0.3, 0.7]], np.float32)  # -> voxel (1, 4, 11)
    w = np.array([1.0], np.float32)
    r = np.array([0.001], np.float32)
    vol = render_points_volume(pos, w, r, 16.0, (4, 8, 16))
    # x: 0.1*16=1.6 -> 1 (grid 4); y: 0.3*16=4.8 -> 4 (grid 8); z: 11.2 -> 11
    assert vol[1, 4, 11] == pytest.approx(1.0)
    assert vol.sum() == pytest.approx(1.0)


def test_render_points_2d_subpixel():
    # 2D slice: sub-pixel selection on z in (-0.5, 0.5] *units*
    ppu = 8.0
    pos = np.array([[0.3, 0.6, 0.2], [0.3, 0.3, 0.8]], np.float32)
    w = np.array([1.0, 1.0], np.float32)
    r = np.array([0.01, 0.01], np.float32)
    img = render_points(pos, w, r, ppu, 8)
    assert img[2, 4] == pytest.approx(1.0)  # first point, z=0.2 in (-.5,.5]
    assert img.sum() == pytest.approx(1.0)  # second point z=0.8 excluded


def test_render_points_2d_big_particle_slab():
    # big particle at z=0: deposits overlap with the 1-pixel slab at z=0
    ppu = 16.0
    pos = np.array([[0.5, 0.5, 0.0]], np.float32)
    w = np.array([1.0], np.float32)
    r = np.array([0.2], np.float32)
    img = render_points(pos, w, r, ppu, 16)
    rpx = 0.2 * ppu
    # expected slab mass fraction ~ area(pi plane_r^2)*1 / (4/3 pi rpx^3)
    # with plane_r ~ rpx at z~0
    expect = math.pi * rpx**2 / (4.0 / 3.0 * math.pi * rpx**3)
    assert abs(img.sum() - expect) / expect < 0.1


def test_input_validation():
    w1 = np.ones(2, np.float32)
    with pytest.raises(ValueError):
        render_points_volume(np.zeros((2, 2), np.float32), w1, w1, 8.0, 8)
    with pytest.raises(ValueError):
        render_points_volume(np.zeros((2, 3), np.float32), w1, np.ones(3, np.float32), 8.0, 8)
    with pytest.raises(ValueError):
        render_points_volume(np.zeros((2, 3), np.float32), np.ones((2, 1), np.float32), w1, 8.0, 8)


def test_validation_container_is_scoped():
    """Container(enable_validation_layers=True) catches poisoned inputs for
    ITS renders without flipping process-global state (the round-1 design
    set jax_debug_nans for the whole process and never restored it)."""
    import jax

    from nbodyhpc_jax.rasterizer import Container, PointRenderer

    c = Container(enable_validation_layers=True)
    pr = PointRenderer(c, 8, 8)
    pos = np.array([[0.5, 0.5, 0.25], [0.2, np.nan, 0.1]], np.float32)
    w = np.ones(2, np.float32)
    r = np.full(2, 0.05, np.float32)
    with pytest.raises(ValueError, match="non-finite"):
        pr.render_points_volume(pos, w, r, 8, 8.0)
    # clean inputs still render, and the NaN check does not leak out
    pos[1, 1] = 0.5
    vol = pr.render_points_volume(pos, w, r, 8, 8.0)
    assert np.isfinite(vol).all()
    assert not jax.config.jax_debug_nans


def test_renderer_cache():
    from nbodyhpc_jax.rasterizer import get_point_renderer

    r1 = get_point_renderer((16, 16))
    r2 = get_point_renderer((16, 16))
    r3 = get_point_renderer((16, 16), subsample_factor=2)
    assert r1 is r2
    assert r1 is not r3


def test_device_ghost_aug_one_sync_corner_multiplicities():
    """The one-sync count predictor (all six per-dim clone counts from the
    original array via multiplicity products, ghosts._count_all_fn) must
    reproduce the host's dim-sequential semantics EXACTLY — including
    clones-of-clones at corners and a 2r > L particle cloning both faces
    of one dimension."""
    import jax.numpy as jnp

    from nbodyhpc_jax.ops.ghosts import (
        augment_points_periodic,
        augment_points_periodic_device,
    )

    pos = np.array([
        [0.01, 0.01, 0.01],   # triple corner: 7 clones
        [0.99, 0.5, 0.02],    # edge: 3 clones
        [0.5, 0.5, 0.5],      # interior: none
        [0.5, 0.02, 0.98],    # edge: 3 clones
        [0.45, 0.5, 0.5],     # 2r > L: crosses BOTH x faces
    ], np.float32)
    r = np.array([0.05, 0.05, 0.01, 0.05, 0.6], np.float32)
    w = np.arange(1, 6, dtype=np.float32)
    hp, hw, hr = augment_points_periodic(pos, w, r, (1.0, 1.0, 1.0))
    dp, dw, dr = augment_points_periodic_device(
        jnp.asarray(pos), jnp.asarray(w), jnp.asarray(r), (1.0, 1.0, 1.0))
    assert hp.shape == dp.shape
    np.testing.assert_array_equal(hp, np.asarray(dp))
    np.testing.assert_array_equal(hw, np.asarray(dw))
    np.testing.assert_array_equal(hr, np.asarray(dr))
