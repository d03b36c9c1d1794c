"""Mass-conserving anti-aliased sphere-splat deposition (reference semantics).

This module is the semantic core of the rasterizer. It reproduces, in JAX, the
exact deposition math of the reference's Vulkan shader pair (reference:
rasterization/shaders/triangle.vert:26-70 and triangle.frag:14-46) and the
per-slice volume loop (rasterization/src/cpp/point_renderer.cpp:825-950):

In pixel units (``Ppx = position * pixels_per_unit``, ``rpx = radius * ppu``):

- A particle is *sub-pixel* when ``rpx < 0.5``: its full weight is deposited
  into the single voxel containing it, tie-broken to the lower slice via the
  z-selection ``z in (slice_lower, slice_upper]`` (triangle.vert:47-60).
- Otherwise it renders on every slice with ``|z_offset_px| <= rpx + 1`` (the
  ``gl_ClipDistance`` cull, triangle.vert:32-39); on a slice at distance
  ``z_offset`` it covers the square of pixels whose centers fall within
  half-side ``ceil(plane_radius_px) + 1`` of the particle (the
  ``gl_PointSize = 2*ceil(plane_radius*ppu) + 2`` rule, triangle.vert:43-44,63),
  where ``plane_radius = sqrt(r^2 - z_offset^2)``. Each covered voxel receives
  ``weight / (4/3 pi rpx^3) * overlap`` with ``overlap`` the fraction of the
  voxel's S^3 sub-cell centers inside the sphere (triangle.frag:25-45). The
  x/y coverage square is deliberately replicated even where it *undercounts*
  at the sphere caps, so fields match the reference bit-for-bit in structure.

Voxel (ix, iy, iz) covers ``[ix, ix+1) x [iy, iy+1) x [iz, iz+1)`` in pixel
space; output axis order is (x, y, z) = the reference's F-order
(height, width, num_slices) array (rasterization/src/cpp/pybind.cpp:116-122).

The functions here are the *oracle* path: vectorized per-particle footprint
expansion plus XLA scatter-add. The production engines
(:mod:`nbodyhpc_jax.ops.deposit`: the plain engine reuses
``footprint_values``, the GPU kernel mirrors it expression by expression)
must agree with this oracle to float32 tolerance.
"""
from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np

FOUR_THIRDS_PI = 4.0 / 3.0 * math.pi


def required_halfwidth(max_rpx: float) -> int:
    """Static footprint half-extent (in voxels) covering any particle with
    pixel radius <= max_rpx: the coverage square needs ceil(plane_r)+1 pixels
    beyond the base pixel, and the z-cull admits |z_offset| <= rpx + 1."""
    return int(math.ceil(max(max_rpx, 0.0))) + 3


def footprint_values(ppx, w, rpx, halfwidth: int, subsample: int, base=None):
    """Per-particle footprint contributions on a static (F, F, F) window.

    Parameters
    ----------
    ppx : (C, 3) float32 — particle positions in pixel units.
    w : (C,) float32 — weights.
    rpx : (C,) float32 — radii in pixel units.
    halfwidth : int — static window half-extent R; window is F = 2R+1 per dim.
    subsample : int — S, the anti-aliasing subsample factor.
    base : (C, 3) int32, optional — explicit window origins. Every formula
        below is elementwise in absolute voxel coordinates, so the window may
        sit anywhere; voxels outside the particle's true footprint evaluate
        to exactly zero. Callers (the dense large-radius path) use this to
        clamp windows inside the grid. Default: floor(ppx) - R (centered).

    Returns
    -------
    base : (C, 3) int32 — window lower corner voxel.
    vals : (C, F, F, F) float32 — deposition into voxel base + offset.
    """
    R = halfwidth
    F = 2 * R + 1
    C = ppx.shape[0]
    px, py, pz = ppx[:, 0], ppx[:, 1], ppx[:, 2]
    if base is None:
        base = jnp.floor(ppx).astype(jnp.int32) - R  # (C, 3)

    off = jnp.arange(F, dtype=jnp.int32)
    vx = base[:, 0:1] + off[None, :]  # (C, F)
    vy = base[:, 1:2] + off[None, :]
    vz = base[:, 2:3] + off[None, :]

    # --- big-particle path (triangle.vert:41-45,61-63 + triangle.frag:25-45) ---
    # Parity caveat: XLA's fusion emitter may FMA-contract the squared terms
    # below into their consumers (r2 - (ax + ay) becomes an fma chain with
    # fewer roundings), and a subcell compare whose margin is within ~1 ulp
    # of r^2 then flips relative to a plain single-rounding evaluation in a
    # SEPARATELY compiled program (e.g. the deposit kernel). This cannot be
    # pinned from JAX — optimization barriers are dropped when the fusion
    # recomputes from raw inputs (verified on XLA:CPU: the reduce fusion
    # consumes the original ppx/rpx params). Consequence: oracle/engine
    # agreement is exact up to at most ONE S^-3 subcell quantum per voxel
    # on knife-edge subcells (measured one flip per ~1.4e6 subcell
    # evaluations at 11 px radii); parity tests budget exactly that
    # (see tests/test_splat_dense.py::_quantum_atol).
    zoff = pz[:, None] - (vz.astype(jnp.float32) + 0.5)  # (C, F)
    zclip = jnp.abs(zoff) <= rpx[:, None] + 1.0  # gl_ClipDistance cull
    plane_r = jnp.sqrt(jnp.maximum(rpx[:, None] ** 2 - zoff**2, 0.0))
    half = jnp.ceil(plane_r) + 1.0  # (C, F) half point-size in pixels

    cx = vx.astype(jnp.float32) + 0.5 - px[:, None]  # (C, F) center offsets
    cy = vy.astype(jnp.float32) + 0.5 - py[:, None]
    # pixel covered iff center in [p - half, p + half)
    cov_x = (cx[:, :, None] >= -half[:, None, :]) & (cx[:, :, None] < half[:, None, :])
    cov_y = (cy[:, :, None] >= -half[:, None, :]) & (cy[:, :, None] < half[:, None, :])
    cover = (
        cov_x[:, :, None, :]
        & cov_y[:, None, :, :]
        & zclip[:, None, None, :]
    )  # (C, Fx, Fy, Fz)

    # overlap: fraction of S^3 sub-cell centers inside the sphere
    dx = px[:, None] - vx.astype(jnp.float32)  # (C, F) corner deltas
    dy = py[:, None] - vy.astype(jnp.float32)
    dz = pz[:, None] - vz.astype(jnp.float32)
    u = (np.arange(subsample, dtype=np.float32) + 0.5) / subsample
    ax = (dx[:, :, None] - u[None, None, :]) ** 2  # (C, F, S)
    ay = (dy[:, :, None] - u[None, None, :]) ** 2
    az = (dz[:, :, None] - u[None, None, :]) ** 2
    r2 = (rpx**2)[:, None, None, None]
    count = jnp.zeros((C, F, F, F), jnp.float32)
    for a in range(subsample):
        for b in range(subsample):
            m = ax[:, :, a][:, :, None, None] + ay[:, :, b][:, None, :, None]
            # (C, Fx, Fy, 1): compare az < r^2 - (ax + ay), hoisting the
            # z-independent part (kernel and oracle share this association)
            rab = r2[..., None] - m[..., None]
            inside = az[:, None, None, :, :] < rab
            count = count + jnp.sum(inside, axis=-1, dtype=jnp.float32)
    overlap = count / float(subsample**3)

    volume = FOUR_THIRDS_PI * rpx**3  # pixel-unit sphere volume (vert:45)
    big_val = (w / volume)[:, None, None, None] * overlap * cover

    # --- sub-pixel path (triangle.vert:47-60) ---
    is_sub = rpx < 0.5
    fx = jnp.floor(px).astype(jnp.int32)
    fy = jnp.floor(py).astype(jnp.int32)
    sub_x = vx == fx[:, None]
    sub_y = vy == fy[:, None]
    # z in (slice_lower, slice_upper] with slice = [vz, vz+1) pixels
    sub_z = (pz[:, None] > vz.astype(jnp.float32)) & (
        pz[:, None] <= vz.astype(jnp.float32) + 1.0
    )
    sub_mask = (
        sub_x[:, :, None, None] & sub_y[:, None, :, None] & sub_z[:, None, None, :]
    )
    sub_val = w[:, None, None, None] * sub_mask

    vals = jnp.where(is_sub[:, None, None, None], sub_val, big_val)
    return base, vals


def footprint_values_2d(ppx, w, rpx, ppu: float, halfwidth: int, subsample: int):
    """Single-slice (2D) contributions, reproducing ``render_points``'s plane
    parameters plane_depth=0, lower/upper = -/+0.5 *units*
    (rasterization/src/cpp/point_renderer.cpp:606-657): big particles deposit
    overlap with a 1-pixel-thick slab centered at z=0 (fragment corner z=-0.5,
    triangle.frag:25), sub-pixel particles select on z in (-0.5, 0.5] units.

    Returns (base (C,2) int32, vals (C, F, F) float32).
    """
    R = halfwidth
    F = 2 * R + 1
    px, py, pz = ppx[:, 0], ppx[:, 1], ppx[:, 2]
    base = jnp.floor(ppx[:, :2]).astype(jnp.int32) - R

    off = jnp.arange(F, dtype=jnp.int32)
    vx = base[:, 0:1] + off[None, :]
    vy = base[:, 1:2] + off[None, :]

    zoff = pz  # plane depth 0
    zclip = jnp.abs(zoff) <= rpx + 1.0
    plane_r = jnp.sqrt(jnp.maximum(rpx**2 - zoff**2, 0.0))
    half = jnp.ceil(plane_r) + 1.0  # (C,)

    cx = vx.astype(jnp.float32) + 0.5 - px[:, None]
    cy = vy.astype(jnp.float32) + 0.5 - py[:, None]
    cov_x = (cx >= -half[:, None]) & (cx < half[:, None])
    cov_y = (cy >= -half[:, None]) & (cy < half[:, None])
    cover = cov_x[:, :, None] & cov_y[:, None, :] & zclip[:, None, None]

    dx = px[:, None] - vx.astype(jnp.float32)
    dy = py[:, None] - vy.astype(jnp.float32)
    dz = pz + 0.5  # corner delta: fragment z corner at -0.5 px
    u = (np.arange(subsample, dtype=np.float32) + 0.5) / subsample
    ax = (dx[:, :, None] - u[None, None, :]) ** 2  # (C, F, S)
    ay = (dy[:, :, None] - u[None, None, :]) ** 2
    az = (dz[:, None] - u[None, :]) ** 2  # (C, S)
    r2 = rpx**2
    # loop over (x, z) sub-cells, vectorize y over (F, S) — the compare uses
    # the SHARED association az < r2 - (ax + ay) (CLAUDE.md invariant: the
    # 3D oracle splat.py and the deposit engines pin this exact f32 rounding;
    # the engine-backed 2D route is validated against this oracle)
    count = jnp.zeros((ppx.shape[0], F, F), jnp.float32)
    for a in range(subsample):
        rab = r2[:, None, None, None] - (
            ax[:, :, a][:, :, None, None] + ay[:, None, :, :]
        )
        for c in range(subsample):
            inside = az[:, c][:, None, None, None] < rab
            count = count + jnp.sum(inside, axis=-1, dtype=jnp.float32)
    overlap = count / float(subsample**3)

    volume = FOUR_THIRDS_PI * rpx**3
    big_val = (w / volume)[:, None, None] * overlap * cover

    is_sub = rpx < 0.5
    zsel = (pz * (1.0 / ppu) > -0.5) & (pz * (1.0 / ppu) <= 0.5)
    fx = jnp.floor(px).astype(jnp.int32)
    fy = jnp.floor(py).astype(jnp.int32)
    sub_mask = (vx == fx[:, None])[:, :, None] & (vy == fy[:, None])[:, None, :]
    sub_val = (w * zsel)[:, None, None] * sub_mask

    vals = jnp.where(is_sub[:, None, None], sub_val, big_val)
    return base, vals


# ---------------------------------------------------------------------------
# Oracle renderers (XLA scatter-add); production engines are in deposit.py
# ---------------------------------------------------------------------------


@functools.partial(
    jax.jit, static_argnames=("grid", "halfwidth", "subsample", "wrap")
)
def _splat_chunk_volume(ppx, w, rpx, grid, halfwidth, subsample, wrap):
    gx, gy, gz = grid
    base, vals = footprint_values(ppx, w, rpx, halfwidth, subsample)
    F = 2 * halfwidth + 1
    off = jnp.arange(F, dtype=jnp.int32)
    vx = base[:, 0:1] + off[None, :]
    vy = base[:, 1:2] + off[None, :]
    vz = base[:, 2:3] + off[None, :]

    def axis_idx(v, g, do_wrap):
        if do_wrap:
            return jnp.mod(v, g), jnp.ones_like(v, dtype=bool)
        return jnp.clip(v, 0, g - 1), (v >= 0) & (v < g)

    ix, okx = axis_idx(vx, gx, wrap[0])
    iy, oky = axis_idx(vy, gy, wrap[1])
    iz, okz = axis_idx(vz, gz, wrap[2])
    ok = okx[:, :, None, None] & oky[:, None, :, None] & okz[:, None, None, :]
    flat = (
        (ix[:, :, None, None] * gy + iy[:, None, :, None]) * gz
        + iz[:, None, None, :]
    )
    vals = jnp.where(ok, vals, 0.0)
    out = jnp.zeros((gx * gy * gz,), jnp.float32)
    return out.at[flat.reshape(-1)].add(vals.reshape(-1))


@functools.partial(
    jax.jit, static_argnames=("grid", "halfwidth", "subsample", "ppu")
)
def _splat_chunk_2d(ppx, w, rpx, grid, halfwidth, subsample, ppu):
    gx, gy = grid
    base, vals = footprint_values_2d(ppx, w, rpx, ppu, halfwidth, subsample)
    F = 2 * halfwidth + 1
    off = jnp.arange(F, dtype=jnp.int32)
    vx = base[:, 0:1] + off[None, :]
    vy = base[:, 1:2] + off[None, :]
    ix = jnp.clip(vx, 0, gx - 1)
    iy = jnp.clip(vy, 0, gy - 1)
    ok = ((vx >= 0) & (vx < gx))[:, :, None] & ((vy >= 0) & (vy < gy))[:, None, :]
    flat = ix[:, :, None] * gy + iy[:, None, :]
    vals = jnp.where(ok, vals, 0.0)
    out = jnp.zeros((gx * gy,), jnp.float32)
    return out.at[flat.reshape(-1)].add(vals.reshape(-1))


def splat_volume_oracle(
    positions,
    weights,
    radii,
    pixels_per_unit: float,
    grid,
    subsample: int = 4,
    chunk: int = 256,
    wrap=(False, False, False),
):
    """Render a 3D density field (oracle path; particles pre-augmented for
    periodicity or ``wrap`` set for modulo wrapping). Returns (gx, gy, gz)."""
    gx, gy, gz = grid
    positions = np.asarray(positions, np.float32)
    weights = np.asarray(weights, np.float32)
    radii = np.asarray(radii, np.float32)
    n = positions.shape[0]
    ppx = positions * pixels_per_unit
    rpx = radii * pixels_per_unit
    max_rpx = float(rpx.max()) if n else 0.0
    R = required_halfwidth(max_rpx)

    acc = jnp.zeros((gx * gy * gz,), jnp.float32)
    csize = max(min(chunk, n), 1)
    for s in range(0, max(n, 1), csize):
        e = min(s + csize, n)
        sl = slice(s, e)
        p = ppx[sl]
        wc = weights[sl]
        rc = rpx[sl]
        if e - s < csize:
            pad = csize - (e - s)
            p = np.pad(p, ((0, pad), (0, 0)))
            wc = np.pad(wc, (0, pad))
            # pad with radius 1 / weight 0: deposits exactly zero
            rc = np.pad(rc, (0, pad), constant_values=1.0)
        acc = acc + _splat_chunk_volume(
            jnp.asarray(p), jnp.asarray(wc), jnp.asarray(rc),
            (gx, gy, gz), R, subsample, tuple(wrap),
        )
    return np.asarray(acc).reshape(gx, gy, gz)


def splat_2d_oracle(
    positions, weights, radii, pixels_per_unit: float, grid,
    subsample: int = 4, chunk: int = 256,
):
    """Render a single 2D slice (oracle). Returns (gx, gy)."""
    gx, gy = grid
    positions = np.asarray(positions, np.float32)
    weights = np.asarray(weights, np.float32)
    radii = np.asarray(radii, np.float32)
    n = positions.shape[0]
    ppx = positions * pixels_per_unit
    rpx = radii * pixels_per_unit
    max_rpx = float(rpx.max()) if n else 0.0
    R = required_halfwidth(max_rpx)

    acc = jnp.zeros((gx * gy,), jnp.float32)
    csize = max(min(chunk, n), 1)
    for s in range(0, max(n, 1), csize):
        e = min(s + csize, n)
        p = ppx[s:e]
        wc = weights[s:e]
        rc = rpx[s:e]
        if e - s < csize:
            pad = csize - (e - s)
            p = np.pad(p, ((0, pad), (0, 0)))
            wc = np.pad(wc, (0, pad))
            rc = np.pad(rc, (0, pad), constant_values=1.0)
        acc = acc + _splat_chunk_2d(
            jnp.asarray(p), jnp.asarray(wc), jnp.asarray(rc),
            (gx, gy), R, subsample, float(pixels_per_unit),
        )
    return np.asarray(acc).reshape(gx, gy)
