"""Fused splat deposit kernel for the GPU (Pallas, Triton route).

One program evaluates one block of one particle's static (2R+1)^3 footprint
window in registers — the same per-voxel arithmetic as
:func:`nbodyhpc_jax.ops.splat.footprint_values`, in the same float32
association order — and adds the non-zero voxels straight into the volume
in device memory with ``atomic_add``. Nothing per-voxel is written to or
read back from device memory besides the volume's own read-modify-write,
which is what the plain engine (``ops/deposit.py``) pays for its
``(C, F, F, F)`` value and index blocks.

Grid: ``(cap, nblk)`` — particle row within the class batch, window block.
Each atomic call covers distinct voxels of one particle's window. On the GPU
masked lanes (outside the grid, outside the window, zero value) issue no
atomic. The Pallas interpreter implements neither masked atomics nor
summing of repeated indices within one call, so under ``interpret=True``
(tests only) masked lanes add zero into private slots appended past the
volume: every index of a call stays distinct and the real voxels see the
same sums.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltr

from .splat import FOUR_THIRDS_PI

#: window voxels one program covers (power of two, as Triton blocks must be)
BLOCK = 512


def window_block(halfwidth: int) -> int:
    """Lanes per program for a (2R+1)^3 window: the window rounded up to a
    power of two, at most :data:`BLOCK`."""
    w = (2 * halfwidth + 1) ** 3
    b = 32
    while b < min(w, BLOCK):
        b *= 2
    return b


def _voxel_values(px, py, pz, w, r, vx, vy, vz, subsample):
    """Per-voxel deposit of one particle; mirrors ``footprint_values``
    expression by expression (shader refs there), so both agree to float32
    round-off up to fused multiply-adds the two compilers place differently
    (at most one S^-3 subcell quantum per voxel)."""
    fx, fy, fz = (v.astype(jnp.float32) for v in (vx, vy, vz))
    zoff = pz - (fz + 0.5)
    zclip = jnp.abs(zoff) <= r + 1.0
    plane_r = jnp.sqrt(jnp.maximum(r**2 - zoff**2, 0.0))
    half = jnp.ceil(plane_r) + 1.0
    cx = fx + 0.5 - px
    cy = fy + 0.5 - py
    cover = (cx >= -half) & (cx < half) & (cy >= -half) & (cy < half) & zclip

    dx = px - fx
    dy = py - fy
    dz = pz - fz
    u = (np.arange(subsample, dtype=np.float32) + 0.5) / subsample
    az = [(dz - uc) ** 2 for uc in u]
    r2 = r**2
    count = jnp.zeros(dx.shape, jnp.float32)
    for ua in u:
        ax = (dx - ua) ** 2
        for ub in u:
            rab = r2 - (ax + (dy - ub) ** 2)
            for azc in az:
                count = count + (azc < rab).astype(jnp.float32)
    overlap = count / float(subsample**3)
    volume = FOUR_THIRDS_PI * r**3
    big = (w / volume) * overlap * cover.astype(jnp.float32)

    sub = (
        (vx == jnp.floor(px).astype(jnp.int32))
        & (vy == jnp.floor(py).astype(jnp.int32))
        & (pz > fz) & (pz <= fz + 1.0)
    )
    return jnp.where(r < 0.5, w * sub.astype(jnp.float32), big)


def _deposit_kernel(span_ref, px_ref, py_ref, pz_ref, w_ref, r_ref, _vol_in,
                    vol_ref, *, halfwidth, grid, subsample, blk, interpret):
    gx, gy, gz = grid
    F = 2 * halfwidth + 1
    row = span_ref[0] + pl.program_id(0)
    live = (row >= span_ref[1]) & (row < span_ref[2])
    px, py, pz = px_ref[row], py_ref[row], pz_ref[row]
    w, r = w_ref[row], r_ref[row]

    lane = jnp.arange(blk, dtype=jnp.int32)
    e = pl.program_id(1) * blk + lane
    ix = jax.lax.div(e, F * F)
    iy = jax.lax.rem(jax.lax.div(e, F), F)
    iz = jax.lax.rem(e, F)
    vx = jnp.floor(px).astype(jnp.int32) - halfwidth + ix
    vy = jnp.floor(py).astype(jnp.int32) - halfwidth + iy
    vz = jnp.floor(pz).astype(jnp.int32) - halfwidth + iz
    vals = _voxel_values(px, py, pz, w, r, vx, vy, vz, subsample)

    ok = (
        live & (e < F**3)
        & (vx >= 0) & (vx < gx) & (vy >= 0) & (vy < gy)
        & (vz >= 0) & (vz < gz)
    )
    flat = (vx * gy + vy) * gz + vz
    if interpret:
        idx = jnp.where(ok, flat, gx * gy * gz + lane)
        pltr.atomic_add(vol_ref, idx, jnp.where(ok, vals, 0.0))
    else:
        pltr.atomic_add(vol_ref, flat, vals, mask=ok & (vals != 0.0))


def deposit(vol, span, px, py, pz, w, r, *, halfwidth: int, grid, cap: int,
            subsample: int = 4, interpret: bool = False):
    """Add rows ``[span[1], span[2])`` of one radius class onto ``vol``.

    ``vol`` is the flat (gx*gy*gz,) float32 volume (donate it: the kernel
    accumulates in place). ``span = [first, start, end]`` (int32): the
    ``cap`` rows from ``first`` are visited and those in ``[start, end)``
    deposit. ``px``..``r`` are the class-sorted pixel-space columns;
    every particle's radius must be <= ``halfwidth`` pixels (sub-pixel
    particles need ``halfwidth >= 1``).
    """
    grid = tuple(int(g) for g in grid)
    G = grid[0] * grid[1] * grid[2]
    blk = window_block(halfwidth)
    nblk = -(-((2 * halfwidth + 1) ** 3) // blk)
    kernel = functools.partial(
        _deposit_kernel, halfwidth=halfwidth, grid=grid,
        subsample=subsample, blk=blk, interpret=interpret,
    )
    volp = jnp.concatenate([vol, jnp.zeros(blk, vol.dtype)]) if interpret else vol
    out = pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct(
            volp.shape, volp.dtype, vma=jax.typeof(volp).vma
        ),
        grid=(cap, nblk),
        input_output_aliases={6: 0},
        backend="triton",
        compiler_params=pltr.CompilerParams(num_warps=max(1, blk // 128)),
        interpret=interpret,
        name="splat_deposit",
    )(span, px, py, pz, w, r, volp)
    return out[:G] if interpret else out
