"""Dense-window deposition for large radii — the device path above the
deposit engine's largest radius class (15 px).

The reference renders arbitrarily large points on the GPU: the vertex shader
sets an unbounded ``gl_PointSize = 2*ceil(plane_radius*ppu) + 2`` (reference:
rasterization/shaders/triangle.vert:43-44,63) and the volume loop only widens
its cull margin by the max radius (rasterization/src/cpp/
point_renderer.cpp:857-862). The radius classes of the deposit engine
(:mod:`nbodyhpc_jax.ops.deposit`) stop at 15 px, so radii above that take
this module's route instead — the "coarse-grid pass" of SURVEY.md §7.3(2):

- Each particle's footprint is evaluated *densely* on a static F^3 window
  (F = 2*halfwidth + 1) by :func:`nbodyhpc_jax.ops.splat.footprint_values`,
  so per-voxel values are bit-identical to the oracle (same function, same
  f32 association order).
- The window origin is **clamped inside the grid** (the volume is padded so
  every axis is >= F). Because every formula in ``footprint_values`` is
  elementwise in absolute voxel coordinates, a clamped window still covers
  exactly footprint ∩ grid, and voxels it adds outside the true footprint
  contribute exactly zero — no masking or wrap-around shift is needed.
- Windows are accumulated by a sequential dynamic-slice read-modify-write
  (``lax.fori_loop`` keeps the volume in place), replacing the oracle's XLA
  scatter-add with contiguous block adds. Large radii are a tail
  population (~1e-4 of a CAMELS-like set), so a sequential per-particle
  loop is affordable.

Halfwidth buckets are geometric so the number of compiled programs stays
bounded across workloads; radii beyond the last bucket fall back to the exact
required halfwidth (unbounded radius support, one extra compile).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .splat import footprint_values, required_halfwidth

#: geometric halfwidth ladder; bucket R covers pixel radii <= R - 3
#: (required_halfwidth = ceil(rpx) + 3). The deposit engine sends this
#: pass only radii above 15 px, so in practice it starts at R = 20.
HALF_BUCKETS = (12, 20, 36, 68, 132, 260)


def dense_halfwidth(max_rpx: float) -> int:
    """Smallest bucket halfwidth covering ``max_rpx``; exact halfwidth when
    beyond the ladder (unbounded radii, at the cost of one extra compile)."""
    need = required_halfwidth(max_rpx)
    for r in HALF_BUCKETS:
        if need <= r:
            return r
    return need


def _default_chunk(F: int) -> int:
    """Particles per footprint-evaluation chunk: bounds the (chunk, F, F, F)
    transient to ~16 MiB of f32 while keeping the batch wide."""
    c = max(1, (1 << 22) // (F * F * F))
    p = 1
    while p * 2 <= min(c, 256):
        p *= 2
    return p


def splat_volume_dense_traced(ppx, w, rpx, grid, halfwidth: int,
                              subsample: int = 4, vol0=None,
                              chunk: int | None = None):
    """Fully-traced dense deposition (jit / shard_map composable).

    Pixel-space positions/radii, static ``halfwidth`` (window F = 2R+1) and
    ``grid``; particle count must be a multiple of ``chunk`` (pad with
    weight 0). Returns the (gx, gy, gz) field, accumulated onto ``vol0``
    when given.
    """
    gx, gy, gz = (int(v) for v in grid)
    R = int(halfwidth)
    F = 2 * R + 1
    if chunk is None:
        chunk = _default_chunk(F)
    n = ppx.shape[0]
    assert n % chunk == 0, (n, chunk)
    nchunks = n // chunk

    # pad every axis to >= F so a clamped window always fits inside
    gxp, gyp, gzp = max(gx, F), max(gy, F), max(gz, F)
    if vol0 is None:
        vol = jnp.zeros((gxp, gyp, gzp), jnp.float32) + ppx[0, 0] * 0.0
    else:
        vol = vol0
        if (gxp, gyp, gzp) != (gx, gy, gz):
            vol = jnp.pad(
                vol, ((0, gxp - gx), (0, gyp - gy), (0, gzp - gz))
            )
    lim = jnp.asarray([gxp - F, gyp - F, gzp - F], jnp.int32)

    def chunk_body(vol, i):
        s = i * chunk
        p = jax.lax.dynamic_slice(ppx, (s, 0), (chunk, 3))
        wc = jax.lax.dynamic_slice(w, (s,), (chunk,))
        rc = jax.lax.dynamic_slice(rpx, (s,), (chunk,))
        b0 = jnp.floor(p).astype(jnp.int32) - R
        cb = jnp.clip(b0, 0, lim[None, :])
        _, vals = footprint_values(p, wc, rc, R, subsample, base=cb)

        def body(c, vol):
            at = (cb[c, 0], cb[c, 1], cb[c, 2])
            win = jax.lax.dynamic_slice(vol, at, (F, F, F))
            return jax.lax.dynamic_update_slice(vol, win + vals[c], at)

        return jax.lax.fori_loop(0, chunk, body, vol), None

    vol, _ = jax.lax.scan(chunk_body, vol, jnp.arange(nchunks))
    return vol[:gx, :gy, :gz]


@functools.partial(
    jax.jit,
    static_argnames=("grid", "halfwidth", "subsample", "chunk"),
    donate_argnums=(3,),
)
def _dense_add(ppx, w, rpx, vol0, grid, halfwidth, subsample, chunk):
    return splat_volume_dense_traced(
        ppx, w, rpx, grid, halfwidth, subsample, vol0, chunk
    )


def splat_volume_dense(positions_px, weights, radii_px, grid,
                       subsample: int = 4, vol0=None,
                       max_radius_px: float | None = None):
    """Render (or accumulate onto ``vol0``) the dense large-radius pass.

    Takes pixel-space positions/radii (numpy or device). The footprint
    halfwidth is picked from :data:`HALF_BUCKETS` via ``max_radius_px``
    (computed — one readback for device inputs — when not given). Returns a
    device-resident (gx, gy, gz) float32 array; ``vol0`` is donated.
    """
    grid = tuple(int(v) for v in grid)
    device_in = isinstance(positions_px, jnp.ndarray)
    if not device_in:
        positions_px = np.asarray(positions_px, np.float32)
        weights = np.asarray(weights, np.float32)
        radii_px = np.asarray(radii_px, np.float32)
    n = positions_px.shape[0]
    if n == 0:
        return vol0 if vol0 is not None else jnp.zeros(grid, jnp.float32)
    if max_radius_px is None:
        max_radius_px = float(jnp.max(radii_px)) if device_in else float(
            radii_px.max()
        )
    R = dense_halfwidth(max_radius_px)
    chunk = _default_chunk(2 * R + 1)
    n_pad = (n + chunk - 1) // chunk * chunk
    if n_pad > n:
        pad = n_pad - n
        if device_in:
            positions_px = jnp.concatenate(
                [positions_px, jnp.zeros((pad, 3), jnp.float32)]
            )
            weights = jnp.concatenate([weights, jnp.zeros(pad, jnp.float32)])
            radii_px = jnp.concatenate(
                [radii_px, jnp.ones(pad, jnp.float32)]
            )
        else:
            positions_px = np.pad(positions_px, ((0, pad), (0, 0)))
            weights = np.pad(weights, (0, pad))
            radii_px = np.pad(radii_px, (0, pad), constant_values=1.0)
    if vol0 is None:
        vol0 = jnp.zeros(grid, jnp.float32)
    return _dense_add(
        jnp.asarray(positions_px), jnp.asarray(weights),
        jnp.asarray(radii_px), vol0, grid, R, subsample, chunk,
    )
