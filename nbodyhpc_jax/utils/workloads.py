"""Seeded workloads and physics audits shared by ``bench.py`` and
``chip_smoke.py``.

The splat workload is the reference's CAMELS shape (reference:
rasterization/README.md:27-31): particles uniform in the unit box, unit
weights, radii lognormal (sigma 0.35, unclipped above) around the mean
interparticle spacing, rendered periodic at subsample 4. Everything is
generated on the device from a seed.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.splat import footprint_values, required_halfwidth


@functools.partial(jax.jit, static_argnames=("n", "grid", "sigma"))
def camels_particles(key, n: int, grid: int, sigma: float = 0.35):
    """``(positions (n, 3), weights (n,), radii (n,))`` in box units for a
    unit box rendered at ``grid`` pixels per unit: radii lognormal around
    the mean spacing ``grid / n^(1/3)`` pixels, floored at 0.1 px."""
    kp, kr = jax.random.split(key)
    pos = jax.random.uniform(kp, (n, 3), jnp.float32)
    spacing_px = grid / n ** (1.0 / 3.0)
    rpx = jnp.maximum(
        jnp.exp(jax.random.normal(kr, (n,), jnp.float32) * sigma) * spacing_px,
        0.1,
    )
    return pos, jnp.ones((n,), jnp.float32), rpx / np.float32(grid)


def expected_mass_ratio(ppx_sample, rpx_sample, subsample: int = 4,
                        chunk: int = 512):
    """Mass a particle deposits per unit weight, averaged over a sample of
    pixel-space positions and radii: the un-gridded footprint integral
    (centered windows, no clipping). Subcell-center counting deposits
    slightly under the weight at small radii (reference
    triangle.frag:25-45, triangle.vert:41-45), so a rendered total is
    audited against this, not against 1."""
    ppx_sample = np.asarray(ppx_sample, np.float32)
    rpx_sample = np.asarray(rpx_sample, np.float32)
    hw = required_halfwidth(float(rpx_sample.max()))
    total = 0.0
    for s in range(0, rpx_sample.shape[0], chunk):
        total += float(_chunk_mass(
            jnp.asarray(ppx_sample[s:s + chunk]),
            jnp.asarray(rpx_sample[s:s + chunk]), hw, subsample,
        ))
    return total / rpx_sample.shape[0]


@functools.partial(jax.jit, static_argnames=("hw", "subsample"))
def _chunk_mass(ppx, rpx, hw, subsample):
    _, vals = footprint_values(ppx, jnp.ones_like(rpx), rpx, hw, subsample)
    return jnp.sum(vals, dtype=jnp.float32)


def subcell_quantum(w, rpx, subsample: int = 4) -> float:
    """Largest deposit one subcell carries for any particle that counts
    subcells (pixel radius >= 0.5): ``w / (4/3 pi r^3) / S^3``."""
    w = np.asarray(w, np.float64)
    rpx = np.asarray(rpx, np.float64)
    big = rpx >= 0.5
    if not big.any():
        return 0.0
    return float((np.abs(w[big]) / (4.0 / 3.0 * np.pi * rpx[big] ** 3)).max()
                 / subsample**3)


def field_parity(got, want, quantum: float):
    """Compare two renders of one particle set (device or numpy arrays).

    Two compilers may place fused multiply-adds differently in the subcell
    test ``az < r^2 - (ax + ay)``, which flips a subcell whose margin is
    within an ulp of r^2: that voxel then differs by one subcell quantum.
    So each voxel is either within float32 summation round-off
    (``1e-5 |want| + 1e-7 max|want|``) or a flip, which must stay within
    round-off plus ``quantum`` (:func:`subcell_quantum`) and be rare.
    Returns the residuals and ``ok``: max-abs within the flip bound, flips
    in at most 1e-4 of the voxels, relative L2 at most 1e-4.
    """
    got = jnp.asarray(got)
    want = jnp.asarray(want)
    d = jnp.abs(got - want)
    scale = float(jnp.max(jnp.abs(want)))
    roundoff = 1e-5 * jnp.abs(want) + 1e-7 * scale
    max_abs = float(jnp.max(d))
    flips = int(jnp.sum(d > roundoff))
    worst = float(jnp.max(d - roundoff))
    rel_l2 = float(jnp.sqrt(jnp.sum(d * d)) / jnp.sqrt(jnp.sum(want * want)))
    frac = flips / d.size
    return {
        "max_abs": max_abs, "rel_l2": rel_l2, "flips": flips,
        "flip_frac": frac, "worst_over_roundoff": worst, "quantum": quantum,
        "scale": scale,
        "ok": worst <= quantum and frac <= 1e-4 and rel_l2 <= 1e-4,
    }
