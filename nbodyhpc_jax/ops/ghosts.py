"""Periodic ghost-particle augmentation (host-side preprocessing).

Exact functional mirror of the reference's CPU vertex pre-processing
(reference: rasterization/src/cpp/vertex_utilities.cpp:13-43): for each
periodic dimension (box size > 0), any particle whose sphere crosses the 0 or L
face is cloned to the wrapped position; dimensions are processed sequentially
so corner-crossing particles spawn all combinations (up to 7 clones, more if a
diameter exceeds the box). Runs eagerly in numpy, like the reference runs it on
the CPU before upload — ghost counts are data-dependent and must not enter the
jitted path.
"""
from __future__ import annotations

import functools

import numpy as np


def augment_points_periodic(positions, weights, radii, box_size):
    """Clone boundary-crossing particles across periodic faces.

    Parameters mirror ``wenda::augment_vertices_periodic``: ``box_size`` is a
    3-sequence; entries <= 0 disable periodicity for that dimension.

    Returns (positions, weights, radii) with clones appended.
    """
    positions = np.asarray(positions, np.float32)
    weights = np.asarray(weights, np.float32)
    radii = np.asarray(radii, np.float32)

    for dim in range(3):
        L = float(box_size[dim])
        if L <= 0:
            continue
        hi = positions[:, dim] + radii > L
        lo = positions[:, dim] - radii < 0.0
        clones = []
        for mask, shift in ((hi, -L), (lo, +L)):
            if np.any(mask):
                p = positions[mask].copy()
                p[:, dim] += shift
                clones.append((p, weights[mask], radii[mask]))
        if clones:
            positions = np.concatenate([positions] + [c[0] for c in clones])
            weights = np.concatenate([weights] + [c[1] for c in clones])
            radii = np.concatenate([radii] + [c[2] for c in clones])
    return positions, weights, radii


#: clone-capacity rounding: static program shapes recur across runs when
#: counts land in the same capacity bucket, so the big gather/concat
#: programs hit the in-process jit cache AND the persistent compile cache
#: instead of recompiling for every data-dependent count (measured: the old
#: exact-size eager path cost ~82 s at 1e8 purely in per-process compiles +
#: dispatch). The quantum scales with n (n is part of the program shape
#: anyway) so small inputs don't drown in pad rows: <= ~1.6% of n, capped
#: at 64k.
def _cap(cnt: int, n: int) -> int:
    if not cnt:
        return 0
    q = 64
    while q < min(1 << 16, n // 64):
        q <<= 1
    return min(n, -(-cnt // q) * q)


@functools.lru_cache(maxsize=64)
def _count_all_fn(box):
    """ALL six per-dimension clone counts from the ORIGINAL array in one
    program — one host sync for the whole augmentation instead of one per
    dimension. The dim-sequential semantics are reproduced by row
    multiplicities: a clone keeps its source's other-dim coordinates and
    radius, so after processing dim d a row exists with multiplicity
    prod_{d' <= d} (1 + hi_d' + lo_d') and dim d's clone count is
    sum(mult_before_d * mask_d). Capacity-pad rows never enter (they are
    appended with radius 0 / box-center positions and cross no face)."""
    import jax
    import jax.numpy as jnp

    def count(positions, radii):
        mult = jnp.ones(positions.shape[0], jnp.int32)
        out = []
        for dim in range(3):
            L = box[dim]
            if L <= 0:
                out.append(jnp.zeros(2, jnp.int32))
                continue
            x = positions[:, dim]
            hi = (x + radii > L).astype(jnp.int32)
            lo = (x - radii < 0.0).astype(jnp.int32)
            out.append(jnp.stack([
                jnp.sum(mult * hi, dtype=jnp.int32),
                jnp.sum(mult * lo, dtype=jnp.int32),
            ]))
            mult = mult * (1 + hi + lo)
        return jnp.stack(out)

    return jax.jit(count)


@functools.lru_cache(maxsize=64)
def _step_fn(dim: int, L: float, cap_hi: int, cap_lo: int):
    """One fused program: recompute face masks, gather the clones into
    quantized-capacity slots (pad rows get weight 0, radius 0, box-center
    position so they can never deposit mass or re-clone in a later dim),
    and append. Static shape key = (n via trace, cap_hi, cap_lo, dim)."""
    import jax
    import jax.numpy as jnp

    def step(positions, weights, radii, nhi, nlo):
        x = positions[:, dim]
        segs_p = [positions]
        segs_w = [weights]
        segs_r = [radii]
        for cap, cnt, mask, shift in (
            (cap_hi, nhi, x + radii > L, jnp.float32(-L)),
            (cap_lo, nlo, x - radii < 0.0, jnp.float32(+L)),
        ):
            if not cap:
                continue
            idx = jnp.nonzero(mask, size=cap, fill_value=0)[0]
            valid = jnp.arange(cap, dtype=jnp.int32) < cnt
            p = positions[idx].at[:, dim].add(shift)
            p = jnp.where(valid[:, None], p, jnp.float32(0.5 * L))
            segs_p.append(p)
            segs_w.append(jnp.where(valid, weights[idx], 0.0))
            segs_r.append(jnp.where(valid, radii[idx], 0.0))
        return (
            jnp.concatenate(segs_p),
            jnp.concatenate(segs_w),
            jnp.concatenate(segs_r),
        )

    return jax.jit(step, donate_argnums=(0, 1, 2))


@functools.lru_cache(maxsize=64)
def _trim_fn(n: int, cap_hi: int, cap_lo: int, nhi: int, nlo: int):
    """Exact compaction to host-order parity: drop the pad tails of both
    face segments. One program per count combination — only the exact
    (pad_ok=False) path pays it; perf callers skip the trim entirely."""
    import jax
    import jax.numpy as jnp

    def trim(positions, weights, radii):
        outs = []
        for a in (positions, weights, radii):
            segs = [a[:n]]
            if nhi:
                segs.append(a[n:n + nhi])
            if nlo:
                segs.append(a[n + cap_hi:n + cap_hi + nlo])
            outs.append(jnp.concatenate(segs) if len(segs) > 1 else segs[0])
        return tuple(outs)

    return jax.jit(trim, donate_argnums=(0, 1, 2))


def augment_points_periodic_device(positions, weights, radii, box_size,
                                    pad_ok: bool = False):
    """Device-resident variant of :func:`augment_points_periodic`.

    Identical dim-sequential clone semantics and output ordering (hi-face
    clones then lo-face clones per dimension, ascending source index).
    Ghost counts are data-dependent, so the augmentation pays ONE small
    host sync up front — all six per-dimension counts are predicted from
    the original array by multiplicity products (see ``_count_all_fn``) —
    to size the clone gathers; the gather/append itself is ONE jitted
    program per dimension with clone capacity rounded up to a quantum,
    so program shapes recur across runs and persist in
    the compile cache instead of recompiling for every count. Capacity
    padding rows are inert (weight 0, radius 0, box-center position —
    they deposit no mass and never re-clone in a later dimension):
    with ``pad_ok=True`` they are left in place (zero per-count programs;
    the bulk-render path, which sorts and mass-weights everything anyway,
    uses this) and with the default ``pad_ok=False`` a per-dimension trim
    restores exact row-for-row parity with the host version. Use this
    when the particle set already lives on device — at 1e8 particles the
    host version costs minutes of single-core numpy plus a full
    re-upload. The row gathers here are prep, not hot-path (the no-gather
    invariant applies to the per-voxel deposit/query loops, not to a
    one-off boundary compaction).
    """
    box = tuple(float(v) for v in box_size)
    counts = np.asarray(_count_all_fn(box)(positions, radii))  # ONE sync
    for dim in range(3):
        L = box[dim]
        if L <= 0:
            continue
        n = positions.shape[0]
        nhi, nlo = int(counts[dim, 0]), int(counts[dim, 1])
        if not (nhi or nlo):
            continue
        cap_hi, cap_lo = _cap(nhi, n), _cap(nlo, n)
        positions, weights, radii = _step_fn(dim, L, cap_hi, cap_lo)(
            positions, weights, radii, nhi, nlo
        )
        if not pad_ok and (cap_hi != nhi or cap_lo != nlo):
            positions, weights, radii = _trim_fn(
                n, cap_hi, cap_lo, nhi, nlo
            )(positions, weights, radii)
    return positions, weights, radii
