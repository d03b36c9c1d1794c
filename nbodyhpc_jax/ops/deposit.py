"""Radius-class splat engines: the production volume deposition.

Semantics are those of :func:`nbodyhpc_jax.ops.splat.splat_volume_oracle`
(reference: rasterization/shaders/triangle.vert:26-70, triangle.frag:14-46
and the volume loop point_renderer.cpp:825-950). The oracle stays the plain
reference; nothing here calls it.

Particles are grouped by radius class with ONE sort, class-major and then by
a coarse spatial cell, so that neighbouring particles deposit together (the
analog of the reference's CPU z-sort, vertex_utilities.cpp:7-12). Class
``c`` holds pixel radii in ``(CLASS_HALF[c-1], CLASS_HALF[c]]`` and deposits
through a static (2R+1)^3 window with ``R = CLASS_HALF[c]`` around the
particle's own voxel: a particle of radius r deposits only within ceil(r)
voxels of its own voxel on every axis (the subcell overlap is zero beyond),
so the window holds every non-zero voxel. Sub-pixel particles ride class 0,
whose R = 1 also holds the z tie-break voxel ``ceil(z) - 1``. Radii above
``CLASS_HALF[-1]`` form the dense class, whose window is sized from its
largest radius (:func:`class_route`); zero-weight rows (ghost capacity
padding) are sorted last and skipped.

Two engines deposit a class:

- ``"plain"``: :func:`~nbodyhpc_jax.ops.splat.footprint_values` on particle
  chunks, then ``vol.at[idx].add`` (XLA scatter-add) into the volume carried
  through a ``lax.scan``. The CPU engine, and the GPU twin of the kernel.
- ``"kernel"``: the fused Pallas Triton kernel
  (:mod:`nbodyhpc_jax.ops.deposit_kernel`), GPU only. It also takes the
  dense class up to 160 px; the plain engine, and the kernel beyond that,
  send the dense class to the dense pass (:mod:`nbodyhpc_jax.ops.splat_dense`).

``engine="auto"`` takes the kernel on a GPU backend and the plain engine on
the CPU (:func:`nbodyhpc_jax.backend.platform`); asking for the kernel on
the CPU raises unless a test passes ``interpret=True``.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from .. import backend
from . import deposit_kernel
from .splat import footprint_values
from .splat_dense import _default_chunk, dense_halfwidth, splat_volume_dense_traced

#: window halfwidth of each radius class (pixels); class c holds radii in
#: (CLASS_HALF[c-1], CLASS_HALF[c]]
CLASS_HALF = (1, 2, 3, 4, 5, 7, 10, 15)
#: class index of the radii above CLASS_HALF[-1]
DENSE = len(CLASS_HALF)
#: window halfwidths at which the kernel takes the dense class (its window
#: blocks run on the second grid axis, at most 65535 programs: R <= 160);
#: larger radii take the dense pass
KERNEL_DENSE_HALF = (20, 28, 40, 56, 80, 112, 160)
#: class index of zero-weight rows (deposit nothing, never visited)
TRASH = DENSE + 1
#: default particles per dispatch: bounds every per-dispatch transient, and
#: each dispatch boundary is a cooperative-cancellation point
MAX_BATCH = 1 << 20
#: window voxels per plain-engine chunk (bounds its (C, F, F, F) blocks)
_PLAIN_ELEMS = 1 << 23
#: coarse spatial cell edge of the sort key, in voxels (log2)
_CELL_SHIFT = 3


def radius_class(rpx, w):
    """Radius class of each row: 0..DENSE by pixel radius, TRASH for
    zero weight."""
    cls = sum((rpx > h).astype(jnp.int32) for h in CLASS_HALF)
    return jnp.where(w == 0.0, TRASH, cls)


def resolve_engine(engine: str = "auto", interpret: bool = False) -> str:
    """Map an engine request to ``"plain"`` or ``"kernel"`` for the current
    backend. The kernel is compiled for the GPU; on the CPU backend only
    ``interpret=True`` (tests) may run it."""
    if engine == "auto":
        return "kernel" if backend.platform() == "gpu" else "plain"
    if engine == "plain":
        return engine
    if engine == "kernel":
        if backend.platform() != "gpu" and not interpret:
            raise ValueError(
                "the deposit kernel is compiled for the GPU and this JAX "
                "backend is the CPU; use engine='plain'"
            )
        return engine
    raise ValueError(f"unknown splat engine {engine!r}")


def _pow2_ceil(x: int) -> int:
    return 1 << max(int(x) - 1, 0).bit_length()


def batch_cap(count: int, batch: int = MAX_BATCH) -> int:
    """Static rows per dispatch for a class of ``count`` rows: a power of
    two >= 128 (so one compiled program serves many workloads), at most
    ``batch`` rounded down to a power of two."""
    top = 1 << (max(int(batch), 128).bit_length() - 1)
    return min(_pow2_ceil(max(int(count), 128)), top)


def _cell_dims(grid):
    shift = _CELL_SHIFT
    while True:
        dims = tuple(-(-int(g) // (1 << shift)) for g in grid)
        if (TRASH + 1) * dims[0] * dims[1] * dims[2] < 2**31:
            return shift, dims
        shift += 1


def sort_by_class(ppx, w, rpx, grid, batch: int = MAX_BATCH):
    """Traced class sort. Returns the sorted ``(px, py, pz, w, rpx)``
    columns (zero-weight rows appended up to :func:`batch_cap` rows so every
    batch slice is in bounds), the class boundaries ``bounds``
    ((TRASH + 2,) int32: class c is rows ``[bounds[c], bounds[c+1])``) and
    the largest dense-class radius."""
    n = w.shape[0]
    shift, (cx, cy, cz) = _cell_dims(grid)
    cls = radius_class(rpx, w)
    c = [
        jnp.clip(jnp.floor(ppx[:, d]).astype(jnp.int32) >> shift, 0, m - 1)
        for d, m in enumerate((cx, cy, cz))
    ]
    ncell = cx * cy * cz
    key = cls * ncell + (c[0] * cy + c[1]) * cz + c[2]
    key, perm = jax.lax.sort(
        (key, jnp.arange(n, dtype=jnp.int32)), num_keys=1
    )
    cols = [ppx[perm, 0], ppx[perm, 1], ppx[perm, 2], w[perm], rpx[perm]]
    pad = batch_cap(n, batch) - n
    if pad > 0:
        fill = (0.0, 0.0, 0.0, 0.0, 1.0)
        cols = [
            jnp.concatenate([a, jnp.full((pad,), f, jnp.float32)])
            for a, f in zip(cols, fill)
        ]
    starts = jnp.arange(TRASH + 1, dtype=jnp.int32) * ncell
    bounds = jnp.concatenate([
        jnp.searchsorted(key, starts).astype(jnp.int32),
        jnp.full((1,), n, jnp.int32),
    ])
    rmax = jnp.max(jnp.where(cls == DENSE, rpx, 0.0)) if n else jnp.float32(0)
    return cols, bounds, rmax


def _plain_class(vol, px, py, pz, w, r, halfwidth, grid, subsample):
    """Plain-engine deposit of ``cap`` prepared rows (masked rows carry
    weight 0) onto the flat volume."""
    gx, gy, gz = grid
    F = 2 * halfwidth + 1
    cap = w.shape[0]
    chunk = 1 << (max(_PLAIN_ELEMS // F**3, 1).bit_length() - 1)
    chunk = min(chunk, cap)
    p = jnp.stack([px, py, pz], axis=1).reshape(cap // chunk, chunk, 3)
    off = jnp.arange(F, dtype=jnp.int32)

    def body(vol, x):
        pc, wc, rc = x
        base, vals = footprint_values(pc, wc, rc, halfwidth, subsample)
        v = [base[:, d:d + 1] + off[None, :] for d in range(3)]
        ok = [(a >= 0) & (a < g) for a, g in zip(v, grid)]
        flat = (
            (v[0][:, :, None, None] * gy + v[1][:, None, :, None]) * gz
            + v[2][:, None, None, :]
        )
        inside = (
            ok[0][:, :, None, None] & ok[1][:, None, :, None]
            & ok[2][:, None, None, :]
        )
        flat = jnp.where(inside, flat, gx * gy * gz)  # dropped below
        vol = vol.at[flat.reshape(-1)].add(vals.reshape(-1), mode="drop")
        return vol, None

    vol, _ = jax.lax.scan(
        body, vol,
        (p, w.reshape(cap // chunk, chunk), r.reshape(cap // chunk, chunk)),
    )
    return vol


def class_route(cls: int, engine: str, max_rpx: float = 0.0):
    """``(route, window halfwidth)`` that deposits class ``cls``: the
    engine with the class's window, and for the dense class (radii above
    15 px, largest ``max_rpx``) the kernel with a window from
    :data:`KERNEL_DENSE_HALF`, or the dense pass when the engine is plain
    or the window outgrows the kernel's grid."""
    if cls < DENSE:
        return engine, CLASS_HALF[cls]
    if engine == "kernel":
        for h in KERNEL_DENSE_HALF:
            if max_rpx <= h:
                return "kernel", h
    return "dense", dense_halfwidth(max_rpx)


def deposit_class(vol, cols, start, end, *, route: str, halfwidth: int,
                  cap: int, grid, subsample: int, interpret: bool = False):
    """Traced deposit of rows ``[start, end)`` of one class — at most
    ``cap`` of them — of the :func:`sort_by_class` columns onto the flat
    volume, by ``route`` ("kernel", "plain" or "dense", see
    :func:`class_route`) with window halfwidth ``halfwidth``."""
    grid = tuple(int(g) for g in grid)
    px, py, pz, w, r = cols
    n = w.shape[0]
    first = jnp.minimum(jnp.asarray(start, jnp.int32), n - cap)
    if route == "kernel":
        span = jnp.stack([first, jnp.asarray(start, jnp.int32),
                          jnp.asarray(end, jnp.int32)])
        return deposit_kernel.deposit(
            vol, span, px, py, pz, w, r, halfwidth=halfwidth, grid=grid,
            cap=cap, subsample=subsample, interpret=interpret,
        )
    rows = first + jnp.arange(cap, dtype=jnp.int32)
    keep = (rows >= start) & (rows < end)
    sl = [jax.lax.dynamic_slice(a, (first,), (cap,)) for a in cols]
    ws = jnp.where(keep, sl[3], 0.0)
    rs = jnp.where(keep, sl[4], 1.0)
    if route == "plain":
        return _plain_class(vol, sl[0], sl[1], sl[2], ws, rs, halfwidth,
                            grid, subsample)
    chunk = min(_default_chunk(2 * halfwidth + 1), cap)
    out = splat_volume_dense_traced(
        jnp.stack(sl[:3], axis=1), ws, rs, grid, halfwidth, subsample,
        vol0=vol.reshape(grid), chunk=chunk,
    )
    return out.reshape(-1)


_deposit_jit = jax.jit(
    deposit_class,
    static_argnames=("route", "halfwidth", "cap", "grid", "subsample",
                     "interpret"),
    donate_argnums=(0,),
)
_sort_jit = jax.jit(sort_by_class, static_argnames=("grid", "batch"))


@jax.jit
def _to_pixels(positions, weights, radii, ppu):
    return (
        jnp.asarray(positions, jnp.float32) * ppu,
        jnp.asarray(weights, jnp.float32),
        jnp.asarray(radii, jnp.float32) * ppu,
    )


def splat_volume(positions, weights, radii, pixels_per_unit: float, grid,
                 subsample: int = 4, engine: str = "auto",
                 batch: int = MAX_BATCH, interpret: bool = False):
    """Render a 3D density field; numpy or device inputs (non-periodic or
    pre-augmented), device-resident (gx, gy, gz) float32 result.

    One sort groups the particles by class, one small readback sizes the
    class batches, then each batch of at most ``batch`` rows is one
    dispatch onto the donated volume. The host waits for each dispatch
    before issuing the next, so Ctrl-C lands within one batch (the
    reference polls its fence in 20 ms slices, point_renderer.cpp:797-818).
    """
    engine = resolve_engine(engine, interpret)
    grid = tuple(int(g) for g in grid)
    G = grid[0] * grid[1] * grid[2]
    if G >= 2**31:
        raise ValueError(f"grid {grid} has more than 2^31 voxels")
    ppx, w, rpx = _to_pixels(positions, weights, radii,
                             jnp.float32(pixels_per_unit))
    vol = jnp.zeros((G,), jnp.float32)
    if w.shape[0] == 0:
        return vol.reshape(grid)
    cols, bounds, rmax = _sort_jit(ppx, w, rpx, grid, batch)
    bounds, rmax = jax.device_get((bounds, rmax))
    bounds = [int(b) for b in bounds]
    for c in range(DENSE + 1):
        lo, hi = bounds[c], bounds[c + 1]
        if hi <= lo:
            continue
        cap = batch_cap(hi - lo, batch)
        route, half = class_route(c, engine, float(rmax))
        for s in range(lo, hi, cap):
            vol = _deposit_jit(
                vol, cols, s, hi, route=route, halfwidth=half, cap=cap,
                grid=grid, subsample=subsample, interpret=interpret,
            )
            vol.block_until_ready()
    return vol.reshape(grid)


def class_counts(rpx, w):
    """Per-class row counts (DENSE + 1,) and the largest pixel radius —
    the static sizes :func:`splat_volume_traced` needs. Numpy or device
    inputs; one readback."""
    cnt, mx = _class_stats(jnp.asarray(rpx, jnp.float32),
                           jnp.asarray(w, jnp.float32))
    cnt, mx = jax.device_get((cnt, mx))
    return tuple(int(v) for v in cnt), float(mx)


@jax.jit
def _class_stats(rpx, w):
    cls = radius_class(rpx, w)
    cnt = jnp.stack([jnp.sum(cls == c, dtype=jnp.int32)
                     for c in range(DENSE + 1)])
    mx = jnp.max(rpx) if rpx.shape[0] else jnp.float32(0)
    return cnt, mx


def splat_volume_traced(ppx, w, rpx, grid, subsample: int, *, counts,
                        max_rpx: float, engine: str, batch: int = MAX_BATCH,
                        interpret: bool = False):
    """Fully traced render (jit / ``shard_map`` composable) of pixel-space
    inputs onto a fresh (gx, gy, gz) volume.

    ``counts`` (static, per class, from :func:`class_counts`) bound each
    class's rows in ``ppx``; a class is visited in ``ceil(count / cap)``
    static batches whose rows past the class end are masked, so any
    per-device subset of the counted set renders exactly. ``max_rpx``
    sizes the dense class's window. ``engine`` must already be resolved.
    """
    grid = tuple(int(g) for g in grid)
    n = w.shape[0]
    cols, bounds, _ = sort_by_class(ppx, w, rpx, grid, batch)
    vol = jnp.zeros((grid[0] * grid[1] * grid[2],), jnp.float32) + cols[0][0] * 0.0
    for c in range(DENSE + 1):
        cnt = min(int(counts[c]), n)
        if not cnt:
            continue
        cap = batch_cap(cnt, batch)
        route, half = class_route(c, engine, max_rpx)
        for b in range(-(-cnt // cap)):
            vol = deposit_class(
                vol, cols, bounds[c] + b * cap, bounds[c + 1], route=route,
                halfwidth=half, cap=cap, grid=grid, subsample=subsample,
                interpret=interpret,
            )
    return vol.reshape(grid)
