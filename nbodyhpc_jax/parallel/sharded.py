"""Sharded (multi-device) render and query pipelines over a 1D device mesh.

The grid's z axis is sharded into slabs (one per device) — the mesh promotion
of the reference's z-slice streaming (reference: rasterization/src/cpp/
point_renderer.cpp:857-946). Particles are partitioned into matching slabs on
the host; particles whose splat footprint crosses a slab boundary are
exchanged with the neighbor device via ``lax.ppermute`` halo bands, the direct
analog of the reference's ``max_radius`` cull margin (point_renderer.cpp:
857-862) and ghost augmentation (vertex_utilities.cpp:13-43). k-NN queries are
data-parallel: the cell-list is replicated, query batches are sharded.

Every function here is exercised on a virtual 8-device CPU mesh in tests and
is the code path ``__graft_entry__.dryrun_multichip`` compiles.
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core.cells import CellList
from ..core.points import round_up
from ..ops import knn as _knn
from ..ops import deposit as _deposit
from ..ops.ghosts import (
    augment_points_periodic,
    augment_points_periodic_device,
)
from .mesh import make_slab_mesh

#: extra z margin (pixels) beyond the pixel radius that a splat can reach
#: (coverage square + sub-pixel snap), mirroring the reference's cull margin.
Z_MARGIN = 2.0


def _band_select(arrs, mask, cap):
    """Compact masked rows into a fixed-size band buffer (static shapes).

    Returns (band arrays, valid mask, overflow count). Invalid band slots get
    weight zero.
    """
    n = mask.shape[0]
    order = jnp.argsort(~mask, stable=True)  # masked rows first
    sel = order[:cap]
    valid = mask[sel]
    out = []
    for a in arrs:
        b = a[sel]
        out.append(jnp.where(valid if b.ndim == 1 else valid[:, None], b, 0.0))
    overflow = jnp.maximum(jnp.sum(mask.astype(jnp.int32)) - cap, 0)
    return out, valid, overflow


def _render_shard_fn(gx, gy, gz_loc, subsample, cap, axis, hops, counts,
                     max_rpx, engine, batch):
    """Per-device slab renderer with ppermute halo exchange.

    The slab is rendered by the production radius-class engine in traced
    form (:func:`nbodyhpc_jax.ops.deposit.splat_volume_traced`). Its static
    per-class bounds ``counts`` are the GLOBAL class counts, which bound
    every device's own rows plus the bands it receives (each particle
    reaches a device at most once), so no class can overflow. ``hops`` is
    the halo depth in slabs: a footprint can reach ``max_rpx + Z_MARGIN``
    pixels past its center, so when slabs are shallower than that, bands
    are exchanged with devices up to ceil(reach / gz_loc) slabs away, not
    just the adjacent ones."""

    def f(ppx, w, rpx):
        s = jax.lax.axis_index(axis)
        nd = jax.lax.axis_size(axis)
        z0 = (s * gz_loc).astype(jnp.float32)

        parts_p, parts_w, parts_r = [ppx], [w], [rpx]
        overflow = jnp.int32(0)
        # bands nest (the hop-h band is a subset of the hop-(h-1) band), so
        # hop 1 compacts from the full local set and deeper hops re-select
        # from the previous hop's cap-sized band — one O(n log n) pass total
        # instead of one per hop
        lo_src = hi_src = (ppx, w, rpx)
        for h in range(1, hops + 1):
            # band for the slab h below: footprint reaches under that
            # slab's top face; band for the slab h above symmetrically.
            # Edge devices (no receiver at distance h) neither send nor
            # count overflow: their discarded band must not flag an exact
            # render as overflowed.
            zlo, wlo = lo_src[0][:, 2], lo_src[1]
            zhi, whi = hi_src[0][:, 2], hi_src[1]
            cross_lo = (
                (zlo - (lo_src[2] + Z_MARGIN) < z0 - (h - 1) * gz_loc)
                & (wlo != 0.0) & (s >= h)
            )
            cross_hi = (
                (zhi + hi_src[2] + Z_MARGIN >= z0 + h * gz_loc)
                & (whi != 0.0) & (s < nd - h)
            )

            (blo_p, blo_w, blo_r), _, ov_lo = _band_select(
                lo_src, cross_lo, cap
            )
            (bhi_p, bhi_w, bhi_r), _, ov_hi = _band_select(
                hi_src, cross_hi, cap
            )
            lo_src = (blo_p, blo_w, blo_r)
            hi_src = (bhi_p, bhi_w, bhi_r)

            perm_dn = [(i, i - h) for i in range(h, nd)]
            perm_up = [(i, i + h) for i in range(nd - h)]
            r_hi = [
                jax.lax.ppermute(x, axis, perm_dn)
                for x in (blo_p, blo_w, blo_r)
            ]
            r_lo = [
                jax.lax.ppermute(x, axis, perm_up)
                for x in (bhi_p, bhi_w, bhi_r)
            ]
            parts_p += [r_lo[0], r_hi[0]]
            parts_w += [r_lo[1], r_hi[1]]
            parts_r += [r_lo[2], r_hi[2]]
            overflow = overflow + ov_lo + ov_hi

        all_p = jnp.concatenate(parts_p, axis=0)
        all_w = jnp.concatenate(parts_w)
        all_r = jnp.concatenate(parts_r)
        all_r = jnp.where(all_w != 0.0, all_r, 1.0)  # NaN-safe padding

        local = all_p - jnp.asarray([0.0, 0.0, 1.0]) * z0
        dens = _deposit.splat_volume_traced(
            local, all_w, all_r, (gx, gy, gz_loc), subsample,
            counts=counts, max_rpx=max_rpx, engine=engine, batch=batch,
        )
        return dens, jax.lax.psum(overflow, axis)

    return f


def _partition_slabs_device(ppx, weights, rpx, gz_loc, nd):
    """Device-side slab partition: one stable multi-operand sort lays the
    particles out as (nd, nloc) with zero-weight pad rows at each slab's
    tail — no host pass over the particles, no gather/scatter.

    Pad rows are appended AFTER the real rows and keyed by the slab that
    needs them (``searchsorted`` over the per-slab pad budget), so one
    stable sort by slab id places every slab's reals first, pads last.
    The only host syncs are the per-slab counts ((nd,) int32, sizes
    ``nloc``).
    """
    import jax.numpy as jnp

    n = ppx.shape[0]
    slab = jnp.clip(
        jnp.floor(ppx[:, 2] / gz_loc).astype(jnp.int32), 0, nd - 1
    )
    counts = np.asarray(jnp.bincount(slab, length=nd))
    nloc = round_up(max(int(counts.max()), 1), 256)
    npads = nd * nloc - n
    pad_cum = jnp.cumsum(jnp.asarray(nloc - counts, jnp.int32))
    pad_slab = jnp.searchsorted(
        pad_cum, jnp.arange(npads, dtype=jnp.int32), side="right"
    ).astype(jnp.int32)
    key = jnp.concatenate([slab, pad_slab])
    px = jnp.concatenate([ppx[:, 0], jnp.zeros(npads, jnp.float32)])
    py = jnp.concatenate([ppx[:, 1], jnp.zeros(npads, jnp.float32)])
    pz = jnp.concatenate([ppx[:, 2], jnp.zeros(npads, jnp.float32)])
    ws = jnp.concatenate([weights, jnp.zeros(npads, jnp.float32)])
    rs = jnp.concatenate([rpx, jnp.ones(npads, jnp.float32)])
    _, px, py, pz, ws, rs = jax.lax.sort(
        (key, px, py, pz, ws, rs), num_keys=1, is_stable=True
    )
    p_sh = jnp.stack([px, py, pz], axis=-1).reshape(nd, nloc, 3)
    return p_sh, ws.reshape(nd, nloc), rs.reshape(nd, nloc), nloc


def render_points_volume_sharded(
    positions,
    weights,
    radii,
    pixels_per_unit: float,
    grid,
    periodic=False,
    mesh: Mesh | None = None,
    subsample: int = 4,
    band_cap: int | None = None,
    batch: int | None = None,
) -> Tuple[np.ndarray, int]:
    """Render a z-slab-sharded density volume over the mesh.

    Semantics match :func:`nbodyhpc_jax.rasterizer.render_points_volume`
    (periodic wrap via ghost augmentation). Returns (volume (gx, gy, gz),
    halo-band overflow count) — overflow must be 0 for an exact result; grow
    ``band_cap`` otherwise.

    Inputs may be numpy (host partition, mirrors the reference's CPU
    pre-processing) or device arrays (everything — ghost augmentation, slab
    partition, the render itself — stays on the device; the host sees only the
    per-slab counts). ``batch`` bounds each device's per-batch particle
    working set: the per-shard engine deposits every radius class in
    static slices of at most ``batch`` rows, the memory-bounding analog of
    the reference's slice streaming (reference point_renderer.cpp:864-946);
    default :data:`nbodyhpc_jax.ops.deposit.MAX_BATCH`.
    """
    if mesh is None:
        mesh = make_slab_mesh()
    axis = mesh.axis_names[0]
    nd = mesh.devices.size

    gx, gy, gz = (int(v) for v in (grid if not np.isscalar(grid) else (grid,) * 3))
    if gz % nd != 0:
        raise ValueError(f"grid z ({gz}) must divide over {nd} devices")
    gz_loc = gz // nd

    device_in = isinstance(positions, jnp.ndarray)
    if not device_in:
        positions = np.ascontiguousarray(positions, np.float32)
        weights = np.ascontiguousarray(weights, np.float32)
        radii = np.ascontiguousarray(radii, np.float32)

    if periodic is True:
        period = (gx / pixels_per_unit, gy / pixels_per_unit, gz / pixels_per_unit)
    elif periodic is False:
        period = (-1.0, -1.0, -1.0)
    else:
        period = tuple(float(v) for v in np.broadcast_to(periodic, (3,)))
    if any(p > 0 for p in period):
        if device_in:
            # pad_ok: capacity-padding rows are inert (weight 0, radius 0)
            # and the slab partition/deposit mass-weights everything, so
            # skipping the exact trim costs nothing and keeps the clone
            # program shapes recurring (see ghosts._CAP_QUANTUM)
            positions, weights, radii = augment_points_periodic_device(
                positions, weights, radii, period, pad_ok=True
            )
        else:
            positions, weights, radii = augment_points_periodic(
                positions, weights, radii, period
            )

    ppx = positions * pixels_per_unit
    rpx = radii * pixels_per_unit
    # global per-class counts: static bounds for every device's class
    # batches (one readback)
    class_counts, max_rpx = _deposit.class_counts(rpx, weights)
    engine = _deposit.resolve_engine()

    if device_in:
        p_sh, w_sh, r_sh, nloc = _partition_slabs_device(
            ppx, weights, rpx, gz_loc, nd
        )
    else:
        # host partition into slabs by particle center
        slab = np.clip((ppx[:, 2] // gz_loc).astype(np.int64), 0, nd - 1)
        order = np.argsort(slab, kind="stable")
        counts = np.bincount(slab, minlength=nd)
        nloc = round_up(max(int(counts.max()), 1), 256)
        p_sh = np.zeros((nd, nloc, 3), np.float32)
        w_sh = np.zeros((nd, nloc), np.float32)
        r_sh = np.ones((nd, nloc), np.float32)
        off = 0
        for d in range(nd):
            c = int(counts[d])
            idx = order[off : off + c]
            p_sh[d, :c] = ppx[idx]
            w_sh[d, :c] = weights[idx]
            r_sh[d, :c] = rpx[idx]
            off += c

    if band_cap is None:
        # expected crossing fraction under a uniform-z population: a
        # footprint reaches max_rpx + Z_MARGIN past its center, so a slab
        # of depth gz_loc sends ~min(1, reach/gz_loc) of its rows per
        # direction; headroom of nloc/8 (min 256) absorbs clustering.
        frac = min(1.0, (max_rpx + Z_MARGIN) / gz_loc)
        band_cap = round_up(
            min(nloc, int(frac * nloc) + max(256, nloc // 8)), 256
        )
    if batch is None:
        batch = _deposit.MAX_BATCH

    hops = min(nd - 1, max(1, int(np.ceil((max_rpx + Z_MARGIN) / gz_loc))))
    fn = _render_shard_fn(gx, gy, gz_loc, subsample, band_cap, axis, hops,
                          class_counts, max_rpx, engine, batch)
    mapped = shard_map(
        fn,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis)),
        out_specs=(P(None, None, axis), P()),
    )
    # flatten the device axis into the shard axis; the stacked inputs are
    # placed slab by slab on their devices (not staged on device 0)
    jf = jax.jit(
        lambda p, w, r: mapped(
            p.reshape(-1, 3), w.reshape(-1), r.reshape(-1)
        )
    )
    shard = NamedSharding(mesh, P(axis))
    dens, overflow = jf(*(jax.device_put(a, shard) for a in (p_sh, w_sh, r_sh)))
    return np.asarray(dens), int(overflow)


# ---------------------------------------------------------------------------
# Sharded k-NN: replicated tree, sharded query batches
# ---------------------------------------------------------------------------


def knn_query_sharded(tree: CellList, tree_dev, queries, k: int,
                      mesh: Mesh | None = None):
    """Batched exact k-NN with the query set sharded over the mesh.

    The cell-list (a few arrays) is replicated; each device answers its query
    shard with the same expanding-cube program as the single-chip path. This
    is the analog of the reference's per-query thread fan-out
    (kdtree/src/cpp/pybind.cpp:164-172), lifted from threads to chips.
    """
    if mesh is None:
        mesh = make_slab_mesh()
    axis = mesh.axis_names[0]
    nd = mesh.devices.size

    queries = np.asarray(queries, np.float32)
    Q = queries.shape[0]
    qloc = round_up(max((Q + nd - 1) // nd, 1), 8)
    qpad = np.zeros((nd * qloc, 3), np.float32)
    qpad[:Q] = queries

    ladder = _knn.default_ladder(k, tree)
    meta_static = tree.meta_static
    fn = _knn._make_query_fn(meta_static, ladder, k, True, False)

    mapped = shard_map(
        fn,
        mesh=mesh,
        in_specs=(P(), P(), P(), P(axis)),
        out_specs=(P(axis), P(axis)),
    )
    xyz, index, offsets = tree_dev
    d, i = jax.jit(mapped)(xyz, index, offsets, jnp.asarray(qpad))
    return np.asarray(d)[:Q], np.asarray(i)[:Q]
