"""Sharded k-NN tree: the point set partitioned into z-slabs over the mesh.

The replicated-tree path (:func:`.sharded.knn_query_sharded`) caps tree size
at one device's memory. This module removes that cap — the SURVEY §5.8 item the
reference has no counterpart for ("gather of out-of-shard k-NN candidates via
ragged all-to-all or ppermute rounds"):

- **Build** (:func:`build_tree_sharded`): points are partitioned into ``nd``
  z-slabs (the same slab axis the sharded render uses); each device builds a
  local cell-list over its slab with a SHARED static grid geometry (global
  x/y cells, ``Cz/nd`` local z cells), one traced sort per shard under
  ``shard_map``. The per-slot index channel carries GLOBAL point indices.
- **Query** (:func:`knn_query_tree_sharded`): queries are routed to their
  home slab on the host (stable sort, the analog of the render's slab
  partition), answered exactly against the local tree by an expanding-cube
  ladder (per-dim periodicity: x/y wrap with the box, z clipped to the slab
  with the min-image *metric* still applied), then queries whose k-th best
  distance exceeds the distance to a neighboring slab are exchanged with
  that slab via ``lax.ppermute`` rounds (hop 1, 2, ...) and the returned
  per-shard top-k answers are merged. The hop ladder is static; a query the
  configured hops cannot certify increments the returned ``overflow``
  counter — overflow 0 certifies an exact result, the same contract as the
  sharded render's halo bands.

Reference analog: the pruning machinery this distributes is the kd-tree's
box-distance bound (reference: kdtree/src/cpp/include/kdtree/
kdtree_impl.hpp:239-267) — here applied per shard: a slab is visited only
when its z-interval's (min-image) distance to the query is below the current
k-th best, exactly the reference's "descend only if box_distance < kth".
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from ..core.cells import MAX_CELLS_PER_DIM, choose_dims
from ..core.points import PAD_SENTINEL, round_up, validate_points
from ..ops.knn import _cube_offsets
from ..ops.metrics import wrap_min_image
from .mesh import make_slab_mesh

#: metric period used for non-wrapped dimensions: large enough that
#: ``round(d / L) == 0`` for every real displacement (including the
#: PAD_SENTINEL at 3e18), so the shared wrap expression degrades to identity.
_NO_WRAP = 1.0e30


class ShardedTree(NamedTuple):
    """Device-sharded cell-list forest: one local tree per z-slab.

    All leading-``nd`` arrays are laid out one row per mesh device.
    """

    xyz: jnp.ndarray       # (nd, 4, npad_loc) f32, z LOCALIZED to the slab
    index: jnp.ndarray     # (nd, npad_loc) uint32 GLOBAL indices (pad = n)
    offsets: jnp.ndarray   # (nd, ncells_loc + 1) int32
    counts: np.ndarray     # (nd,) int64 real points per shard (host)
    dims_loc: tuple        # (Cx, Cy, Cz_loc) static local grid dims
    lo: tuple              # (lo_x, lo_y, lo_z) GLOBAL lower corner
    cell_size: tuple       # (hx, hy, hz) static
    slab_depth: float      # z extent of one slab (== Cz_loc * hz)
    periodic: bool
    boxsize: tuple | None  # (Lx, Ly, Lz) when periodic
    n: int                 # global real point count
    max_cell_count: int    # fullest cell over ALL shards (sizes ladders)
    mesh: Mesh
    axis: str

    @property
    def nd(self) -> int:
        return int(self.mesh.devices.size)


def _shared_geometry(n, extent, occupancy, nd):
    """Static grid geometry every shard shares: global x/y dims, z dims a
    multiple of ``nd`` so each slab owns an integer cell count."""
    dims = choose_dims(n, extent, occupancy)
    cz = int(round_up(max(int(dims[2]), nd), nd))
    cz = min(cz, round_up(MAX_CELLS_PER_DIM, nd))
    dims = (int(dims[0]), int(dims[1]), cz)
    h = tuple(float(extent[d]) / dims[d] for d in range(3))
    return dims, h


@functools.partial(jax.jit, static_argnames=("nd", "nloc", "n"))
def _part_scatter(p_sorted, orig_s, counts, nd, nloc, n):
    """Device build-partition stage 2: slice each slab's contiguous run of
    the slab-sorted points into its [nloc] shard row (PAD_SENTINEL
    positions / index ``n`` past the slab's count)."""
    offs = jnp.concatenate(
        [jnp.zeros(1, jnp.int32), jnp.cumsum(counts, dtype=jnp.int32)]
    )
    ps = jnp.pad(p_sorted, ((0, nloc), (0, 0)))
    os_ = jnp.pad(orig_s, (0, nloc))
    rows_p, rows_i = [], []
    j = jnp.arange(nloc, dtype=jnp.int32)
    for d in range(nd):
        p = jax.lax.dynamic_slice(ps, (offs[d], jnp.int32(0)), (nloc, 3))
        i = jax.lax.dynamic_slice(os_, (offs[d],), (nloc,))
        valid = j < counts[d]
        rows_p.append(
            jnp.where(valid[:, None], p, jnp.float32(PAD_SENTINEL))
        )
        rows_i.append(jnp.where(valid, i, n).astype(jnp.uint32))
    return jnp.stack(rows_p), jnp.stack(rows_i)


def build_tree_sharded(points, boxsize=None, mesh: Mesh | None = None,
                       occupancy: float = 8.0) -> ShardedTree:
    """Partition ``points`` into z-slabs over the mesh and build one local
    cell-list per device (one traced multi-operand sort per shard, run as a
    single ``shard_map`` program). Tree capacity scales with the mesh: each
    chip holds only its slab.

    Device-resident ``points`` (a jax array) are partitioned ON DEVICE —
    one slab sort + per-shard slicing, the host syncing only the nd slab
    counts — so a 1e7+-point build never round-trips the host link (the
    same discipline as ``build_cell_list``'s device path).
    """
    if mesh is None:
        mesh = make_slab_mesh()
    axis = mesh.axis_names[0]
    nd = int(mesh.devices.size)

    device_points = (
        not isinstance(points, np.ndarray) and hasattr(points, "devices")
    )
    if device_points:
        if points.ndim != 2 or points.shape[1] != 3:
            raise ValueError(
                f"points must have shape (N, 3), got {points.shape}"
            )
        points = points.astype(jnp.float32)
        if boxsize is not None:
            L = np.asarray(boxsize, dtype=np.float32)
            if np.any(L <= 0):
                raise ValueError("boxsize must be positive")
            bad = bool(
                jnp.any((points < 0) | (points > jnp.asarray(L)))
            ) if points.shape[0] else False
            if bad:
                raise ValueError(
                    "points must be contained in the box [0, boxsize] "
                    "when boxsize is given"
                )
    else:
        points = validate_points(np.asarray(points), boxsize)
    n = points.shape[0]
    periodic = boxsize is not None
    if periodic:
        box = np.broadcast_to(np.asarray(boxsize, np.float32), (3,)).astype(
            np.float32
        )
        lo = np.zeros(3, np.float32)
        extent = box.astype(np.float64)
        boxsize_t = tuple(float(v) for v in box)
    else:
        box = None
        boxsize_t = None
        if n > 0:
            pmin = np.asarray(
                jnp.min(points, axis=0) if device_points
                else points.min(axis=0)
            ).astype(np.float64)
            pmax = np.asarray(
                jnp.max(points, axis=0) if device_points
                else points.max(axis=0)
            ).astype(np.float64)
        else:
            pmin, pmax = np.zeros(3), np.ones(3)
        span = np.maximum(pmax - pmin, 1e-12)
        lo = (pmin - 1e-6 * span).astype(np.float32)
        extent = span * (1.0 + 2e-6)

    dims, h = _shared_geometry(n, extent, occupancy, nd)
    cz_loc = dims[2] // nd
    slab_depth = cz_loc * h[2]

    # slab partition (stable; queries and points use the same assignment
    # rule so a self-query's home shard holds its own point)
    if device_points and n:
        p_sorted, _, orig_s, counts_d = _route_sort(
            points, nd, float(lo[2]), float(slab_depth), None,
            int(round_up(n, 128)),
        )
        counts = np.asarray(counts_d).astype(np.int64)  # the ONE sync
        # 2048-aligned so the brute backstop keeps its full 2048-row DMA
        # blocks (an unaligned npad degrades its block to npad's largest
        # pow2 divisor — measured 256 at 1e7, an 8x longer sweep)
        npad_loc = round_up(
            round_up(max(int(counts.max()), 1), 128) + 2048, 2048
        )
        pts_dev, idx_dev = _part_scatter(
            p_sorted, orig_s, counts_d, nd, npad_loc, n
        )
    else:
        points = np.asarray(points)
        zslab = np.clip(
            np.floor((points[:, 2] - lo[2]) / slab_depth).astype(np.int64),
            0, nd - 1,
        ) if n else np.zeros(0, np.int64)
        order = np.argsort(zslab, kind="stable")
        counts = np.bincount(zslab, minlength=nd)
        npad_loc = round_up(
            round_up(max(int(counts.max()) if n else 1, 1), 128) + 2048,
            2048,
        )

        pts_sh = np.full((nd, npad_loc, 3), PAD_SENTINEL, np.float32)
        idx_sh = np.full((nd, npad_loc), n, np.uint32)
        off = 0
        for d in range(nd):
            c = int(counts[d])
            sel = order[off : off + c]
            pts_sh[d, :c] = points[sel]
            idx_sh[d, :c] = sel.astype(np.uint32)
            off += c
        pts_dev, idx_dev = jnp.asarray(pts_sh), jnp.asarray(idx_sh)

    ncells_loc = dims[0] * dims[1] * cz_loc
    dims_loc = (dims[0], dims[1], cz_loc)

    def build_fn(pts, idx):
        # pts (1, npad, 3) GLOBAL coords; localize z to this shard's slab
        s = jax.lax.axis_index(axis)
        pts = pts[0]
        idx = idx[0]
        z0 = jnp.float32(lo[2]) + s.astype(jnp.float32) * jnp.float32(
            slab_depth
        )
        x, y = pts[:, 0], pts[:, 1]
        zl = pts[:, 2] - z0
        pad = idx == jnp.uint32(n)
        lo_j = jnp.asarray([lo[0], lo[1], 0.0], jnp.float32)
        ih = jnp.asarray([1.0 / h[0], 1.0 / h[1], 1.0 / h[2]], jnp.float32)
        pl = jnp.stack([x, y, zl], axis=1)
        ic = jnp.floor((pl - lo_j[None, :]) * ih[None, :]).astype(jnp.int32)
        if periodic:
            dj = jnp.asarray(dims_loc)
            icx = jnp.mod(ic[:, 0], dj[0])
            icy = jnp.mod(ic[:, 1], dj[1])
        else:
            icx = jnp.clip(ic[:, 0], 0, dims_loc[0] - 1)
            icy = jnp.clip(ic[:, 1], 0, dims_loc[1] - 1)
        icz = jnp.clip(ic[:, 2], 0, cz_loc - 1)
        ids = (icx * dims_loc[1] + icy) * cz_loc + icz
        ids = jnp.where(pad, jnp.int32(ncells_loc), ids)
        sid, sx, sy, sz, sidx = jax.lax.sort(
            (ids, x, y, zl, idx.astype(jnp.int32)), num_keys=1,
            is_stable=True,
        )
        offsets = jnp.searchsorted(
            sid, jnp.arange(ncells_loc + 1, dtype=jnp.int32), method="sort"
        ).astype(jnp.int32)
        xyz = jnp.stack([sx, sy, sz, jnp.full_like(sx, PAD_SENTINEL)])
        mcc = jax.lax.pmax(jnp.max(jnp.diff(offsets)), axis)
        return (
            xyz[None], sidx.astype(jnp.uint32)[None], offsets[None], mcc
        )

    mapped = jax.jit(shard_map(
        build_fn, mesh=mesh,
        in_specs=(P(axis), P(axis)),
        out_specs=(P(axis), P(axis), P(axis), P()),
    ))
    xyz_d, index_d, offsets_d, mcc = mapped(pts_dev, idx_dev)
    return ShardedTree(
        xyz=xyz_d, index=index_d, offsets=offsets_d, counts=counts,
        dims_loc=dims_loc, lo=tuple(float(v) for v in lo),
        cell_size=h, slab_depth=float(slab_depth), periodic=periodic,
        boxsize=boxsize_t, n=n, max_cell_count=int(mcc),
        mesh=mesh, axis=axis,
    )


# ---------------------------------------------------------------------------
# Local (per-slab) exact query: expanding-cube ladder with per-dim
# periodicity — x/y wrap with the global box, z clipped to the slab but with
# the min-image metric still applied (hop-delivered queries sit outside the
# slab; their z displacement must wrap through the global box).
# ---------------------------------------------------------------------------


def _interval_dist(qv, a, b, L):
    """Min-image distance from point ``qv`` to the interval [a, b] (torus of
    period ``L``; ``L = _NO_WRAP`` degrades to the plain line distance)."""
    mid = (a + b) * 0.5
    half = (b - a) * 0.5
    return jnp.maximum(jnp.abs(wrap_min_image(qv - mid, L)) - half, 0.0)


def _local_cube_pass(tree, meta, q, qcell, k, r, budget, state):
    """One expanding-cube pass against the LOCAL tree. Mirrors
    ops.knn._cube_pass with per-dim binning/metric periodicity and a
    wrapped point-to-interval convergence bound in z (queries delivered by
    hops sit outside the slab, where the in-cube face formula breaks)."""
    xyz, offsets, n_loc = tree
    dims, lo, h, wrapL, bin_per = meta
    Q = q.shape[0]
    M_off = _cube_offsets(r)
    M = M_off.shape[0]

    ccd = []
    valid = jnp.ones((Q, M), bool)
    for dim in range(3):
        C = int(dims[dim])
        if bin_per[dim]:
            static_valid = (M_off[:, dim] + r) < C  # dedup wrapped cells
            c = jnp.mod(qcell[:, dim : dim + 1] + C + M_off[None, :, dim], C)
            valid = valid & jnp.asarray(static_valid)[None, :]
        else:
            c = qcell[:, dim : dim + 1] + M_off[None, :, dim]
            valid = valid & (c >= 0) & (c < C)
            c = jnp.clip(c, 0, C - 1)
        ccd.append(c)

    ids = (ccd[0] * int(dims[1]) + ccd[1]) * int(dims[2]) + ccd[2]
    starts = offsets[ids]
    counts = jnp.where(valid, offsets[ids + 1] - starts, 0)

    npad = xyz.shape[1]
    ccap = min(budget, npad)
    starts_cl = jnp.minimum(starts, max(npad - ccap, 0))
    delta = starts - starts_cl
    usable = ccap - delta
    overflow = jnp.any(valid & (counts > usable), axis=1)
    cnt_cl = jnp.minimum(counts, usable)

    j_idx = jnp.arange(ccap, dtype=jnp.int32)
    valid_c = (
        valid[:, :, None]
        & (j_idx[None, None, :] >= delta[:, :, None])
        & (j_idx[None, None, :] < (delta + cnt_cl)[:, :, None])
    )
    slice2 = jax.vmap(jax.vmap(
        lambda arr, s: jax.lax.dynamic_slice(arr, (s,), (ccap,)),
        in_axes=(None, 0)), in_axes=(None, 0))
    d2 = jnp.zeros((Q, M, ccap), jnp.float32)
    for dim in range(3):
        px = slice2(xyz[dim], starts_cl)
        d = wrap_min_image(q[:, dim, None, None] - px, wrapL[dim])
        d2 = d2 + d * d
    d2 = jnp.where(valid_c, d2, jnp.inf).reshape(Q, M * ccap)
    slot = (starts_cl[:, :, None] + j_idx[None, None, :]).reshape(Q, M * ccap)
    if M * ccap < k:
        pad = k - M * ccap
        d2 = jnp.pad(d2, ((0, 0), (0, pad)), constant_values=jnp.inf)
        slot = jnp.pad(slot, ((0, 0), (0, pad)))

    neg, sel = jax.lax.top_k(-d2, k)
    new_d2 = -neg
    new_slot = jnp.take_along_axis(slot, sel, axis=1)

    # distance to the nearest unscanned LOCAL region (the bound certifies
    # exactness among THIS shard's points only; cross-shard pruning is the
    # hop ladder's job)
    side = 2 * r + 1
    db = jnp.full((Q,), jnp.inf, jnp.float32)
    covered = jnp.ones((Q,), bool)
    covered_possible = True
    for dim in range(3):
        C = int(dims[dim])
        hd = float(h[dim])
        if bin_per[dim]:
            if side >= C:
                continue  # fully wrapped for every query
            covered_possible = False
            face_lo = (qcell[:, dim] - r).astype(jnp.float32) * hd + float(
                lo[dim]
            )
            arc = side * hd
            dlo = q[:, dim] - face_lo
            dhi = arc - dlo
            db = jnp.minimum(db, jnp.maximum(jnp.minimum(dlo, dhi), 0.0))
        else:
            a = jnp.maximum(qcell[:, dim] - r, 0)
            b = jnp.minimum(qcell[:, dim] + r, C - 1)
            covered = covered & (a == 0) & (b == C - 1)
            lo_d = float(lo[dim])
            # unscanned low cells [0, a) span [lo, lo + a*h]
            d_lo = jnp.where(
                a > 0,
                _interval_dist(
                    q[:, dim], jnp.float32(lo_d),
                    lo_d + a.astype(jnp.float32) * hd, wrapL[dim],
                ),
                jnp.inf,
            )
            # unscanned high cells (b, C) span [lo + (b+1)*h, lo + C*h]
            d_hi = jnp.where(
                b < C - 1,
                _interval_dist(
                    q[:, dim], lo_d + (b + 1).astype(jnp.float32) * hd,
                    jnp.float32(lo_d + C * hd), wrapL[dim],
                ),
                jnp.inf,
            )
            db = jnp.minimum(db, jnp.minimum(d_lo, d_hi))
    if not covered_possible:
        covered = jnp.zeros((Q,), bool)

    kth2 = new_d2[:, -1]
    new_conv = (~overflow) & ((kth2 < db * db) | covered)

    old_d2, old_slot, old_conv = state
    upd = ~old_conv
    d2_out = jnp.where(upd[:, None], new_d2, old_d2)
    slot_out = jnp.where(upd[:, None], new_slot, old_slot)
    conv_out = old_conv | (upd & new_conv)
    return d2_out, slot_out, conv_out


def _local_brute_pass(xyz, n_loc, q, k, wrapL, block: int = 2048):
    """Exact fallback over every local point (traced per-shard count)."""
    npad = xyz.shape[1]
    b = block
    while npad % b != 0:
        b //= 2
    nblocks = npad // b

    def body(carry, i):
        best_d2, best_slot = carry
        sl = i * b
        d2 = jnp.zeros((q.shape[0], b), jnp.float32)
        for dim in range(3):
            px = jax.lax.dynamic_slice(xyz, (dim, sl), (1, b))
            d = wrap_min_image(q[:, dim : dim + 1] - px, wrapL[dim])
            d2 = d2 + d * d
        slot = sl + jax.lax.broadcasted_iota(jnp.int32, (1, b), 1)
        d2 = jnp.where(slot < n_loc, d2, jnp.inf)
        cat_d2 = jnp.concatenate([best_d2, d2], axis=1)
        cat_slot = jnp.concatenate(
            [best_slot, jnp.broadcast_to(slot, d2.shape)], axis=1
        )
        neg, sel = jax.lax.top_k(-cat_d2, k)
        return (-neg, jnp.take_along_axis(cat_slot, sel, axis=1)), None

    init = (
        jnp.full((q.shape[0], k), jnp.inf, jnp.float32) + q[0, 0] * 0.0,
        jnp.zeros((q.shape[0], k), jnp.int32)
        + (q[0, 0] * 0.0).astype(jnp.int32),
    )
    (d2, slot), _ = jax.lax.scan(body, init, jnp.arange(nblocks))
    return d2, slot


def _default_local_ladder(k, max_cell_count, dims_loc, budget_cap=2048):
    mcc = max(int(max_cell_count), 1)
    cap0 = max(int(budget_cap), 1)
    max_dim = int(max(dims_loc))
    rungs = [(1, min(mcc, 256, cap0))]
    if mcc > 256:
        rungs.append((1, min(mcc, 2048, cap0)))
    # no rung past r=4: its 17^3-cell pass needs a ~128k-wide top_k, which
    # crashed the device worker of the engine's first accelerator (r=4's
    # 19k is fine); kept until measured on the GPU. Stragglers go to the
    # BANDED brute backstop in _make_local_answer instead (<= 128 rows pay
    # the slab sweep).
    for r, cap in ((2, 128), (4, 64)):
        rungs.append((r, min(mcc, cap, cap0)))
        if 2 * r + 1 >= max_dim:
            break
    out = []
    for rung in rungs:
        if not out or rung != out[-1]:
            out.append(rung)
    return tuple(out)


def _make_local_answer(meta, ladder, k, n_global):
    """Traced exact-k-NN against one local tree. Returns (d2 [Q, k],
    global index [Q, k] uint32); missing neighbors get (inf, n_global).

    Production scale: the cube passes hold a [Q, M, budget] candidate
    transient, so large query batches stream through ``lax.map`` chunks
    sized to bound that transient (~128 MiB) — the same discipline as
    ops/knn's chunked ladder (a 5e5-query shard would otherwise ask for
    a 14 GiB transient; measured compile-time OOM)."""
    dims, lo, h, wrapL, bin_per = meta

    def run(xyz, index, offsets, n_loc, q):
        Q = q.shape[0]
        bmax = max(((2 * r + 1) ** 3) * c for r, c in ladder)
        lim = max(256, (1 << 25) // max(bmax, 1))
        ch = 256
        while ch * 2 <= lim:
            ch *= 2
        if Q > ch:
            Qp = -(-Q // ch) * ch
            qp = q if Qp == Q else jnp.pad(q, ((0, Qp - Q), (0, 0)))

            def one(qc):
                return _run_chunk(xyz, index, offsets, n_loc, qc)

            d2, gi = jax.lax.map(one, qp.reshape(Qp // ch, ch, 3))
            return d2.reshape(Qp, k)[:Q], gi.reshape(Qp, k)[:Q]
        return _run_chunk(xyz, index, offsets, n_loc, q)

    def _run_chunk(xyz, index, offsets, n_loc, q):
        Q = q.shape[0]
        cell = []
        for dim in range(3):
            C = int(dims[dim])
            c = jnp.floor(
                (q[:, dim] - float(lo[dim])) * (1.0 / float(h[dim]))
            ).astype(jnp.int32)
            if bin_per[dim]:
                c = jnp.mod(c, C)
            else:
                c = jnp.clip(c, 0, C - 1)
            cell.append(c)
        qcell = jnp.stack(cell, axis=1)

        zf = q[0, 0] * 0.0
        zi = zf.astype(jnp.int32)
        state = (
            jnp.full((Q, k), jnp.inf, jnp.float32) + zf,
            jnp.zeros((Q, k), jnp.int32) + zi,
            jnp.zeros((Q,), bool) | (zi != 0),
        )
        tree = (xyz, offsets, n_loc)
        state = _local_cube_pass(
            tree, meta, q, qcell, k, ladder[0][0], ladder[0][1], state
        )
        for r, budget in ladder[1:]:

            def this_pass(s, _r=r, _b=budget):
                """Escalation rung on the COMPACTED stragglers: a chunk
                with one unconverged row was paying the (2r+1)^3-cell
                scan for every row (the dominant cost of this path at
                scale — gathers charge per candidate lane); band-compact
                first, full-chunk rescan only on band overflow."""
                mask = ~s[2]
                bcap = min(128, q.shape[0])
                (bq, bqc), valid, sel, ov = _band_compact(
                    [q, qcell], mask, bcap
                )
                zero = (
                    jnp.full((bcap, k), jnp.inf, jnp.float32),
                    jnp.zeros((bcap, k), jnp.int32),
                    jnp.zeros((bcap,), bool),
                )
                d2n, slotn, convn = _local_cube_pass(
                    tree, meta, bq, bqc, k, _r, _b, zero
                )
                d2m = s[0].at[sel].set(
                    jnp.where(valid[:, None], d2n, s[0][sel])
                )
                slm = s[1].at[sel].set(
                    jnp.where(valid[:, None], slotn, s[1][sel])
                )
                cvm = s[2].at[sel].set(s[2][sel] | (valid & convn))

                def full(s2):
                    return _local_cube_pass(
                        tree, meta, q, qcell, k, _r, _b, s2
                    )

                return jax.lax.cond(
                    ov > 0, full, lambda x: x, (d2m, slm, cvm)
                )

            state = jax.lax.cond(
                jnp.any(~state[2]), this_pass, lambda s: s, state
            )

        def fallback(s):
            """Exact backstop for ladder stragglers. The brute sweep costs
            O(npad) PER ROW SCANNED, so stragglers (a handful per million
            queries once the r=8 rung exists) are first band-compacted to
            ``bcap`` rows; only a band overflow (> bcap stragglers —
            realistically only tiny trees, where the sweep is cheap) pays
            the full-chunk sweep. The unbanded form swept every chunk row
            through a 1e7-point slab whenever ONE row escaped the ladder
            — minutes of device time that crashed the remote worker."""
            mask = ~s[2]
            bcap = min(128, q.shape[0])
            (bq,), valid, sel, ov = _band_compact([q], mask, bcap)
            d2b, slotb = _local_brute_pass(xyz, n_loc, bq, k, wrapL)
            d2 = s[0].at[sel].set(
                jnp.where(valid[:, None], d2b, s[0][sel])
            )
            sl = s[1].at[sel].set(
                jnp.where(valid[:, None], slotb, s[1][sel])
            )
            cv = s[2].at[sel].set(s[2][sel] | valid)

            def full(s2):
                d2f, slotf = _local_brute_pass(xyz, n_loc, q, k, wrapL)
                upd = ~s2[2]
                return (
                    jnp.where(upd[:, None], d2f, s2[0]),
                    jnp.where(upd[:, None], slotf, s2[1]),
                    jnp.ones_like(s2[2]),
                )

            return jax.lax.cond(ov > 0, full, lambda x: x, (d2, sl, cv))

        state = jax.lax.cond(jnp.any(~state[2]), fallback, lambda s: s, state)
        d2, slot, _ = state
        gidx = index[slot]
        gidx = jnp.where(jnp.isfinite(d2), gidx, jnp.uint32(n_global))
        return d2, gidx

    return run


# ---------------------------------------------------------------------------
# Sharded query: home-shard answer + ppermute hop exchange
# ---------------------------------------------------------------------------


def _band_compact(arrs, mask, cap):
    """Compact masked rows to a cap-sized band (static shapes); invalid
    band slots zeroed. Returns (bands, valid, overflow)."""
    order = jnp.argsort(~mask, stable=True)
    sel = order[:cap]
    valid = mask[sel]
    out = []
    for a in arrs:
        b = a[sel]
        z = jnp.zeros_like(b)
        out.append(jnp.where(valid if b.ndim == 1 else valid[:, None], b, z))
    overflow = jnp.maximum(jnp.sum(mask.astype(jnp.int32)) - cap, 0)
    return out, valid, sel, overflow


def _make_query_shard_fn(stree: ShardedTree, k, hops, cap, ladder):
    nd = stree.nd
    axis = stree.axis
    D = float(stree.slab_depth)
    dims = stree.dims_loc
    periodic = stree.periodic
    if periodic:
        box = stree.boxsize
        wrapL = (float(box[0]), float(box[1]), float(box[2]))
        # a single-slab mesh owns the WHOLE z extent: bin z periodically
        # like x/y. With z clipped instead, a z-boundary query's
        # wrap-adjacent cells are unreachable at every rung, so ~2h/L of
        # all queries (1.25% measured at 1e7) fell through to the
        # full-slab brute backstop — minutes of device time per chunk.
        # Multi-slab meshes keep z clipped (cross-
        # slab neighbors are the hop ladder's job, and a slab's wrap
        # distance through the global box is never shorter than its
        # clipped local distance when D <= L/2).
        bin_per = (True, True, nd == 1)
    else:
        wrapL = (_NO_WRAP, _NO_WRAP, _NO_WRAP)
        bin_per = (False, False, False)
    lo_loc = (stree.lo[0], stree.lo[1], 0.0)
    meta = (dims, lo_loc, stree.cell_size, wrapL, bin_per)
    answer = _make_local_answer(meta, ladder, k, stree.n)

    def face_dist(qz, h, direction):
        """Min-image distance from local-z ``qz`` to the slab ``h`` hops in
        ``direction`` (+1 up, -1 down). Home slab spans [0, D)."""
        if direction > 0:
            direct = h * D - qz
            around = qz + (nd - h - 1) * D
        else:
            direct = qz + (h - 1) * D
            around = (nd - h) * D - qz
        if periodic and nd > 1:
            return jnp.minimum(direct, around)
        return direct

    def localize_z(qz_global, s):
        z0 = jnp.float32(stree.lo[2]) + s.astype(jnp.float32) * jnp.float32(D)
        zl = qz_global - z0
        if periodic:
            # min-image representative relative to the slab center so hop
            # images land on the near side
            L = float(stree.boxsize[2])
            zl = zl - L * jnp.round((zl - 0.5 * D) * (1.0 / L))
        return zl

    def f(xyz, index, offsets, nloc, q, qmask):
        xyz, index, offsets = xyz[0], index[0], offsets[0]
        nloc = nloc[0]
        q, qmask = q[0], qmask[0]
        s = jax.lax.axis_index(axis)

        ql = q.at[:, 2].set(localize_z(q[:, 2], s))
        d2, gi = answer(xyz, index, offsets, nloc, ql)
        overflow = jnp.int32(0)

        hop_list = []
        for h in range(1, hops + 1):
            if periodic:
                if 2 * h < nd:
                    hop_list.append((h, +1))
                    hop_list.append((h, -1))
                elif 2 * h == nd:
                    hop_list.append((h, +1))  # same shard both ways: once
            else:
                if h <= nd - 1:
                    hop_list.append((h, +1))
                    hop_list.append((h, -1))

        for h, direction in hop_list:
            # squared compare (no sqrt rounding in the prune decision; the
            # reference prunes on squared box distance too)
            fd = face_dist(ql[:, 2], h, direction)
            if 2 * h == nd and periodic:
                fd = jnp.minimum(fd, face_dist(ql[:, 2], h, -1))
            fd = jnp.maximum(fd, 0.0)
            active = qmask & (d2[:, -1] > fd * fd)
            if not periodic:
                # edge shards have no neighbor at this hop
                if direction > 0:
                    active = active & (s < nd - h)
                else:
                    active = active & (s >= h)
            (bq, bv), valid, sel, ov = _band_compact(
                [q, qmask.astype(jnp.float32)], active, cap
            )
            overflow = overflow + ov

            if periodic:
                perm = [(i, (i + direction * h) % nd) for i in range(nd)]
            else:
                perm = [
                    (i, i + direction * h)
                    for i in range(nd)
                    if 0 <= i + direction * h < nd
                ]
            rq = jax.lax.ppermute(bq, axis, perm)
            rv = jax.lax.ppermute(bv, axis, perm)

            rql = rq.at[:, 2].set(localize_z(rq[:, 2], s))
            rd2, rgi = answer(xyz, index, offsets, nloc, rql)
            rd2 = jnp.where(rv[:, None] > 0, rd2, jnp.inf)

            iperm = [(j, i) for (i, j) in perm]
            ad2 = jax.lax.ppermute(rd2, axis, iperm)
            agi = jax.lax.ppermute(rgi, axis, iperm)

            # merge the returned top-k into the band rows' running top-k
            home_d2 = d2[sel]
            home_gi = gi[sel]
            cat_d2 = jnp.concatenate([home_d2, ad2], axis=1)
            cat_gi = jnp.concatenate([home_gi, agi], axis=1)
            neg, pick = jax.lax.top_k(-cat_d2, k)
            m_d2 = -neg
            m_gi = jnp.take_along_axis(cat_gi, pick, axis=1)
            m_d2 = jnp.where(valid[:, None], m_d2, home_d2)
            m_gi = jnp.where(valid[:, None], m_gi, home_gi)
            d2 = d2.at[sel].set(m_d2)
            gi = gi.at[sel].set(m_gi)

        # certification: every unvisited slab must be farther than the k-th
        # best (the cross-shard box-distance bound, kdtree_impl.hpp:239-267)
        if periodic:
            visited_all = 2 * hops + 1 >= nd
            if not visited_all:
                f_next = jnp.maximum(jnp.minimum(
                    face_dist(ql[:, 2], hops + 1, +1),
                    face_dist(ql[:, 2], hops + 1, -1),
                ), 0.0)
                overflow = overflow + jnp.sum(
                    (qmask & (d2[:, -1] > f_next * f_next)).astype(jnp.int32)
                )
        else:
            if hops < nd - 1:
                h1 = hops + 1
                f_up = jnp.where(
                    s < nd - h1,
                    jnp.maximum(face_dist(ql[:, 2], h1, +1), 0.0),
                    jnp.inf,
                )
                f_dn = jnp.where(
                    s >= h1,
                    jnp.maximum(face_dist(ql[:, 2], h1, -1), 0.0),
                    jnp.inf,
                )
                f_next = jnp.minimum(f_up, f_dn)
                overflow = overflow + jnp.sum(
                    (qmask & (d2[:, -1] > f_next * f_next)).astype(jnp.int32)
                )
        return d2[None], gi[None], jax.lax.psum(overflow, axis)

    return f


@functools.partial(
    jax.jit, static_argnames=("nd", "lo_z", "depth", "box", "qpad")
)
def _route_sort(queries, nd, lo_z, depth, box, qpad):
    """Device query->slab routing stage 1: wrap, slab-assign, ONE stable
    multi-operand sort by slab id (positions + original index riding the
    comparator — the engine's bread-and-butter pattern, never a scatter).
    Returns sorted (q [Qp, 3], slab [Qp], orig [Qp]) plus per-slab counts
    (the only values the host syncs). Pad rows route to slab nd (past every
    real slab)."""
    Q = queries.shape[0]
    qw = queries.astype(jnp.float32)
    if box is not None:
        L = jnp.asarray(box, jnp.float32)
        qw = qw - L[None, :] * jnp.floor(qw / L[None, :])
    slab = jnp.clip(
        jnp.floor((qw[:, 2] - lo_z) * (1.0 / depth)).astype(jnp.int32),
        0, nd - 1,
    )
    if qpad > Q:
        qw = jnp.pad(qw, ((0, qpad - Q), (0, 0)))
        slab = jnp.pad(slab, (0, qpad - Q), constant_values=nd)
    orig = jnp.arange(qpad, dtype=jnp.int32)
    slab_s, qx, qy, qz, orig_s = jax.lax.sort(
        (slab, qw[:, 0], qw[:, 1], qw[:, 2], orig),
        num_keys=1, is_stable=True,
    )
    counts = jnp.diff(
        jnp.searchsorted(
            slab_s, jnp.arange(nd + 1, dtype=jnp.int32), method="sort"
        )
    )
    return jnp.stack([qx, qy, qz], 1), slab_s, orig_s, counts


@functools.partial(jax.jit, static_argnames=("nd", "qloc"))
def _route_scatter(q_sorted, counts, nd, qloc):
    """Device routing stage 2: slice each slab's contiguous run of the
    sorted queries into its [qloc] row (dynamic_slice per shard — nd is
    static and small; no elementwise scatter)."""
    offs = jnp.concatenate(
        [jnp.zeros(1, jnp.int32), jnp.cumsum(counts, dtype=jnp.int32)]
    )
    # tail guard: a slice starting at offs[d] never clamps (a clamped
    # start would shift real rows off their slab positions)
    qs = jnp.pad(q_sorted, ((0, qloc), (0, 0)))
    rows_q, rows_m = [], []
    j = jnp.arange(qloc, dtype=jnp.int32)
    for d in range(nd):
        row = jax.lax.dynamic_slice(
            qs, (offs[d], jnp.int32(0)), (qloc, 3)
        )
        rows_q.append(row)
        rows_m.append(j < counts[d])
    return jnp.stack(rows_q), jnp.stack(rows_m)


@functools.partial(jax.jit, static_argnames=("nd", "qloc"))
def _route_unsort(d2, gi, counts, slab_s, orig_s, nd, qloc):
    """Device un-routing: map shard-row results back to sorted positions
    (elementwise offset math), then back to caller order by ONE stable
    sort on the carried original index (sort + row-gather, no scatter)."""
    offs = jnp.concatenate(
        [jnp.zeros(1, jnp.int32), jnp.cumsum(counts, dtype=jnp.int32)]
    )
    Qp = slab_s.shape[0]
    j = jnp.arange(Qp, dtype=jnp.int32)
    off_of = jnp.zeros(Qp, jnp.int32)
    for d in range(nd):  # tiny static fan of selects, not a gather
        off_of = jnp.where(slab_s == d, offs[d], off_of)
    flat = jnp.clip(
        jnp.minimum(slab_s, nd - 1) * qloc + (j - off_of), 0, nd * qloc - 1
    )
    d_rows = d2.reshape(nd * qloc, -1)[flat]
    g_rows = gi.reshape(nd * qloc, -1)[flat]
    _, perm = jax.lax.sort((orig_s, j), num_keys=1, is_stable=True)
    return jnp.sqrt(d_rows[perm]), g_rows[perm]


def knn_query_tree_sharded(stree: ShardedTree, queries, k: int,
                           hops: int | None = None, cap: int | None = None):
    """Exact batched k-NN against a :class:`ShardedTree`.

    Queries are routed to their home slab ON DEVICE (one stable sort by
    slab id — the engine's standard sort-not-scatter pattern; the host
    syncs only the nd per-slab counts to size the static shard rows),
    answered locally, and exchanged with neighboring slabs via
    ``lax.ppermute`` rounds whenever the k-th best distance reaches past
    a slab face (the cross-shard analog of the reference's box-distance
    prune, kdtree_impl.hpp:239-267).

    Returns ``(distances [Q, k] float32 ascending, indices [Q, k] uint32,
    overflow)``. ``overflow == 0`` certifies an exact result; a positive
    count means some query needed more ``hops`` (or a larger band ``cap``)
    than configured — the same certificate contract as the sharded render.
    Array results are device-resident when ``queries`` is a jax array,
    numpy otherwise.

    ``hops`` defaults to enough rounds to visit every slab (exactness needs
    no certification then); pass a smaller value to trade round count for
    the overflow certificate.
    """
    if k <= 0:
        raise ValueError("k must be positive")
    nd = stree.nd
    axis = stree.axis
    if hops is None:
        hops = (nd // 2) if stree.periodic else (nd - 1)
    hops = max(0, min(int(hops), nd - 1 if not stree.periodic else nd // 2))

    device_in = isinstance(queries, jnp.ndarray)
    if not device_in:
        queries = np.asarray(queries, np.float32)
    Q = queries.shape[0]
    if Q == 0:
        return (np.zeros((0, k), np.float32), np.zeros((0, k), np.uint32), 0)

    # routing stage 1 on device; quantized pad bounds the compile shapes
    qpad = int(round_up(Q, 128))
    q_sorted, slab_s, orig_s, counts_d = _route_sort(
        jnp.asarray(queries), nd, float(stree.lo[2]),
        float(stree.slab_depth),
        stree.boxsize if stree.periodic else None, qpad,
    )
    counts = np.asarray(counts_d)  # the ONE host sync of the routing
    qloc = round_up(max(int(counts.max()), 1), 8)
    # quantize the per-shard row height so program shapes recur
    ql = 8
    while ql < qloc:
        ql *= 2
    qloc = min(ql, round_up(qpad, 8))
    q_sh, m_sh = _route_scatter(q_sorted, counts_d, nd, qloc)

    if cap is None:
        cap = qloc
    cap = min(max(int(cap), 8), qloc)

    ladder = _default_local_ladder(k, stree.max_cell_count, stree.dims_loc)
    fn = _make_query_shard_fn(stree, int(k), int(hops), int(cap), ladder)
    mapped = jax.jit(shard_map(
        fn, mesh=stree.mesh,
        in_specs=(P(axis), P(axis), P(axis), P(axis), P(axis), P(axis)),
        out_specs=(P(axis), P(axis), P()),
    ))
    d2, gi, overflow = mapped(
        stree.xyz, stree.index, stree.offsets,
        jnp.asarray(stree.counts.astype(np.int32)),
        q_sh, m_sh,
    )
    d_out, i_out = _route_unsort(
        d2, gi, counts_d, slab_s, orig_s, nd, qloc
    )
    d_out, i_out = d_out[:Q], i_out[:Q]
    if not device_in:
        d_out = np.asarray(d_out)
        i_out = np.asarray(i_out)
    return d_out, i_out, int(overflow)
