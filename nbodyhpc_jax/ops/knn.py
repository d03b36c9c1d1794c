"""Batched k-nearest-neighbor engines (brute force + cell-list).

Batched replacement for the reference's kd-tree query machinery:

- The recursive traversal with box-distance pruning (reference: kdtree/src/cpp/
  include/kdtree/kdtree_impl.hpp:185-269) becomes an *expanding-cube* cell scan:
  every query scans all cells within Chebyshev cell-radius ``r`` of its own
  cell; the result is exact once the k-th best distance is smaller than the
  distance to the nearest unscanned cell — the same bound as the reference's
  ``distance.box_distance(query, bounds) >= kth`` prune, applied to the
  complement of the scanned cube.
- The AVX2/asm leaf brute-force scan (kdtree_opt.hpp:105-248,
  kdtree_asm_systemv.asm:120-257) becomes a dense ``[Q, B]`` masked distance
  computation.
- The tournament-tree top-k (tournament_tree.hpp:18-124) becomes
  ``jax.lax.top_k`` over the candidate axis.
- The per-query thread fan-out (pybind.cpp:164-172) is replaced by batching:
  all queries are a single data-parallel program.

Exactness is guaranteed by an escalation ladder of (radius, budget) passes, with
each later pass wrapped in ``lax.cond`` so it costs nothing when every query has
already converged, and a final streaming brute-force fallback.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..core.cells import CellList
from .metrics import wrap_min_image


class QueryStatistics(NamedTuple):
    """Per-query work counters, mirroring the reference's KDTreeQueryStatistics
    (kdtree/src/cpp/include/kdtree/kdtree.hpp:124-131): ``cells_scanned`` is the
    analog of nodes_visited, ``points_visited`` counts candidate points, and
    ``cells_pruned`` is the analog of nodes_pruned — the grid cells the
    convergence bound excluded from scanning (the statistic that shows the
    box-distance prune working, kdtree_impl.hpp:249-265). Queries that fell
    through to the exact brute-force pass pruned nothing and report 0."""

    cells_scanned: jnp.ndarray
    points_visited: jnp.ndarray
    cells_pruned: jnp.ndarray


class KnnResult(NamedTuple):
    distances: jnp.ndarray  # [Q, k] float32, ascending (sqrt applied)
    indices: jnp.ndarray  # [Q, k] uint32 (== n for missing neighbors)
    stats: QueryStatistics | None


# ---------------------------------------------------------------------------
# Brute force (oracle + fallback)
# ---------------------------------------------------------------------------


def brute_force_knn(points, queries, k: int, box=None):
    """Exact k-NN by dense distance computation. Oracle for tests.

    ``points``: (N, 3); ``queries``: (Q, 3); ``box``: None or (3,) periodic box.
    Returns (distances [Q, k] float32 ascending, indices [Q, k] int32).
    Mirrors the naive priority-queue oracle in the reference's tests
    (kdtree/src/cpp/tests/test.cpp:14-37).
    """
    points = jnp.asarray(points, jnp.float32)
    queries = jnp.asarray(queries, jnp.float32)
    d = queries[:, None, :] - points[None, :, :]
    if box is not None:
        b = jnp.asarray(box, jnp.float32)
        d = d - b * jnp.round(d / b)
    d2 = jnp.sum(d * d, axis=-1)
    neg, idx = jax.lax.top_k(-d2, k)
    return jnp.sqrt(-neg), idx


def _divisor_block(npad: int, want: int) -> int:
    """Largest power-of-two block <= want that divides npad (npad % 128 == 0)."""
    b = want
    while npad % b != 0:
        b //= 2
    return b


def _streaming_brute_pass(xyz, n, queries_w, k, box, block: int = 2048):
    """Memory-bounded exact scan over all (sorted, padded) points.

    State-carried top-k over point blocks; used as the guaranteed-exact final
    fallback of the escalation ladder. Returns (d2 [Q,k] ascending, slot [Q,k]).
    """
    block = _divisor_block(xyz.shape[1], min(block, xyz.shape[1]))
    npad = xyz.shape[1]
    nblocks = npad // block
    q = queries_w  # [Q, 3]

    def body(carry, i):
        best_d2, best_slot = carry
        sl = i * block
        d2 = jnp.zeros((q.shape[0], block), jnp.float32)
        for dim in range(3):
            px = jax.lax.dynamic_slice(xyz, (dim, sl), (1, block))  # [1, block]
            d = q[:, dim : dim + 1] - px
            if box is not None:
                d = wrap_min_image(d, float(np.asarray(box).reshape(-1)[dim]))
            d2 = d2 + d * d
        slot = sl + jax.lax.broadcasted_iota(jnp.int32, (1, block), 1)
        valid = slot < n
        d2 = jnp.where(valid, d2, jnp.inf)
        cat_d2 = jnp.concatenate([best_d2, d2], axis=1)
        cat_slot = jnp.concatenate([best_slot, jnp.broadcast_to(slot, d2.shape)], axis=1)
        neg, sel = jax.lax.top_k(-cat_d2, k)
        return (-neg, jnp.take_along_axis(cat_slot, sel, axis=1)), None

    # zeros derived from q so device-variance matches under shard_map
    init = (
        jnp.full((q.shape[0], k), jnp.inf, jnp.float32) + q[0, 0] * 0.0,
        jnp.zeros((q.shape[0], k), jnp.int32) + (q[0, 0] * 0.0).astype(jnp.int32),
    )
    (d2, slot), _ = jax.lax.scan(body, init, jnp.arange(nblocks))
    return d2, slot


# ---------------------------------------------------------------------------
# Cell-list expanding-cube passes
# ---------------------------------------------------------------------------


def _cube_offsets(r: int) -> np.ndarray:
    o = np.arange(-r, r + 1)
    return np.stack(np.meshgrid(o, o, o, indexing="ij"), axis=-1).reshape(-1, 3)


def _cube_pass(tree, meta, queries_w, qcell, k, r, budget, state):
    """One expanding-cube pass at Chebyshev cell radius ``r`` with candidate
    budget ``budget``. Recomputes top-k from the full cube (supersedes smaller
    radii) and updates convergence per the box-distance bound."""
    xyz, index, offsets = tree
    dims, lo, h, periodic, n = meta
    dims = np.asarray(dims, np.int32)
    Q = queries_w.shape[0]
    M_off = _cube_offsets(r)  # [M, 3] numpy
    M = M_off.shape[0]

    # per-dimension cell coordinates ([Q, M] each) — split per dimension, so
    # no array carries a padded trailing axis of 3
    ccd = []
    if periodic:
        static_valid = np.all((M_off + r) < dims[None, :], axis=1)  # dedup wrapped cells
        for dim in range(3):
            c = qcell[:, dim : dim + 1] + int(dims[dim]) + M_off[None, :, dim]
            ccd.append(jnp.mod(c, int(dims[dim])))
        valid = jnp.broadcast_to(jnp.asarray(static_valid)[None, :], (Q, M))
    else:
        valid = jnp.ones((Q, M), bool)
        for dim in range(3):
            c = qcell[:, dim : dim + 1] + M_off[None, :, dim]
            valid = valid & (c >= 0) & (c < int(dims[dim]))
            ccd.append(jnp.clip(c, 0, int(dims[dim]) - 1))

    ids = (ccd[0] * int(dims[1]) + ccd[1]) * int(dims[2]) + ccd[2]
    starts = offsets[ids]
    counts = jnp.where(valid, offsets[ids + 1] - starts, 0)  # [Q, M]

    # candidates fetched as contiguous per-cell slices — the sorted cell-list
    # layout makes each cell one run, so this lowers to batched dynamic-slice
    # instead of elementwise random gather (the AVX2 leaf-block scan analog,
    # reference kdtree_opt.hpp:105-248: blocks are scanned contiguously there
    # for exactly the same reason). Slices near the padded end clamp their
    # start; ``delta`` re-aims the validity window at the cell's real rows
    # so a clamped slice never evaluates the wrong points.
    npad = xyz.shape[1]
    ccap = min(budget, npad)  # a slice can never exceed the padded array
    starts_cl = jnp.minimum(starts, max(npad - ccap, 0))
    delta = starts - starts_cl  # >= 0; > 0 only for clamped end-of-array cells

    # cells whose occupancy exceeds the usable slice window are truncated and
    # force escalation (exactness preserved by later rungs / brute fallback)
    usable = ccap - delta
    overflow = jnp.any(valid & (counts > usable), axis=1)
    cnt_cl = jnp.minimum(counts, usable)
    taken = jnp.sum(jnp.where(valid, cnt_cl, 0), axis=1)

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
        px = slice2(xyz[dim], starts_cl)  # [Q, M, ccap]
        d = queries_w[:, dim, None, None] - px
        if periodic:  # min-image wrap, reference kdtree.hpp:66-87
            d = wrap_min_image(d, float(dims[dim]) * float(h[dim]))
        d2 = d2 + d * d
    d2 = jnp.where(valid_c, d2, jnp.inf).reshape(Q, M * ccap)
    slot = (starts_cl[:, :, None] + j_idx[None, None, :]).reshape(Q, M * ccap)
    if M * ccap < k:  # tiny trees: pad so top_k is well-formed
        pad = k - M * ccap
        d2 = jnp.pad(d2, ((0, 0), (0, pad)), constant_values=jnp.inf)
        slot = jnp.pad(slot, ((0, 0), (0, pad)))

    neg, sel = jax.lax.top_k(-d2, k)
    new_d2 = -neg
    new_slot = jnp.take_along_axis(slot, sel, axis=1)

    # distance to nearest unscanned region (complement of the cube). A
    # periodic dimension with side >= C is fully wrapped for EVERY query;
    # a non-periodic one is fully scanned only when the CLIPPED interval
    # [a, b] covers [0, C-1] — for a boundary-cell query with
    # r + 1 < C <= 2r + 1 the far cells are NOT scanned, so coverage must
    # be evaluated per query (regression: the old static side >= C skip
    # certified wrong neighbors as converged on small-dims trees).
    side = 2 * r + 1
    db = jnp.full((Q,), jnp.inf, jnp.float32)
    covered = jnp.ones((Q,), bool)
    all_dims_coverable = True
    for dim in range(3):
        C = int(dims[dim])
        hd = float(h[dim])
        if periodic:
            if side >= C:
                continue  # fully wrapped: no bound from this dimension
            all_dims_coverable = False
            face_lo = (qcell[:, dim] - r).astype(jnp.float32) * hd + float(lo[dim])
            arc = side * hd
            dlo = queries_w[:, dim] - face_lo
            dhi = arc - dlo
            db = jnp.minimum(db, jnp.maximum(jnp.minimum(dlo, dhi), 0.0))
        else:
            a = jnp.maximum(qcell[:, dim] - r, 0)
            bq = jnp.minimum(qcell[:, dim] + r, C - 1)
            covered = covered & (a == 0) & (bq == C - 1)
            dlo = jnp.where(
                a > 0,
                queries_w[:, dim] - (a.astype(jnp.float32) * hd + float(lo[dim])),
                jnp.inf,
            )
            dhi = jnp.where(
                bq < C - 1,
                ((bq + 1).astype(jnp.float32) * hd + float(lo[dim])) - queries_w[:, dim],
                jnp.inf,
            )
            db = jnp.minimum(db, jnp.maximum(jnp.minimum(dlo, dhi), 0.0))

    kth2 = new_d2[:, -1]
    if not all_dims_coverable:
        covered = jnp.zeros((Q,), bool)
    new_conv = (~overflow) & ((kth2 < db * db) | covered)

    old_d2, old_slot, old_conv, stats = state
    upd = ~old_conv
    d2_out = jnp.where(upd[:, None], new_d2, old_d2)
    slot_out = jnp.where(upd[:, None], new_slot, old_slot)
    conv_out = old_conv | (upd & new_conv)
    cells_scanned, points_visited, cells_pruned = stats
    cells_scanned = cells_scanned + jnp.where(upd, jnp.sum(valid, axis=1), 0)
    points_visited = points_visited + jnp.where(upd, taken, 0)
    # cells excluded by the convergence bound: a query certified in this pass
    # never scans the complement of its cube (reference nodes_pruned analog,
    # kdtree_impl.hpp:249-265)
    ncells_total = int(dims[0]) * int(dims[1]) * int(dims[2])
    cells_pruned = cells_pruned + jnp.where(
        upd & new_conv,
        jnp.maximum(jnp.int32(ncells_total) - cells_scanned, 0),
        0,
    )
    return d2_out, slot_out, conv_out, (cells_scanned, points_visited, cells_pruned)


def default_ladder(k: int, tree: CellList, budget_cap: int = 2048):
    """Static (radius, per-cell slice cap) escalation ladder from build stats.

    ``budget_cap`` bounds every rung's per-cell slice cap (memory for one
    pass scales with cells_in_cube x cap). The rungs themselves are
    k-independent: a rung whose capped scan truncates a cell flags overflow
    and escalates, and queries the ladder cannot certify fall through to
    the exact brute-force pass — so any k is answered exactly.
    """
    mcc = max(tree.max_cell_count, 1)
    cap0 = max(int(budget_cap), 1)
    max_dim = int(np.max(tree.dims))
    rungs = [(1, int(min(mcc, 256, cap0)))]
    if mcc > 256:
        # clustered data: a capacity rung before widening the radius
        rungs.append((1, int(min(mcc, 2048, cap0))))
    for r, cap in ((2, 128), (4, 64)):
        rungs.append((r, int(min(mcc, cap, cap0))))
        if 2 * r + 1 >= max_dim:
            break
    # dedup identical rungs
    out = []
    for rung in rungs:
        if not out or rung != out[-1]:
            out.append(rung)
    return tuple(out)


def _make_query_fn(meta_static, ladder, k, with_fallback, with_stats):
    dims, lo, h, periodic, n, npad = meta_static

    def run(xyz, index, offsets, queries):
        Q = queries.shape[0]
        lo_j = jnp.asarray(lo, jnp.float32)
        h_j = jnp.asarray(h, jnp.float32)
        dims_j = jnp.asarray(dims)
        if periodic:
            L = dims_j.astype(jnp.float32) * h_j
            qw = queries - L[None, :] * jnp.floor(queries / L[None, :])
        else:
            qw = queries
        qcell = jnp.floor((qw - lo_j[None, :]) * (1.0 / h_j)[None, :]).astype(jnp.int32)
        if periodic:
            qcell = jnp.mod(qcell, dims_j[None, :])
        else:
            qcell = jnp.clip(qcell, 0, dims_j[None, :] - 1)

        tree = (xyz, index, offsets)
        meta = (dims, lo, h, periodic, n)
        # zeros derived from the queries so device-variance is uniform across
        # lax.cond branches under shard_map
        zf = queries[0, 0] * 0.0
        zi = zf.astype(jnp.int32)
        state = (
            jnp.full((Q, k), jnp.inf, jnp.float32) + zf,
            jnp.zeros((Q, k), jnp.int32) + zi,
            jnp.zeros((Q,), bool) | (zi != 0),
            (
                jnp.zeros((Q,), jnp.int32) + zi,
                jnp.zeros((Q,), jnp.int32) + zi,
                jnp.zeros((Q,), jnp.int32) + zi,
            ),
        )

        state = _cube_pass(tree, meta, qw, qcell, k, ladder[0][0], ladder[0][1], state)
        for r, budget in ladder[1:]:

            def this_pass(s, _r=r, _b=budget):
                return _cube_pass(tree, meta, qw, qcell, k, _r, _b, s)

            state = jax.lax.cond(
                jnp.any(~state[2]), this_pass, lambda s: s, state
            )

        if with_fallback:
            box = (np.asarray(dims, np.float32) * np.asarray(h, np.float32)) if periodic else None

            def fallback(s):
                d2f, slotf = _streaming_brute_pass(xyz, n, qw, k, box)
                upd = ~s[2]
                return (
                    jnp.where(upd[:, None], d2f, s[0]),
                    jnp.where(upd[:, None], slotf, s[1]),
                    jnp.ones_like(s[2]),
                    (
                        s[3][0],
                        s[3][1] + jnp.where(upd, jnp.int32(n), 0),
                        s[3][2],  # brute-forced queries pruned nothing
                    ),
                )

            state = jax.lax.cond(jnp.any(~state[2]), fallback, lambda s: s, state)

        d2, slot, _, stats = state
        gidx = index[slot]  # uint32; padding slots map to n already
        gidx = jnp.where(jnp.isfinite(d2), gidx, jnp.uint32(n))
        dist = jnp.sqrt(d2)
        if with_stats:
            return dist, gidx, stats[0], stats[1], stats[2]
        return dist, gidx

    return run


@functools.lru_cache(maxsize=64)
def _compiled_query(meta_static, ladder, k, with_fallback, with_stats):
    return jax.jit(_make_query_fn(meta_static, ladder, k, with_fallback, with_stats))


@functools.lru_cache(maxsize=64)
def _compiled_query_chunked(meta_static, ladder, k, with_fallback, chunk):
    """Device-resident query with a bounded per-pass transient.

    The single-program ladder materializes a [Q, cells_in_cube, cap]
    candidate block per pass; at Q = 5e5 with the default ladder that is
    a ~32 GB allocation and the compile itself is rejected on a 16 GB
    chip. This variant scans ``chunk``-query slices with ``lax.map`` so
    the transient stays at chunk scale for any Q, while remaining one
    traced program (jit-composable, no host sync) — the device analog of
    the host path's chunked loop (cell_knn_query below).
    """
    inner = _make_query_fn(meta_static, ladder, k, with_fallback, False)

    @jax.jit
    def run(xyz, index, offsets, queries):
        Q = queries.shape[0]
        if Q <= chunk:
            return inner(xyz, index, offsets, queries)
        pad = (-Q) % chunk
        qp = queries
        if pad:
            qp = jnp.concatenate(
                [queries, jnp.broadcast_to(queries[:1], (pad, 3))]
            )
        d, i = jax.lax.map(
            lambda q: inner(xyz, index, offsets, q),
            qp.reshape(-1, chunk, 3),
        )
        return d.reshape(-1, k)[:Q], i.reshape(-1, k)[:Q]

    return run


def cell_knn_query(
    tree: CellList,
    tree_dev,
    queries,
    k: int,
    ladder: Sequence[tuple[int, int]] | None = None,
    chunk: int = 65536,
    with_fallback: bool = True,
    with_stats: bool = False,
) -> KnnResult:
    """Exact batched k-NN against a :class:`CellList`.

    ``tree_dev`` is the (xyz, index, offsets) device-array triple. Queries are
    processed in host-chunked batches of ``chunk`` (cooperative cancellation
    between chunks, the analog of the reference's per-1000-query signal polling,
    kdtree/src/cpp/pybind.cpp:127-134).
    """
    queries = np.asarray(queries, dtype=np.float32)
    Q = queries.shape[0]
    if k <= 0:
        raise ValueError("k must be positive")  # reference: pybind.cpp:92-94

    if ladder is None:
        ladder = default_ladder(k, tree)
    meta_static = tree.meta_static
    fn = _compiled_query(meta_static, tuple(ladder), int(k), bool(with_fallback), bool(with_stats))
    xyz, index, offsets = tree_dev

    # bound peak memory: the biggest pass materializes [chunk, M, ccap]
    bmax = max(((2 * r + 1) ** 3) * c for r, c in ladder)
    chunk = min(chunk, max(2048, (1 << 25) // bmax))

    out_d = np.empty((Q, k), np.float32)
    out_i = np.empty((Q, k), np.uint32)
    out_cs = np.empty((Q,), np.int32) if with_stats else None
    out_pv = np.empty((Q,), np.int32) if with_stats else None
    out_cp = np.empty((Q,), np.int32) if with_stats else None

    csize = min(chunk, max(Q, 1))
    for s in range(0, max(Q, 1), csize):
        e = min(s + csize, Q)
        qc = queries[s:e]
        if qc.shape[0] < csize:
            qc = np.pad(qc, ((0, csize - qc.shape[0]), (0, 0)))
        res = fn(xyz, index, offsets, jnp.asarray(qc))
        if with_stats:
            d, i, cs, pv, cp = res
            out_cs[s:e] = np.asarray(cs)[: e - s]
            out_pv[s:e] = np.asarray(pv)[: e - s]
            out_cp[s:e] = np.asarray(cp)[: e - s]
        else:
            d, i = res
        out_d[s:e] = np.asarray(d)[: e - s]
        out_i[s:e] = np.asarray(i)[: e - s]

    stats = QueryStatistics(out_cs, out_pv, out_cp) if with_stats else None
    return KnnResult(out_d, out_i, stats)
