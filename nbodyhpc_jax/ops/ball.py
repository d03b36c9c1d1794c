"""Fixed-radius (ball) queries: neighbor counts within a radius.

The reference exposes only k-NN, but ball counts are the natural companion for
kNN-CDF / correlation statistics (see :mod:`nbodyhpc_jax.utils.stats`).

Two engines, picked by profitability:

- **Cell-list cube scan** (default for radii small relative to the box): each
  query scans the anisotropic cell cube guaranteed to contain its ball
  (per-dim Chebyshev cell radius ``ceil(r_max / h_d)``), fetching every cell's
  candidates as one contiguous slice of the sorted cell-list layout — the
  same gather-free batched-dynamic-slice pattern as the k-NN engine's
  :func:`nbodyhpc_jax.ops.knn._cube_pass` (reference analog: the kd-tree
  radius traversal would prune by box distance,
  kdtree/src/cpp/include/kdtree/kdtree_impl.hpp:185-269). The per-cell slice
  cap is the tree's ``max_cell_count``, so no truncation is possible and the
  count is exact by construction — no escalation ladder is needed.
- **Dense masked scan** (fallback): a streaming O(N x Q) elementwise pass over the
  whole padded point array — profitable when the cube would cover a large
  fraction of the points anyway (huge radii / tiny trees), and the only
  option the signature guarantees for any input.

Both count with an inclusive boundary (``d2 <= r2``), matching
``scipy.spatial.KDTree.query_ball_point``.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..core.cells import CellList
from .metrics import wrap_min_image

#: cap on cells per query cube before the dense scan takes over (a cube this
#: large means the radius spans a big chunk of the box, where the dense
#: scan's zero-overhead streaming wins anyway)
MAX_CUBE_CELLS = 2048

#: per-chunk candidate-transient budget (f32 elements): bounds the
#: [qc, M, ccap] distance array to ~128 MiB
CHUNK_BUDGET = 1 << 25


@functools.lru_cache(maxsize=32)
def _compiled_count(npad, n, periodic, box, block):
    def run(xyz, queries, r2):
        q = queries  # [Q, 3]
        nblocks = npad // block

        def body(acc, i):
            d2 = jnp.zeros((q.shape[0], block), jnp.float32)
            for dim in range(3):
                px = jax.lax.dynamic_slice(xyz, (dim, i * block), (1, block))
                d = q[:, dim : dim + 1] - px
                if periodic:
                    d = wrap_min_image(d, float(box[dim]))
                d2 = d2 + d * d
            slot = i * block + jax.lax.broadcasted_iota(jnp.int32, (1, block), 1)
            ok = (d2 <= r2[:, None]) & (slot < n)
            return acc + jnp.sum(ok, axis=1, dtype=jnp.int32), None

        acc, _ = jax.lax.scan(body, jnp.zeros((q.shape[0],), jnp.int32), jnp.arange(nblocks))
        return acc

    return jax.jit(run)


@functools.lru_cache(maxsize=32)
def _compiled_cell_count(meta_static, rc, ccap):
    """Jitted anisotropic-cube ball counter for one (tree shape, cube shape).

    ``rc`` is the per-dim cell radius triple; ``ccap`` the per-cell slice cap
    (== the tree's fullest cell, so the count never truncates).
    """
    dims, lo, h, periodic, n, npad = meta_static

    # static cube offsets, with wrapped-duplicate cells removed per dim
    # (a periodic dim with 2*rc+1 >= dims would alias cells; keep the first
    # dims[d] offsets so each cell appears exactly once)
    offs, keep = [], []
    for d in range(3):
        o = np.arange(-rc[d], rc[d] + 1)
        offs.append(o)
        keep.append((o + rc[d]) < dims[d] if periodic else np.ones_like(o, bool))
    M_off = np.stack(np.meshgrid(*offs, indexing="ij"), axis=-1).reshape(-1, 3)
    static_valid = np.stack(
        np.meshgrid(*keep, indexing="ij"), axis=-1
    ).reshape(-1, 3).all(axis=1)
    M = M_off.shape[0]

    def run(xyz, offsets, queries, r2):
        Q = queries.shape[0]
        lo_j = jnp.asarray(lo, jnp.float32)
        h_j = jnp.asarray(h, jnp.float32)
        if periodic:
            L = jnp.asarray(dims, jnp.float32) * h_j
            qw = queries - L[None, :] * jnp.floor(queries / L[None, :])
        else:
            qw = queries
        qcell = jnp.floor((qw - lo_j[None, :]) * (1.0 / h_j)[None, :]).astype(jnp.int32)

        # per-dim cube cell coordinates ([Q, M] each; split per dim, so
        # no array carries a padded trailing axis of 3)
        ccd = []
        if periodic:
            qcell = jnp.mod(qcell, jnp.asarray(dims)[None, :])
            for dim in range(3):
                c = qcell[:, dim : dim + 1] + int(dims[dim]) + M_off[None, :, dim]
                ccd.append(jnp.mod(c, int(dims[dim])))
            valid = jnp.broadcast_to(jnp.asarray(static_valid)[None, :], (Q, M))
        else:
            qcell = jnp.clip(qcell, 0, jnp.asarray(dims)[None, :] - 1)
            valid = jnp.ones((Q, M), bool)
            for dim in range(3):
                c = qcell[:, dim : dim + 1] + M_off[None, :, dim]
                valid = valid & (c >= 0) & (c < int(dims[dim]))
                ccd.append(jnp.clip(c, 0, int(dims[dim]) - 1))

        ids = (ccd[0] * int(dims[1]) + ccd[1]) * int(dims[2]) + ccd[2]
        starts = offsets[ids]
        counts = jnp.where(valid, offsets[ids + 1] - starts, 0)  # [Q, M]

        # contiguous per-cell candidate slices (see ops/knn.py::_cube_pass for
        # the clamping analysis: with ccap >= max_cell_count the re-aimed
        # validity window always covers the whole cell — exact, no overflow)
        starts_cl = jnp.minimum(starts, max(npad - ccap, 0))
        delta = starts - starts_cl
        j_idx = jnp.arange(ccap, dtype=jnp.int32)
        valid_c = (
            valid[:, :, None]
            & (j_idx[None, None, :] >= delta[:, :, None])
            & (j_idx[None, None, :] < (delta + counts)[:, :, None])
        )
        slice2 = jax.vmap(jax.vmap(
            lambda arr, s: jax.lax.dynamic_slice(arr, (s,), (ccap,)),
            in_axes=(None, 0)), in_axes=(None, 0))
        d2 = jnp.zeros((Q, M, ccap), jnp.float32)
        for dim in range(3):
            px = slice2(xyz[dim], starts_cl)  # [Q, M, ccap]
            d = qw[:, dim, None, None] - px
            if periodic:
                d = wrap_min_image(d, float(dims[dim]) * float(h[dim]))
            d2 = d2 + d * d
        ok = valid_c & (d2 <= r2[:, None, None])
        return jnp.sum(ok, axis=(1, 2), dtype=jnp.int32)

    return jax.jit(run)


def ball_count(tree: CellList, tree_dev, queries, radius, chunk: int = 16384,
               engine: str = "auto") -> np.ndarray:
    """Count points within ``radius`` of each query point (inclusive boundary).

    ``radius`` may be a scalar or a per-query array; the cube engine sizes
    its (static) cell cube from the max radius and masks per query.
    ``engine``: "auto" picks by profitability; "cells" / "dense" force one
    (both exact — used by tests to cross-check).
    """
    assert engine in ("auto", "cells", "dense")
    xyz, _, offsets = tree_dev
    queries = np.asarray(queries, np.float32)
    Q = queries.shape[0]
    r = np.broadcast_to(np.asarray(radius, np.float32), (Q,)).astype(np.float32)
    if Q == 0:
        return np.empty((0,), np.int32)
    npad = int(tree.xyz.shape[1])
    r_max = float(r.max())

    # cube-engine profitability: cells covered x slice cap vs the dense
    # scan's npad candidates per query
    rc = tuple(
        int(np.ceil(r_max * float(tree.inv_cell_size[d]))) for d in range(3)
    )
    M = int(np.prod([2 * c + 1 for c in rc]))
    ccap = min(max(int(tree.max_cell_count), 1), npad)
    if engine == "auto":
        use_cells = tree.n > 0 and M <= MAX_CUBE_CELLS and M * ccap < npad
    else:
        use_cells = engine == "cells" and tree.n > 0

    if use_cells:
        fn = _compiled_cell_count(tree.meta_static, rc, ccap)
        qc = int(min(max(CHUNK_BUDGET // max(M * ccap, 1), 1), chunk, 4096))
        args = (xyz, offsets)
    else:
        from .knn import _divisor_block

        block = _divisor_block(npad, min(4096, npad))
        box = tuple(float(v) for v in tree.boxsize) if tree.periodic else None
        fn = _compiled_count(npad, int(tree.n), bool(tree.periodic), box, block)
        qc = min(chunk, max(Q, 1))
        args = (xyz,)

    out = np.empty((Q,), np.int32)
    for s in range(0, Q, qc):
        e = min(s + qc, Q)
        qch = queries[s:e]
        rch = r[s:e]
        if qch.shape[0] < qc:
            pad = qc - qch.shape[0]
            qch = np.pad(qch, ((0, pad), (0, 0)))
            # padded rows count nothing: d2 >= 0 can never be <= -1
            rch = np.pad(rch, (0, pad), constant_values=-1.0)
        r2 = jnp.asarray(np.where(rch >= 0, rch * rch, -1.0))
        out[s:e] = np.asarray(fn(*args, jnp.asarray(qch), r2))[: e - s]
    return out
