"""Public k-NN API mirroring ``nbodyhpc.kdtree``.

Drop-in surface for the reference's Python wrapper (reference: kdtree/src/
python/nbodyhpc/kdtree/__init__.py:11-56 and the pybind layer kdtree/src/cpp/
pybind.cpp:196-216): ``KDTree(points, leafsize=128, max_threads=-1,
boxsize=None)`` with ``.query(points, k=1, workers=1)`` returning
``(distances float32 ascending, indices uint32)``, plus the ``n``/``size``/
``periodic``/``boxsize`` properties.

Internally this is not a kd-tree: it is a sorted cell-list engine with batched
expanding-cube queries (see :mod:`nbodyhpc_jax.ops.knn`), a design that maps
onto batched accelerator programs — but the name and contract are preserved so
reference users can switch without code changes.
"""
from __future__ import annotations

import warnings
from typing import Tuple

import jax.numpy as jnp
import numpy as np

from ..core.cells import build_cell_list
from ..ops import knn as _knn
from ..ops.knn import QueryStatistics

__all__ = ["KDTree", "QueryStatistics"]


class KDTree:
    """Spatial k-NN index with optional periodic boundary conditions.

    Parameters mirror the reference wrapper (kdtree/__init__.py:17-38):

    points : (N, 3) array
    leafsize : int
        Brute-force granularity hint. The reference switches to an AVX2 leaf
        scan below this count; here it sets the target cell occupancy of the
        cell grid (``occupancy ~= leafsize / 16``).
    max_threads : int
        Accepted for compatibility; construction is a single vectorized pass.
    boxsize : float or 3-tuple, optional
        Periodic box size. Points must lie in ``[0, boxsize]``
        (reference: pybind.cpp:42-46 raises on out-of-box points).
    """

    def __init__(self, points, leafsize: int = 128, max_threads: int = -1,
                 boxsize=None, **kwargs):
        if len(kwargs) > 0:
            warnings.warn("Unrecognized keyword arguments: {}".format(kwargs))
        occupancy = max(2.0, float(leafsize) / 16.0)
        if isinstance(points, np.ndarray) or not hasattr(points, "devices"):
            points = np.asarray(points)
        # device-resident points build in place (build_cell_list device path)
        self._tree = build_cell_list(points, boxsize=boxsize,
                                     occupancy=occupancy)
        self._dev = self._tree.dev or (
            jnp.asarray(self._tree.xyz),
            jnp.asarray(self._tree.index),
            jnp.asarray(self._tree.offsets),
        )

    # --- properties, reference pybind.cpp:212-215 ---
    @property
    def n(self) -> int:
        return self._tree.n

    @property
    def size(self) -> int:
        return self._tree.n

    @property
    def periodic(self) -> bool:
        return self._tree.periodic

    @property
    def boxsize(self):
        if self._tree.boxsize is None:
            return None
        b = self._tree.boxsize
        return float(b[0]) if np.all(b == b[0]) else tuple(float(v) for v in b)

    def query(self, points, k: int = 1, workers: int = 1, **kwargs
              ) -> Tuple[np.ndarray, np.ndarray]:
        """Exact k nearest neighbors for each query point.

        Matches the reference contract (kdtree/__init__.py:40-56,
        pybind.cpp:90-189): queries of shape (..., 3) are flattened to 2D and
        results reshaped to (..., k); distances are float32, ascending, with
        the sqrt postprocess applied; indices are uint32. ``k <= 0`` raises.
        Missing neighbors (k > n) get distance ``inf`` and index ``n``.
        ``workers`` maps the reference's thread fan-out
        (pybind.cpp:164-172) to chips: ``workers != 1`` shards the query
        batch over all visible devices (``parallel.sharded``); with a
        single device it is a no-op (queries are batched on the
        accelerator either way).
        """
        if len(kwargs) > 0:
            warnings.warn("Unrecognized keyword arguments: {}".format(kwargs))
        if k <= 0:
            raise ValueError("k must be positive")
        points = np.asarray(points, dtype=np.float32)
        shape = None
        if points.ndim != 2:
            shape = points.shape
            points = points.reshape((-1, shape[-1]))
        if points.shape[-1] != 3:
            raise ValueError("query points must have 3 coordinates")

        import jax

        if workers != 1 and len(jax.devices()) > 1 and points.shape[0] > 0:
            from ..parallel.sharded import knn_query_sharded

            distances, indices = knn_query_sharded(
                self._tree, self._dev, points, k
            )
            indices = indices.astype(np.uint32)
        else:
            res = _knn.cell_knn_query(self._tree, self._dev, points, k)
            distances, indices = res.distances, res.indices

        if shape is not None:
            distances = distances.reshape(shape[:-1] + (k,))
            indices = indices.reshape(shape[:-1] + (k,))
        return distances, indices

    def query_device(self, queries, k: int = 1):
        """Fully device-resident exact k-NN: jax arrays in, jax arrays out.

        The expanding-cube ladder (with brute-force fallback) runs as one
        traced program — jit-composable, scanning bounded-memory
        ``lax.map`` chunks so any Q compiles within the per-pass candidate
        budget. Returns (distances (Q, k) f32 ascending, indices (Q, k)
        uint32).
        """
        if k <= 0:
            raise ValueError("k must be positive")
        t = self._tree
        ladder = _knn.default_ladder(k, t)
        # same per-pass transient bound as the host-chunked path
        bmax = max(((2 * r + 1) ** 3) * c for r, c in ladder)
        chunk = max(2048, (1 << 25) // bmax)
        fn = _knn._compiled_query_chunked(t.meta_static, ladder, k, True, chunk)
        xyz, index, offsets = self._dev
        return fn(xyz, index, offsets, queries)

    def query_with_statistics(self, points, k: int = 1):
        """Like :meth:`query` but also returns per-query
        :class:`QueryStatistics` (cells scanned, candidate points visited,
        cells pruned by the convergence bound) — the analog of the
        reference's KDTreeQueryStatistics output (kdtree.hpp:124-131,
        199-210: nodes_visited / points_visited / nodes_pruned)."""
        points = np.asarray(points, dtype=np.float32).reshape(-1, 3)
        res = _knn.cell_knn_query(self._tree, self._dev, points, k, with_stats=True)
        return res.distances, res.indices, res.stats

    def query_radius_count(self, points, radius) -> np.ndarray:
        """Number of points within ``radius`` of each query (ball count).

        Periodicity follows the tree. Radius may be scalar or per-query.
        """
        from ..ops.ball import ball_count

        points = np.asarray(points, dtype=np.float32).reshape(-1, 3)
        return ball_count(self._tree, self._dev, points, radius)
