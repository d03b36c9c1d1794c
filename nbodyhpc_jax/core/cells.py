"""Cell-list build: the accelerator-friendly replacement for the reference kd-tree build.

The reference builds a pointer-based kd-tree with a recursive median-split and
AVX2 Floyd-Rivest selection (reference: kdtree/src/cpp/include/kdtree/
kdtree_impl.hpp:78-174, kdtree/src/cpp/kdtree_selection.cpp:322-494). Pointer
chasing and data-dependent recursion do not map to XLA, so this design uses a
uniform cell grid instead: points are bucketed into cells, sorted by cell id,
and a per-cell offset table (prefix sums of counts) gives contiguous candidate
ranges. Build is a single sort — O(N log N) like the reference's build, but it
runs as one fused XLA/numpy pass with no recursion.

Build runs eagerly — on the device (multi-operand sort) on a GPU backend
when the problem is large, else on the host (numpy) — and the
measured grid shape / occupancy statistics specialize the jitted query
program (static shapes).
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np

from .points import PAD_SENTINEL, round_up, validate_points

#: Default target mean points per cell. 27 * occupancy candidates are scanned in
#: the first query pass, so this is sized such that one ring suffices for
#: typical k <= 16 (the reference analogously tunes leaf_size=128 so that one
#: leaf scan covers the queue, kdtree/src/python/nbodyhpc/kdtree/__init__.py:24-28).
DEFAULT_OCCUPANCY = 8.0

MAX_CELLS_PER_DIM = 1024


@dataclasses.dataclass
class CellList:
    """Sorted-by-cell point storage plus the per-cell offset table.

    Attributes
    ----------
    xyz : (3, Npad) float32 numpy array
        Points sorted by raveled cell id; padding columns hold ``PAD_SENTINEL``.
    index : (Npad,) uint32
        Original point index for each sorted slot; padding slots hold ``n``.
    offsets : (ncells + 1,) int32 or None
        ``offsets[c]:offsets[c+1]`` is the sorted range of points in cell ``c``
        (row-major ravel of the 3D cell coordinate). ``None`` after a device
        build (the host copy is a multi-MB D2H that only the host-prep query
        path needs — ``offsets_host()`` materializes it lazily; the device
        array lives in ``dev[2]``).
    dims : (3,) int — cells per dimension.
    lo : (3,) float32 — lower corner of the binning box.
    cell_size : (3,) float32 — cell edge length per dimension.
    inv_cell_size : (3,) float32
    n : int — number of real points.
    periodic : bool
    boxsize : (3,) float32 or None — periodic box lengths.
    max_cell_count : int — occupancy of the fullest cell (sizes query budgets).
    """

    xyz: np.ndarray
    index: np.ndarray
    offsets: np.ndarray
    dims: np.ndarray
    lo: np.ndarray
    cell_size: np.ndarray
    inv_cell_size: np.ndarray
    n: int
    periodic: bool
    boxsize: np.ndarray | None
    max_cell_count: int
    #: (xyz, index, offsets) as device arrays when built on-device (the
    #: device-resident fast path; avoids re-uploading through slow links)
    dev: tuple | None = None

    @property
    def ncells(self) -> int:
        return int(np.prod(self.dims))

    @property
    def meta_static(self):
        """Hashable static metadata consumed by the traced query builders
        (``ops.knn._make_query_fn`` / ``_compiled_query``) — one definition
        so every call site shares the same jit-cache key layout."""
        return (
            tuple(int(d) for d in self.dims),
            tuple(float(v) for v in self.lo),
            tuple(float(v) for v in self.cell_size),
            bool(self.periodic),
            int(self.n),
            int(self.xyz.shape[1]),
        )

    def offsets_host(self) -> np.ndarray:
        """Host copy of the per-cell offset table (cached). The device build
        leaves ``offsets`` unmaterialized — at 1e7 points the (ncells+1)
        int32 table is ~5 MB of device-to-host copy that the device query
        paths never need."""
        if self.offsets is None:
            self.offsets = np.asarray(self.dev[2])
        return self.offsets

    def index_host(self) -> np.ndarray:
        """Host copy of the slot->original-index map (cached; the device
        build keeps ``index`` on-device to avoid an eager 4B/point transfer)."""
        cached = getattr(self, "_index_host", None)
        if cached is None:
            cached = np.asarray(self.index)
            object.__setattr__(self, "_index_host", cached)
        return cached


def choose_dims(n: int, extent: np.ndarray, occupancy: float) -> np.ndarray:
    """Pick cells-per-dim so mean occupancy ~= `occupancy`, proportional to extent."""
    n = max(n, 1)
    target_cells = max(n / max(occupancy, 1.0), 1.0)
    extent = np.maximum(np.asarray(extent, dtype=np.float64), 1e-30)
    # cells per dim proportional to extent, product ~= target_cells
    geo = float(np.prod(extent)) ** (1.0 / 3.0)
    per_unit = target_cells ** (1.0 / 3.0) / geo
    dims = np.maximum(1, np.floor(extent * per_unit + 0.5).astype(np.int64))
    return np.minimum(dims, MAX_CELLS_PER_DIM).astype(np.int32)


def cell_coords(points: np.ndarray, lo, inv_h, dims, periodic: bool) -> np.ndarray:
    """(N, 3) integer cell coordinates for points; wraps (periodic) or clips."""
    ic = np.floor((points - lo[None, :]) * inv_h[None, :]).astype(np.int64)
    if periodic:
        ic = np.mod(ic, dims[None, :])
    else:
        ic = np.clip(ic, 0, dims[None, :] - 1)
    return ic


def _device_sort_build(points_f32, lo, inv_h, dims, periodic, npad, n):
    """Device-side build core: cell ids -> multi-operand sort (payloads ride
    the comparator network; no gathers) -> offsets via vectorized binary
    search. ONE jitted program (per (dims, periodic, npad, n) shape class):
    eager per-op dispatch pays a launch ~15 times over and XLA cannot fuse
    the pad/concat chain into the sort operands.
    Returns (xyz (4, npad), index (npad,) uint32, offsets (ncells+1,) int32,
    max_cell_count scalar) — all device arrays, nothing synced."""
    return _jitted_sort_build(
        tuple(int(v) for v in dims), bool(periodic), int(npad), int(n)
    )(points_f32, lo, inv_h)


@functools.lru_cache(maxsize=64)
def _jitted_sort_build(dims, periodic, npad, n):
    """Per-shape-class jitted build program, cached for the process lifetime.

    A fresh ``jax.jit(partial(...))`` per build re-traces and re-lowers the
    whole program every call — measured ~1.9 s of single-core host work per
    1e7-point build (the sort itself executes in ~60 ms; probe 2026-08-19).
    Repeat builds of the same shape class must hit a live jit object."""
    import jax

    return jax.jit(
        functools.partial(
            _sort_build_core, dims=dims, periodic=periodic, npad=npad, n=n
        )
    )


def _sort_build_core(points_f32, lo, inv_h, *, dims, periodic, npad, n):
    import jax
    import jax.numpy as jnp

    Cx, Cy, Cz = dims
    ncells = Cx * Cy * Cz
    lo_j = jnp.asarray(lo, jnp.float32)
    ih_j = jnp.asarray(inv_h, jnp.float32)

    ic = jnp.floor((points_f32 - lo_j[None, :]) * ih_j[None, :]).astype(jnp.int32)
    if periodic:
        ic = jnp.mod(ic, jnp.asarray(dims)[None, :])
    else:
        ic = jnp.clip(ic, 0, jnp.asarray(dims)[None, :] - 1)
    ids = (ic[:, 0] * Cy + ic[:, 1]) * Cz + ic[:, 2]

    # pad to npad with sentinel id = ncells (sorts last)
    pad = npad - n
    ids_p = jnp.concatenate([ids, jnp.full((pad,), ncells, jnp.int32)])
    px = jnp.concatenate([points_f32[:, 0], jnp.full((pad,), PAD_SENTINEL)])
    py = jnp.concatenate([points_f32[:, 1], jnp.full((pad,), PAD_SENTINEL)])
    pz = jnp.concatenate([points_f32[:, 2], jnp.full((pad,), PAD_SENTINEL)])
    idx = jnp.concatenate(
        [jnp.arange(n, dtype=jnp.int32), jnp.full((pad,), n, jnp.int32)]
    )
    sid, sx, sy, sz, sidx = jax.lax.sort(
        (ids_p, px, py, pz, idx), num_keys=1, is_stable=True
    )

    # offsets via searchsorted over the sorted ids (no scatter histogram).
    # At 1e7 ids / 1.26e6 cells on an H100, "scan_unrolled" takes 0.45 ms,
    # "scan" and "sort" 1.0 ms (PERF.md)
    offsets = jnp.searchsorted(
        sid, jnp.arange(ncells + 1, dtype=jnp.int32), method="scan_unrolled"
    ).astype(jnp.int32)

    xyz = jnp.stack([sx, sy, sz, jnp.full_like(sx, PAD_SENTINEL)])
    counts = jnp.diff(offsets)
    return xyz, sidx.astype(jnp.uint32), offsets, jnp.max(counts)


def build_cell_list(
    points: np.ndarray,
    boxsize=None,
    occupancy: float = DEFAULT_OCCUPANCY,
    pad_multiple: int = 128,
    device: bool | None = None,
) -> CellList:
    """Build the cell list. ``device=None`` builds on-device on a GPU
    backend when the problem is large (a multi-operand sort replaces the
    host argsort, and the tree needs no upload afterwards); otherwise a
    host numpy pass.

    ``points`` may be a device-resident jax array (e.g. straight from a
    simulation step): validation and the extent reduction then run on
    device (two tiny host syncs) and the tree is built in place — the
    host path's full-array round trip is exactly what a slow host link
    cannot afford at 1e7+ points."""
    device_points = not isinstance(points, np.ndarray) and hasattr(points, "devices")
    if device_points:
        import jax.numpy as jnp

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
        points = validate_points(points, boxsize)
    n = points.shape[0]
    periodic = boxsize is not None

    if periodic:
        box = np.broadcast_to(np.asarray(boxsize, dtype=np.float32), (3,)).astype(
            np.float32
        )
        lo = np.zeros(3, dtype=np.float32)
        extent = box.astype(np.float64)
    else:
        box = None
        if n > 0:
            if device_points:
                import jax.numpy as jnp

                mm = np.asarray(
                    jnp.stack([jnp.min(points, axis=0), jnp.max(points, axis=0)])
                ).astype(np.float64)
                pmin, pmax = mm[0], mm[1]
            else:
                pmin = points.min(axis=0).astype(np.float64)
                pmax = points.max(axis=0).astype(np.float64)
        else:
            pmin = np.zeros(3)
            pmax = np.ones(3)
        span = np.maximum(pmax - pmin, 1e-12)
        # small margin so max-coordinate points land strictly inside the last cell
        lo = (pmin - 1e-6 * span).astype(np.float32)
        extent = span * (1.0 + 2e-6)

    dims = choose_dims(n, extent, occupancy)
    h = (extent / dims).astype(np.float32)
    inv_h = (1.0 / h).astype(np.float32)

    if device is None:
        from .. import backend

        device = device_points or (backend.platform() == "gpu" and n >= 200_000)
    if device and n:
        import jax.numpy as jnp

        npad = max(round_up(n, pad_multiple), pad_multiple) + 2048
        xyz_d, index_d, offsets_d, mcc = _device_sort_build(
            jnp.asarray(points), lo, inv_h, dims, periodic, npad, n
        )
        # the ONLY host sync in the device build: one scalar (sizes the
        # static query budgets). The full offsets table stays on device;
        # offsets_host() materializes it if the host-prep path asks.
        return CellList(
            xyz=xyz_d,
            index=index_d,
            offsets=None,
            dims=dims,
            lo=lo,
            cell_size=h,
            inv_cell_size=inv_h,
            n=n,
            periodic=periodic,
            boxsize=box,
            max_cell_count=int(mcc),
            dev=(xyz_d, index_d, offsets_d),
        )

    ic = cell_coords(points, lo, inv_h, dims, periodic) if n else np.zeros((0, 3), np.int64)
    raveled = (ic[:, 0] * dims[1] + ic[:, 1]) * dims[2] + ic[:, 2]

    order = np.argsort(raveled, kind="stable")
    sorted_ids = raveled[order]

    ncells = int(np.prod(dims))
    offsets = np.searchsorted(sorted_ids, np.arange(ncells + 1)).astype(np.int32)
    counts = np.diff(offsets)
    max_cell_count = int(counts.max()) if ncells and n else 0

    # +2048 sentinel margin so per-cell candidate slices (knn.py) can always
    # read a full slice without clamping, even for cells ending at n; 4 rows
    # (3 dims + zero row) so whole-array DMA slices satisfy sublane tiling
    npad = max(round_up(max(n, 1), pad_multiple), pad_multiple) + 2048
    xyz = np.full((4, npad), PAD_SENTINEL, dtype=np.float32)
    xyz[:3, :n] = points[order].T
    index = np.full(npad, n, dtype=np.uint32)
    index[:n] = order.astype(np.uint32)

    return CellList(
        xyz=xyz,
        index=index,
        offsets=offsets,
        dims=dims,
        lo=lo,
        cell_size=h,
        inv_cell_size=inv_h,
        n=n,
        periodic=periodic,
        boxsize=box,
        max_cell_count=max_cell_count,
    )
