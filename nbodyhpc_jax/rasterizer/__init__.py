"""Public rasterizer API mirroring ``nbodyhpc.rasterizer``.

Drop-in surface for the reference's Python layer (reference: rasterization/
src/python/nbodyhpc/rasterizer/__init__.py:1-143): extent/period
normalization, the cached default container and per-(width, height,
subsample) renderer instances, and ``render_points`` /
``render_points_volume`` with the same argument conventions and the same
(height, width[, num_slices]) Fortran-ordered float32 outputs
(rasterization/src/cpp/pybind.cpp:89-95,116-122).

The Vulkan runtime (VulkanContainer, reference vulkan_support.cpp:150-292)
maps to :class:`Container`, which owns the JAX device context and the
compiled-kernel caches; the graphics pipeline (PointRenderer,
point_renderer.cpp:15-370) maps to :class:`PointRenderer`, which owns the
compiled splat programs for one output shape.
"""
from __future__ import annotations

import functools
from typing import Tuple, Union

import numpy as np

from ..ops import deposit as _deposit
from ..ops import ghosts as _ghosts
from ..ops import splat as _splat

Extent2d = Union[int, Tuple[int, int]]
Extent3d = Union[int, Tuple[int, int, int]]
PeriodT = Union[bool, float, Tuple[float, float, float]]

__all__ = [
    "Container",
    "PointRenderer",
    "get_default_container",
    "get_point_renderer",
    "render_points",
    "render_points_volume",
]


def _normalize_extent_2d(extent: Extent2d) -> Tuple[int, int]:
    if isinstance(extent, (int, np.integer)):
        return int(extent), int(extent)
    return tuple(int(v) for v in extent)


def _normalize_extent_3d(extent: Extent3d) -> Tuple[int, int, int]:
    if isinstance(extent, (int, np.integer)):
        return int(extent), int(extent), int(extent)
    return tuple(int(v) for v in extent)


def _normalize_period(deduced, period: PeriodT):
    """bool -> deduced box or disabled; scalar -> cubic; 2-tuple -> 2D;
    3-tuple -> per-dim (negative disables). Reference __init__.py:27-39."""
    if isinstance(period, (bool, np.bool_)):
        return tuple(deduced) if period else (-1.0, -1.0, -1.0)
    if isinstance(period, (int, float, np.floating, np.integer)):
        p = float(period)
        return (p, p, p)
    period = tuple(float(v) for v in period)
    if len(period) == 2:
        return (period[0], period[1], -1.0)
    return period


class Container:
    """Runtime context: the analog of the reference's ``VulkanContainer``.

    Owns the accelerator device (renders run under
    ``jax.default_device(container.device)``) and the compiled-kernel
    caches. ``enable_validation_layers`` maps to JAX NaN checking, the
    moral equivalent of ``VK_LAYER_KHRONOS_validation``
    (vulkan_support.cpp:132-148) — scoped to this container's renders
    (``jax.debug_nans`` used as a context manager), so one debug
    container does not flip the whole process into checking mode. It
    also arms host-side finite-input validation in the renderers'
    prepare step (the input-side half of the validation layer).
    """

    def __init__(self, enable_validation_layers: bool = False, device=None):
        import jax

        self.validation = bool(enable_validation_layers)
        self.device = device if device is not None else jax.devices()[0]

    def device_ctx(self):
        """Context every render of this container runs under: the pinned
        device, plus NaN-raising checks when validation is enabled."""
        import contextlib

        import jax

        if not self.validation:
            return jax.default_device(self.device)

        @contextlib.contextmanager
        def _ctx():
            with jax.default_device(self.device), jax.debug_nans(True):
                yield

        return _ctx()

    def __repr__(self):
        return f"Container(device={self.device}, validation={self.validation})"


@functools.lru_cache(maxsize=None)
def get_default_container() -> Container:
    """Default runtime container (cached), reference __init__.py:42-52."""
    return Container(enable_validation_layers=False)


def _validate_arrays(positions, weights, radii):
    """Shape validation mirroring ``assemble_vertices`` (pybind.cpp:25-52)."""
    positions = np.ascontiguousarray(positions, np.float32)
    weights = np.ascontiguousarray(weights, np.float32)
    radii = np.ascontiguousarray(radii, np.float32)
    if positions.ndim != 2 or positions.shape[1] != 3:
        raise ValueError("positions must be a 2D array of shape (N, 3)")
    if weights.ndim != 1:
        raise ValueError("weight must be a 1D array")
    if radii.ndim != 1:
        raise ValueError("radii must be a 1D array")
    if radii.shape[0] != positions.shape[0]:
        raise ValueError("radii must have the same length as positions")
    if weights.shape[0] != positions.shape[0]:
        raise ValueError("weights must have the same length as positions")
    return positions, weights, radii


class PointRenderer:
    """Sphere-splat renderer for one output shape.

    Constructor signature mirrors the reference binding
    ``PointRenderer(container, width, height, subsample_factor=4)``
    (pybind.cpp:141-167). As in the reference, the output arrays have shape
    ``(height, width[, num_slices])`` where the *height* axis spans position-x
    (the internal transpose documented at point_renderer.h:53-59).

    ``engine``: ``"auto"`` (the deposit kernel on a GPU, the plain-JAX
    engine on the CPU; 2D slices below 200k particles take the oracle),
    ``"plain"``, ``"kernel"`` (GPU only) or ``"oracle"``
    (:mod:`nbodyhpc_jax.ops.splat`'s chunked reference).
    """

    def __init__(self, container: Container | None, width: int, height: int,
                 subsample_factor: int = 4, engine: str = "auto"):
        self.container = container if container is not None else get_default_container()
        self.width = int(width)
        self.height = int(height)
        self.subsample_factor = int(subsample_factor)
        self.engine = engine
        # logical grid: axis 0 (nx) <- height <- position x
        self._nx, self._ny = self.height, self.width

    # -- internals ---------------------------------------------------------
    def _prepare(self, positions, weights, radii, period):
        positions, weights, radii = _validate_arrays(positions, weights, radii)
        if self.container.validation:
            # input-side validation layer: catch poisoned inputs before they
            # reach the device (the output side is the scoped debug_nans
            # context in Container.device_ctx)
            for name, arr in (("positions", positions), ("weights", weights),
                              ("radii", radii)):
                if not np.all(np.isfinite(arr)):
                    raise ValueError(
                        f"validation layer: non-finite values in {name}"
                    )
        if any(p > 0 for p in period):
            positions, weights, radii = _ghosts.augment_points_periodic(
                positions, weights, radii, period
            )
        return positions, weights, radii

    def _use_engine(self, n: int, threshold: int) -> bool:
        """Volume engine (ops/deposit.py) or the chunked oracle: "auto"
        takes the engine from ``threshold`` particles up."""
        if self.engine == "oracle":
            return False
        return self.engine != "auto" or n >= threshold

    def render_points(self, positions, weights, radii, pixels_per_unit: float,
                      period=(-1.0, -1.0, -1.0)) -> np.ndarray:
        """Render one 2D slice at z=0; returns (height, width) float32 F-order.

        Reference path: pybind.cpp:73-96 + point_renderer.cpp:606-657.
        The 2D plane (depth 0, bounds (-0.5, 0.5] px) is exactly 3D slice 0
        with z shifted by half a pixel, so large inputs route through the
        volume engine on a one-voxel z-slab (the oracle's 256-particle
        chunked dispatch is minutes at 1e7 points); the half-pixel shift
        rounds once in f32, so engine and oracle agree to round-off, not
        bit-exactly.
        """
        positions, weights, radii = self._prepare(positions, weights, radii, period)
        ctx = self.container.device_ctx()
        if self._use_engine(positions.shape[0], 200_000):
            ppu = float(pixels_per_unit)
            pos2 = np.array(positions, np.float32, copy=True)
            weights = np.asarray(weights, np.float32)
            # big particles: the 2D slab is one PIXEL thick around z=0
            # (fragment corner at -0.5 px) == 3D voxel 0 shifted half a
            # pixel. Sub-pixel particles: the reference's z-select is
            # +-0.5 UNITS (splat.py footprint_values_2d): evaluate that
            # predicate HERE with the oracle's exact f32 expression (a z
            # remap would double-round and could move a boundary particle's
            # whole weight across the slice edge), then park selected
            # particles safely mid-slab and zero the rest.
            is_sub = radii * np.float32(ppu) < 0.5
            zpx = positions[:, 2] * np.float32(ppu)
            zu = zpx * np.float32(1.0 / ppu)
            zsel = (zu > np.float32(-0.5)) & (zu <= np.float32(0.5))
            pos2[:, 2] = np.where(
                is_sub,
                np.float32(0.5 / ppu),  # mid-slab: always pixel-voxel 0
                positions[:, 2] + np.float32(0.5 / ppu),
            )
            weights = np.where(is_sub & ~zsel, np.float32(0.0), weights)
            with ctx:
                img = np.asarray(
                    _deposit.splat_volume(
                        pos2, weights, radii, ppu, (self._nx, self._ny, 1),
                        self.subsample_factor, engine=self.engine,
                    )
                )[:, :, 0]
        else:
            with ctx:
                img = _splat.splat_2d_oracle(
                    positions, weights, radii, float(pixels_per_unit),
                    (self._nx, self._ny), self.subsample_factor,
                )
        return np.asfortranarray(img)

    def render_points_volume(self, positions, weights, radii, num_slices: int,
                             pixels_per_unit: float,
                             period=(-1.0, -1.0, -1.0)) -> np.ndarray:
        """Render the full volume; returns (height, width, num_slices) float32
        F-order. Reference path: pybind.cpp:98-123 +
        point_renderer.cpp:825-950."""
        positions, weights, radii = self._prepare(positions, weights, radii, period)
        grid = (self._nx, self._ny, int(num_slices))
        with self.container.device_ctx():
            if self._use_engine(positions.shape[0], 0):
                vol = _deposit.splat_volume(
                    positions, weights, radii, float(pixels_per_unit), grid,
                    self.subsample_factor, engine=self.engine,
                )
                # transposed on device, so the host copy is the F-order
                # array itself (no host-side reorder of a multi-GB grid)
                return np.asarray(vol.transpose(2, 1, 0)).T
            vol = _splat.splat_volume_oracle(
                positions, weights, radii, float(pixels_per_unit), grid,
                self.subsample_factor,
            )
        return np.asfortranarray(vol)


@functools.lru_cache(maxsize=None)
def _get_point_renderer_impl(width: int, height: int, subsample_factor: int = 4,
                             container: Container | None = None) -> PointRenderer:
    return PointRenderer(container, width, height, subsample_factor)


def get_point_renderer(grid_size: Extent2d, subsample_factor: int = 4,
                       container: Container | None = None) -> PointRenderer:
    """Cached renderer for a grid size; reference __init__.py:60-84 (note the
    reference's height/width unpack order, preserved here)."""
    if container is None:
        container = get_default_container()
    height, width = _normalize_extent_2d(grid_size)
    return _get_point_renderer_impl(width, height, subsample_factor, container)


def render_points(positions, weights, radii, pixels_per_unit: float,
                  grid_size: Extent2d, periodic: PeriodT = False) -> np.ndarray:
    """Render points in the z=0 slice; reference __init__.py:87-101."""
    grid_x, grid_y = _normalize_extent_2d(grid_size)
    renderer = get_point_renderer((grid_x, grid_y))
    deduced = (grid_x / pixels_per_unit, grid_y / pixels_per_unit, -1.0)
    period = _normalize_period(deduced, periodic)
    return renderer.render_points(positions, weights, radii, pixels_per_unit, period)


def render_points_volume(positions, weights, radii, pixels_per_unit: float,
                         grid_size: Extent3d, periodic: PeriodT = False,
                         subsample_factor: int = 4) -> np.ndarray:
    """Render points into a 3D density grid; reference __init__.py:104-143.

    Returns float32 array of shape ``(grid_x, grid_y, num_slices)``,
    Fortran-contiguous, where voxel (i, j, k) covers
    ``[i, i+1) x [j, j+1) x [k, k+1) / pixels_per_unit`` in position space.
    """
    grid_x, grid_y, num_slices = _normalize_extent_3d(grid_size)
    deduced_box = (
        grid_x / pixels_per_unit,
        grid_y / pixels_per_unit,
        num_slices / pixels_per_unit,
    )
    period = _normalize_period(deduced_box, periodic)
    renderer = get_point_renderer((grid_x, grid_y), subsample_factor)
    return renderer.render_points_volume(
        positions, weights, radii, num_slices, pixels_per_unit, period
    )
