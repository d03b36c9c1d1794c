"""SoA point storage, padding, and input validation.

Analog of the reference's ``PositionAndIndexArray`` SoA container
(reference: kdtree/src/cpp/include/kdtree/position_array.hpp:20-358) and of the
pybind input path ``make_positions_and_indices`` (kdtree/src/cpp/pybind.cpp:14-56),
which validates an (N, 3) float array, pads N up to a block multiple with FLT_MAX
sentinels so padded points never win a nearest-neighbor contest, and checks box
containment when a periodic box size is given (pybind.cpp:42-46).

Here the block multiple is 128 (a whole number of warps and vector lanes) instead of the AVX2
width 8, and storage is a dense ``(3, Npad)`` float32 array (dimension-major, the
same per-dimension contiguous layout as the reference SoA).
"""
from __future__ import annotations

import dataclasses

import numpy as np

PAD_MULTIPLE = 128
#: Sentinel coordinate for padding points; large but finite so that squared
#: distances stay finite in float32 (FLT_MAX**2 would overflow to inf and
#: break comparisons in some top-k paths). Any real point always wins.
PAD_SENTINEL = np.float32(3.0e18)


def round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def validate_points(points: np.ndarray, boxsize=None) -> np.ndarray:
    """Validate an (N, 3) point array, returning it as contiguous float32.

    Mirrors reference semantics (kdtree/src/cpp/pybind.cpp:35-47): points must be
    a 2D array with 3 columns; with a periodic ``boxsize`` every coordinate must
    satisfy ``0 <= x <= L``.
    """
    points = np.asarray(points)
    if points.ndim != 2 or points.shape[1] != 3:
        raise ValueError(f"points must have shape (N, 3), got {points.shape}")
    points = np.ascontiguousarray(points, dtype=np.float32)
    if boxsize is not None:
        L = np.asarray(boxsize, dtype=np.float32)
        if np.any(L <= 0):
            raise ValueError("boxsize must be positive")
        if np.any(points < 0) or np.any(points > L):
            raise ValueError(
                "points must be contained in the box [0, boxsize] when boxsize is given"
            )
    return points


@dataclasses.dataclass
class PaddedSoA:
    """Dimension-major padded point storage.

    Attributes
    ----------
    xyz : np.ndarray
        (3, Npad) float32; columns ``n:`` hold the :data:`PAD_SENTINEL`.
    n : int
        Number of real points.
    """

    xyz: np.ndarray
    n: int

    @property
    def npad(self) -> int:
        return self.xyz.shape[1]


def to_padded_soa(points: np.ndarray, pad_multiple: int = PAD_MULTIPLE) -> PaddedSoA:
    """Pad (N, 3) points to a lane multiple with sentinel coordinates.

    Reference analog: pad N -> ceil(N/8)*8 with FLT_MAX (pybind.cpp:49-53); here
    the multiple is 128 and the sentinel is a large finite float32.
    """
    n = points.shape[0]
    npad = max(round_up(max(n, 1), pad_multiple), pad_multiple)
    xyz = np.full((3, npad), PAD_SENTINEL, dtype=np.float32)
    xyz[:, :n] = points.T
    return PaddedSoA(xyz=xyz, n=n)
