"""Device-mesh helpers.

The reference is single-process / single-GPU; its only scale-out axis is the
z-slice decomposition streamed through up to 8 Vulkan queues (reference:
rasterization/src/cpp/point_renderer.cpp:864-946, vulkan_support.cpp:219-225).
This design promotes that slab axis to a first-class device-mesh axis:
grids are sharded along z, particles are partitioned into matching slabs, and
boundary-crossing splats ride ``lax.ppermute`` halo exchanges (SURVEY.md §5.7-8).
"""
from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh

SLAB_AXIS = "z"


def make_slab_mesh(devices=None, axis_name: str = SLAB_AXIS) -> Mesh:
    """1D mesh over all (or given) devices; axis = the grid z-slab axis."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (axis_name,))
