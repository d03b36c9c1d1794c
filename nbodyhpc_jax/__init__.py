"""nbodyhpc_jax — N-body post-processing framework in JAX.

A from-scratch JAX/XLA/Pallas rebuild of the capabilities of wendazhou/nbodyhpc,
running on an NVIDIA GPU (and on the CPU for tests):

- :mod:`nbodyhpc_jax.kdtree` — periodic 3D k-NN engine (cell-list + batched
  expanding-cube queries) with the reference's ``KDTree``/``query`` API.
- :mod:`nbodyhpc_jax.rasterizer` — mass-conserving anti-aliased sphere-splat
  rasterization of point clouds into 2D/3D density fields with periodic wrap,
  with the reference's ``render_points``/``render_points_volume`` API.
- :mod:`nbodyhpc_jax.parallel` — mesh/shard_map layer: slab-sharded grids,
  halo exchange between devices, sharded query fan-out.
"""

__version__ = "0.1.0"

import os as _os


def compile_cache_dir(environ=None):
    """Directory this package points JAX's persistent compile cache at.

    ``None`` when ``JAX_COMPILATION_CACHE_DIR`` is set: JAX reads that
    variable itself and the package sets nothing. Otherwise ``.jax_cache``
    at the checkout root — a fixed path, because the path is part of the
    cache key and a directory that moves never hits.
    """
    environ = _os.environ if environ is None else environ
    if environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    root = _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))
    return _os.path.join(root, ".jax_cache")


_cache = compile_cache_dir()
if _cache is not None:
    import jax as _jax

    _jax.config.update("jax_compilation_cache_dir", _cache)

from . import core, ops, utils  # noqa: F401
