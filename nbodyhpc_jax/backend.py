"""The one place that reads which JAX backend the library runs on.

Every public path asks :func:`platform` and picks its engine from the
answer: ``"gpu"`` takes the engines compiled for an NVIDIA GPU, ``"cpu"``
the plain-JAX engines (the library's CPU backend, which the tests run on).
No public path falls back from one to the other.
"""
from __future__ import annotations

import jax


def platform() -> str:
    """``"gpu"`` or ``"cpu"`` for the current default JAX backend."""
    backend = jax.default_backend()
    if backend in ("gpu", "cuda"):
        return "gpu"
    if backend == "cpu":
        return "cpu"
    raise RuntimeError(
        f"unsupported JAX backend {backend!r}: nbodyhpc runs on an NVIDIA "
        "GPU or on the CPU"
    )
