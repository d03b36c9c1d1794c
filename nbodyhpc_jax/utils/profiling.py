"""Profiling and observability helpers.

The reference's observability is wall-clock printouts plus per-query
statistics (reference: kdtree CLI main.cpp:169-174; KDTreeQueryStatistics,
kdtree.hpp:124-131 — mirrored by :class:`nbodyhpc_jax.ops.knn.
QueryStatistics`). The additions are the XLA profiler trace (the
analog of the Vulkan validation/debug messenger toolchain) and a simple
wall-clock scope.
"""
from __future__ import annotations

import contextlib
import time


@contextlib.contextmanager
def trace(logdir: str = "/tmp/nbodyhpc_jax_trace"):
    """Capture a device trace viewable in TensorBoard / Perfetto."""
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield logdir
    finally:
        jax.profiler.stop_trace()


@contextlib.contextmanager
def timer(label: str = "", sink=print):
    """Wall-clock scope (the reference CLIs' timing printouts)."""
    t0 = time.perf_counter()
    box = {}
    try:
        yield box
    finally:
        box["seconds"] = time.perf_counter() - t0
        if label:
            sink(f"{label}: {box['seconds']:.3f} s")
