"""Host runtime: particle file IO and fast data generation.

Dispatches to the native ``_hostio`` C extension (csrc/hostio.c — mmap'd
loads, threaded Philox4x32 generation, double-buffered streaming) when
built, with numpy fallbacks so the framework works everywhere. Both paths
agree on error behavior: files whose size is not a record multiple raise
(native validates at open; the fallback's reshape errors), and short reads
raise instead of fabricating rows. File formats mirror the reference CLIs:
packed float32 ``(x, y, z)`` triples (reference: kdtree/src/cpp/
main.cpp:103-114) and packed ``(x, y, z, weight, radius)`` records
(rasterization/src/cpp/main.cpp:86-101).
"""
from __future__ import annotations

import numpy as np

try:
    from nbodyhpc_jax import _hostio  # type: ignore

    HAVE_NATIVE = True
except ImportError:  # pragma: no cover
    _hostio = None
    HAVE_NATIVE = False


def load_points(path: str) -> np.ndarray:
    """(N, 3) float32 positions from a packed float3 file."""
    if HAVE_NATIVE:
        return _hostio.read_records(path, 3)
    return np.fromfile(path, dtype=np.float32).reshape(-1, 3)


def load_particles(path: str):
    """(positions, weights, radii) from packed (x, y, z, w, r) records."""
    if HAVE_NATIVE:
        rec = _hostio.read_records(path, 5)
    else:
        rec = np.fromfile(path, dtype=np.float32).reshape(-1, 5)
    return rec[:, :3].copy(), rec[:, 3].copy(), rec[:, 4].copy()


def save_particles(path: str, positions, weights, radii) -> None:
    rec = np.empty((len(weights), 5), np.float32)
    rec[:, :3] = positions
    rec[:, 3] = weights
    rec[:, 4] = radii
    if HAVE_NATIVE:
        _hostio.write_records(path, rec)
    else:
        rec.tofile(path)


def save_field(path: str, density: np.ndarray) -> None:
    """Persist a density field (float32 raw + .shape sidecar) — the analog of
    the reference demo's golden binary dumps (rasterization/src/cpp/
    main.cpp:74-83)."""
    arr = np.ascontiguousarray(np.asarray(density), np.float32)
    arr.tofile(path)
    with open(path + ".shape", "w") as f:
        f.write(" ".join(str(s) for s in arr.shape))


def load_field(path: str) -> np.ndarray:
    with open(path + ".shape") as f:
        shape = tuple(int(v) for v in f.read().split())
    return np.fromfile(path, dtype=np.float32).reshape(shape)


def stream_particles(path: str, batch_rows: int = 4_000_000):
    """Yield (positions, weights, radii) batches from packed (x, y, z, w, r)
    records with double-buffered prefetch: a native reader thread loads
    batch i+1 while the caller renders batch i — the host analog of the
    reference's dedicated transfer queue overlapping uploads with compute
    (rasterization/src/cpp/vulkan_support.cpp:204-237). Falls back to
    synchronous chunked reads without the C extension."""
    if HAVE_NATIVE:
        loader = _hostio.stream_open(path, 5, int(batch_rows))
        try:
            while True:
                rec = loader.next_chunk()
                if rec is None:
                    break
                yield rec[:, :3].copy(), rec[:, 3].copy(), rec[:, 4].copy()
        finally:
            loader.close()
    else:  # pragma: no cover
        rec_bytes = 5 * 4
        with open(path, "rb") as f:
            while True:
                raw = f.read(int(batch_rows) * rec_bytes)
                if not raw:
                    break
                rec = np.frombuffer(raw, np.float32).reshape(-1, 5)
                yield rec[:, :3].copy(), rec[:, 3].copy(), rec[:, 4].copy()


def generate_uniform(n: int, seed: int = 42, boxsize: float = 1.0,
                     nthreads: int = 0) -> np.ndarray:
    """(n, 3) float32 uniform positions; native path is a threaded
    counter-based Philox stream (identical for any thread count)."""
    if HAVE_NATIVE:
        flat = _hostio.philox_uniform(n * 3, seed, boxsize, nthreads)
        return flat.reshape(n, 3)
    rng = np.random.Generator(np.random.Philox(seed))
    return (rng.random((n, 3)) * boxsize).astype(np.float32)
