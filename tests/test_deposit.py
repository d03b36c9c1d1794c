"""Radius-class deposit engine (ops/deposit.py): plain engine vs the oracle,
the backend decision point and the compile-cache rule.

The oracle (ops/splat.py) is the independent reference: the engine
evaluates the same footprint on tighter per-class windows and accumulates
with a scatter-add, so it agrees with the oracle to float32 round-off plus
at most one knife-edge subcell quantum per voxel at large radii
(test_splat_dense._quantum_atol).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from test_splat_dense import _quantum_atol

import nbodyhpc_jax
from nbodyhpc_jax import backend
from nbodyhpc_jax.ops import deposit
from nbodyhpc_jax.ops.ghosts import augment_points_periodic
from nbodyhpc_jax.ops.splat import splat_volume_oracle
from nbodyhpc_jax.rasterizer import PointRenderer, render_points_volume

#: pixel-radius range of every class: the window classes, then the dense tail
CLASS_RANGES = [
    (0.0 if c == 0 else deposit.CLASS_HALF[c - 1], h)
    for c, h in enumerate(deposit.CLASS_HALF)
] + [(deposit.CLASS_HALF[-1], deposit.CLASS_HALF[-1] + 5.0)]


def class_particles(cls, n, seed, grid, ppu, spill=0.1):
    """``n`` particles whose pixel radii fill class ``cls``'s range (class 0
    includes sub-pixel ones); positions spill ``spill`` of the box past
    every face, so windows straddle the grid faces."""
    rng = np.random.Generator(np.random.Philox(seed))
    lo, hi = CLASS_RANGES[cls]
    box = np.array([g / ppu for g in grid], np.float32)
    pos = rng.random((n, 3)) * (1 + 2 * spill) - spill
    pos = (pos * box).astype(np.float32)
    w = (rng.random(n) + 0.5).astype(np.float32)
    rpx = lo + (hi - lo) * (1.0 - rng.random(n))  # (lo, hi]
    return pos, w, (rpx / ppu).astype(np.float32)


@pytest.mark.parametrize("cls", range(deposit.DENSE + 1))
def test_plain_engine_matches_oracle_per_class(cls):
    grid, ppu = (20, 16, 24), 16.0
    pos, w, r = class_particles(cls, 24, 100 + cls, grid, ppu)
    cnt, _ = deposit.class_counts(r * ppu, w)
    assert cnt[cls] == len(w)  # the fixture really fills this class
    want = splat_volume_oracle(pos, w, r, ppu, grid)
    got = np.asarray(deposit.splat_volume(pos, w, r, ppu, grid, engine="plain"))
    assert got.shape == grid
    np.testing.assert_allclose(
        got, want, rtol=1e-6, atol=1e-7 + _quantum_atol(w, r * ppu)
    )


@pytest.mark.parametrize("cls", range(deposit.DENSE + 1))
def test_plain_engine_periodic_face_straddlers(cls):
    """Periodic render through the public API (ghost clones across every
    face) against the oracle on the same ghost-augmented set; mass of
    spheres that fit in the box is conserved."""
    grid, ppu = (24, 24, 24), 24.0
    pos, w, r = class_particles(cls, 16, 200 + cls, grid, ppu, spill=0.0)
    pos[: len(pos) // 2, cls % 3] *= 0.02  # hug a face
    got = render_points_volume(pos, w, r, ppu, grid, periodic=True)
    gp, gw, gr = augment_points_periodic(pos, w, r, (1.0, 1.0, 1.0))
    want = splat_volume_oracle(gp, gw, gr, ppu, grid)
    np.testing.assert_allclose(
        got, want, rtol=1e-6, atol=1e-7 + _quantum_atol(gw, gr * ppu)
    )
    if CLASS_RANGES[cls][1] < 6:
        np.testing.assert_allclose(got.sum(), w.sum(), rtol=0.05)


def test_sort_by_class_layout():
    """One sort: rows grouped class-major (zero weight last), boundaries
    agree with radius_class, pad rows appended up to the batch cap."""
    grid, ppu = (16, 16, 16), 16.0
    rng = np.random.Generator(np.random.Philox(5))
    n = 300
    ppx = rng.random((n, 3)).astype(np.float32) * 16
    rpx = (rng.random(n) * 22).astype(np.float32)
    w = rng.random(n).astype(np.float32)
    w[::7] = 0.0
    cols, bounds, rmax = deposit.sort_by_class(
        jnp.asarray(ppx), jnp.asarray(w), jnp.asarray(rpx), grid
    )
    bounds = np.asarray(bounds)
    assert bounds[0] == 0 and bounds[-1] == n
    assert np.all(np.diff(bounds) >= 0)
    cls = np.asarray(deposit.radius_class(cols[4][:n], cols[3][:n]))
    for c in range(deposit.TRASH + 1):
        assert np.all(cls[bounds[c]:bounds[c + 1]] == c)
    assert cols[3].shape[0] == deposit.batch_cap(n)
    assert np.all(np.asarray(cols[3][n:]) == 0.0)
    dense = (rpx > deposit.CLASS_HALF[-1]) & (w != 0)
    assert float(rmax) == float(rpx[dense].max())
    # the payload columns are a permutation of the input rows
    got = np.sort(np.asarray(cols[0][:n]))
    np.testing.assert_array_equal(got, np.sort(ppx[:, 0]))


def test_batch_cap_quantization():
    assert deposit.batch_cap(1) == 128
    assert deposit.batch_cap(129) == 256
    assert deposit.batch_cap(5000, batch=1000) == 512
    assert deposit.batch_cap(10**8) == deposit.MAX_BATCH
    for c in (1, 77, 128, 3000, 70000):
        cap = deposit.batch_cap(c)
        assert cap & (cap - 1) == 0 and cap >= min(c, deposit.MAX_BATCH)


def test_render_points_2d_engine_matches_oracle():
    """The 2D plane is 3D slice 0 shifted half a pixel: the engine-backed
    route (taken from 200k particles up) agrees with the 2D oracle, for
    sub-pixel and big particles around the slab."""
    rng = np.random.Generator(np.random.Philox(17))
    n = 60
    ppu = 32.0
    pos = rng.random((n, 3)).astype(np.float32)
    pos[:, 2] = (rng.random(n) - 0.5).astype(np.float32) * 0.3
    w = (rng.random(n) + 0.5).astype(np.float32)
    r = ((0.2 + rng.random(n) * 6.0) / ppu).astype(np.float32)
    got = PointRenderer(None, 32, 32, engine="plain").render_points(pos, w, r, ppu)
    want = PointRenderer(None, 32, 32, engine="oracle").render_points(pos, w, r, ppu)
    np.testing.assert_allclose(
        got, want, rtol=1e-5, atol=1e-6 + _quantum_atol(w, r * ppu)
    )


# --- the backend decision point ------------------------------------------


@pytest.mark.parametrize(
    "jax_backend, want",
    [("cpu", "cpu"), ("gpu", "gpu"), ("cuda", "gpu"), ("rocm", None)],
)
def test_platform_maps_backends(monkeypatch, jax_backend, want):
    monkeypatch.setattr(backend.jax, "default_backend", lambda: jax_backend)
    if want is None:
        with pytest.raises(RuntimeError, match="unsupported JAX backend"):
            backend.platform()
    else:
        assert backend.platform() == want


def test_engine_choice_follows_platform(monkeypatch):
    assert backend.platform() == "cpu"
    assert deposit.resolve_engine("auto") == "plain"
    assert deposit.resolve_engine("plain") == "plain"
    assert deposit.resolve_engine("kernel", interpret=True) == "kernel"
    with pytest.raises(ValueError, match="unknown splat engine"):
        deposit.resolve_engine("pallas")
    monkeypatch.setattr(backend, "platform", lambda: "gpu")
    assert deposit.resolve_engine("auto") == "kernel"
    assert deposit.resolve_engine("plain") == "plain"


def test_kernel_engine_on_cpu_raises():
    """No public path interprets: asking for the kernel on the CPU backend
    raises instead of silently running the Pallas interpreter."""
    pos = np.full((4, 3), 0.5, np.float32)
    w = np.ones(4, np.float32)
    r = np.full(4, 0.1, np.float32)
    with pytest.raises(ValueError, match="compiled for the GPU"):
        deposit.resolve_engine("kernel")
    with pytest.raises(ValueError, match="compiled for the GPU"):
        PointRenderer(None, 8, 8, engine="kernel").render_points_volume(
            pos, w, r, 8, 8.0
        )


def test_device_tree_build_follows_platform(monkeypatch):
    """The cell-list build runs on the device for large host inputs on a
    GPU backend, on the host on the CPU backend."""
    from nbodyhpc_jax.core.cells import build_cell_list

    pts = np.random.Generator(np.random.Philox(3)).random(
        (200_000, 3), dtype=np.float32
    )
    assert build_cell_list(pts, boxsize=1.0).dev is None
    monkeypatch.setattr(backend, "platform", lambda: "gpu")
    assert build_cell_list(pts, boxsize=1.0).dev is not None


# --- the compile-cache rule ------------------------------------------------


def test_compile_cache_dir_defers_to_environment():
    assert nbodyhpc_jax.compile_cache_dir(
        {"JAX_COMPILATION_CACHE_DIR": "/somewhere/else"}
    ) is None


def test_compile_cache_dir_fixed_at_checkout_root():
    root = os.path.dirname(os.path.dirname(os.path.abspath(nbodyhpc_jax.__file__)))
    assert nbodyhpc_jax.compile_cache_dir({}) == os.path.join(root, ".jax_cache")
    # the tests themselves never write a cache
    assert not jax.config.jax_enable_compilation_cache
