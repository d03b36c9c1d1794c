"""Multi-device sharding tests on the virtual 8-device CPU mesh.

Validates the z-slab halo-exchange render and the query-sharded k-NN against
their single-device counterparts (exactness across shard boundaries is the
'correct-once' property from SURVEY.md §7.3 item 5)."""
import jax
import numpy as np
import pytest

from nbodyhpc_jax.kdtree import KDTree
from nbodyhpc_jax.parallel.mesh import make_slab_mesh
from nbodyhpc_jax.parallel.sharded import (
    knn_query_sharded,
    render_points_volume_sharded,
)
from nbodyhpc_jax.rasterizer import render_points_volume


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) == 8, "tests expect the virtual 8-device CPU mesh"
    return make_slab_mesh()


def _particles(n, seed, box=1.0):
    rng = np.random.Generator(np.random.Philox(seed))
    pos = (rng.random((n, 3)) * box).astype(np.float32)
    w = rng.random(n).astype(np.float32) + 0.5
    r = (rng.random(n) * 0.08 + 0.01).astype(np.float32)
    return pos, w, r


def test_sharded_render_matches_single_device(mesh):
    pos, w, r = _particles(2000, 1)
    ppu, grid = 32.0, (32, 32, 32)
    vol, overflow = render_points_volume_sharded(pos, w, r, ppu, grid, mesh=mesh)
    assert overflow == 0
    ref = render_points_volume(pos, w, r, ppu, grid)
    np.testing.assert_allclose(vol, ref, rtol=2e-5, atol=1e-6)


def test_sharded_render_periodic(mesh):
    pos, w, r = _particles(1000, 2)
    ppu, grid = 24.0, (24, 24, 24)
    vol, overflow = render_points_volume_sharded(
        pos, w, r, ppu, grid, periodic=True, mesh=mesh
    )
    assert overflow == 0
    ref = render_points_volume(pos, w, r, ppu, grid, periodic=True)
    np.testing.assert_allclose(vol, ref, rtol=2e-5, atol=1e-6)
    # periodic render conserves mass exactly across slab boundaries
    np.testing.assert_allclose(vol.sum(), w.sum(), rtol=5e-3)


def test_sharded_render_boundary_straddlers(mesh):
    """Particles placed exactly on slab boundaries are counted exactly once."""
    nd = 8
    gz = 32
    zb = (np.arange(1, nd) * (gz // nd)) / 32.0  # slab boundary z positions
    pos = np.stack(
        [np.full(nd - 1, 0.5), np.full(nd - 1, 0.5), zb], axis=1
    ).astype(np.float32)
    w = np.ones(nd - 1, np.float32)
    r = np.full(nd - 1, 0.1, np.float32)
    vol, overflow = render_points_volume_sharded(pos, w, r, 32.0, (32, 32, 32), mesh=mesh)
    assert overflow == 0
    ref = render_points_volume(pos, w, r, 32.0, 32)
    np.testing.assert_allclose(vol, ref, rtol=2e-5, atol=1e-6)


def test_sharded_render_mid_radius_bucket(mesh):
    """Radii up to 6.5 px span several radius classes per shard and must
    match the single-device render across slab boundaries."""
    rng = np.random.Generator(np.random.Philox(31))
    n = 400
    pos = rng.random((n, 3)).astype(np.float32)
    w = rng.random(n).astype(np.float32) + 0.5
    ppu = 32.0
    r = ((0.5 + rng.random(n) * 6.0) / ppu).astype(np.float32)  # 0.5-6.5 px
    vol, overflow = render_points_volume_sharded(
        pos, w, r, ppu, (32, 32, 32), mesh=mesh, band_cap=512
    )
    assert overflow == 0
    ref = render_points_volume(pos, w, r, ppu, 32)
    np.testing.assert_allclose(vol, ref, rtol=2e-5, atol=1e-6)


def test_sharded_render_dense_tail(mesh):
    """Radii up to 9 px (footprints deeper than a 4-voxel slab) need
    multi-hop halos and still match the single-device render."""
    rng = np.random.Generator(np.random.Philox(33))
    n = 40
    pos = rng.random((n, 3)).astype(np.float32)
    w = rng.random(n).astype(np.float32) + 0.5
    ppu = 32.0
    r = ((6.0 + rng.random(n) * 3.0) / ppu).astype(np.float32)  # up to 9 px
    vol, overflow = render_points_volume_sharded(
        pos, w, r, ppu, (32, 32, 32), mesh=mesh, band_cap=256
    )
    assert overflow == 0
    ref = render_points_volume(pos, w, r, ppu, 32)
    np.testing.assert_allclose(vol, ref, rtol=2e-5, atol=1e-6)


def test_sharded_render_31px_mixed(mesh):
    """Mixed workload whose largest footprint (31 px radius) spans many
    slabs: multi-hop halo exchange + dense pass must stay exact."""
    rng = np.random.Generator(np.random.Philox(37))
    n = 24
    pos = rng.random((n, 3)).astype(np.float32)
    w = rng.random(n).astype(np.float32) + 0.5
    ppu = 32.0
    r = np.concatenate(
        [
            ((0.5 + rng.random(16) * 4.0) / ppu),  # window classes
            ((20.0 + rng.random(8) * 11.0) / ppu),  # dense, up to 31 px
        ]
    ).astype(np.float32)
    vol, overflow = render_points_volume_sharded(
        pos, w, r, ppu, (32, 32, 32), mesh=mesh, band_cap=256
    )
    assert overflow == 0
    ref = render_points_volume(pos, w, r, ppu, 32)
    np.testing.assert_allclose(vol, ref, rtol=2e-5, atol=1e-6)


def test_sharded_render_device_inputs_streamed_batches(mesh):
    """Device-resident inputs take the all-device path (ghost augmentation +
    slab partition in device memory, host sees only per-slab counts), and a
    deliberately tiny ``batch`` forces every shard through MULTIPLE class
    batches of the traced engine — the memory-bounded streaming the
    reference gets from per-slice draw ranges (point_renderer.cpp:864-946)."""
    import jax.numpy as jnp

    pos, w, r = _particles(3000, 21)
    ppu, grid = 32.0, (32, 32, 32)
    vol, overflow = render_points_volume_sharded(
        jnp.asarray(pos), jnp.asarray(w), jnp.asarray(r), ppu, grid,
        periodic=True, mesh=mesh, batch=256,  # ~3000/8 + halo rows => >1 batch
    )
    assert overflow == 0
    ref = render_points_volume(pos, w, r, ppu, grid, periodic=True)
    np.testing.assert_allclose(vol, ref, rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(vol).sum(), w.sum(), rtol=5e-3)


def test_query_workers_shards_over_devices(mesh):
    """KDTree.query(workers=-1) is the reference's thread fan-out mapped to
    chips: results must equal the single-device path exactly."""
    pos, _, _ = _particles(4000, 12)
    q, _, _ = _particles(513, 13)
    tree = KDTree(pos, boxsize=1.0)
    d1, i1 = tree.query(q, k=6)
    d8, i8 = tree.query(q, k=6, workers=-1)
    np.testing.assert_array_equal(i1, i8)
    np.testing.assert_allclose(d1, d8, rtol=1e-6)
    assert i8.dtype == np.uint32


def test_query_device_matches_host():
    import jax.numpy as jnp

    pos, _, _ = _particles(3000, 14)
    q, _, _ = _particles(200, 15)
    tree = KDTree(pos)
    d, i = tree.query_device(jnp.asarray(q), k=5)
    dref, iref = tree.query(q, k=5)
    np.testing.assert_array_equal(np.asarray(i), iref)
    np.testing.assert_allclose(np.asarray(d), dref, rtol=1e-6)


def test_query_device_large_batch_chunked():
    """Batches above the per-pass candidate budget must scan in bounded
    lax.map chunks (a 5e5-query single program wanted a 32 GB transient);
    answers must stay exact, including the non-multiple tail padding."""
    import jax.numpy as jnp

    from nbodyhpc_jax.ops import knn as _knn

    pos, _, _ = _particles(3000, 16)
    tree = KDTree(pos, boxsize=1.0)
    ladder = _knn.default_ladder(4, tree._tree)
    bmax = max(((2 * r + 1) ** 3) * c for r, c in ladder)
    chunk = max(2048, (1 << 25) // bmax)
    rng = np.random.default_rng(17)
    q = rng.random((2 * chunk + 137, 3), dtype=np.float32)
    d, i = tree.query_device(jnp.asarray(q), k=4)
    assert d.shape == (q.shape[0], 4)
    dref, iref = tree.query(q, k=4)
    np.testing.assert_array_equal(np.asarray(i), iref)
    np.testing.assert_allclose(np.asarray(d), dref, rtol=1e-6)


def test_sharded_knn_matches_single(mesh):
    pos, _, _ = _particles(5000, 3)
    q, _, _ = _particles(999, 4)  # odd count exercises padding
    tree = KDTree(pos)
    d, i = knn_query_sharded(tree._tree, tree._dev, q, 8, mesh=mesh)
    dref, iref = tree.query(q, k=8)
    np.testing.assert_array_equal(i, iref)
    np.testing.assert_allclose(d, dref, rtol=1e-6)


def test_sharded_knn_periodic(mesh):
    pos, _, _ = _particles(3000, 5)
    q, _, _ = _particles(256, 6)
    tree = KDTree(pos, boxsize=1.0)
    d, i = knn_query_sharded(tree._tree, tree._dev, q, 4, mesh=mesh)
    dref, iref = tree.query(q, k=4)
    np.testing.assert_array_equal(i, iref)
    np.testing.assert_allclose(d, dref, rtol=1e-6)


def test_sharded_knn_cdf_matches_host(mesh):
    from nbodyhpc_jax.parallel.stats import knn_cdf_sharded

    pos, _, _ = _particles(4000, 9)
    tree = KDTree(pos, boxsize=1.0)
    radii = np.linspace(0.0, 0.2, 16)
    r, cdf = knn_cdf_sharded(tree._tree, tree._dev, (1, 4), radii,
                             n_queries=2048, mesh=mesh, seed=3)
    assert cdf.shape == (2, 16)
    assert np.all(np.diff(cdf, axis=1) >= 0)
    assert np.all((cdf >= 0) & (cdf <= 1))
    assert np.all(cdf[0] >= cdf[1])
    # analytic Poisson check for k=1 in the mid-range
    n = tree.n
    expect = 1.0 - np.exp(-n * 4.0 / 3.0 * np.pi * radii**3)
    mid = (cdf[0] > 0.2) & (cdf[0] < 0.8)
    assert np.allclose(cdf[0][mid], expect[mid], atol=0.07)
