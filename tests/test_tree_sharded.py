"""Sharded k-NN tree (slab-partitioned point set) on the virtual 8-CPU mesh.

Distance tolerance note: the sharded tree stores slab-LOCAL z coordinates,
so each squared distance is computed as ((q-z0)-(p-z0))^2 — one extra f32
rounding vs the single-device path's (q-p)^2. Indices must still match
exactly on non-degenerate data; distances are compared to ~1 ulp.

Exactness contract: `knn_query_tree_sharded` with overflow == 0 must match
the single-device (replicated-tree) path exactly — boundary-crossing
candidate exchange via ppermute hops is the SURVEY §5.8 component the
replicated path cannot provide (tree size capped at one device's memory)."""
import jax
import numpy as np
import pytest

from nbodyhpc_jax.kdtree import KDTree
from nbodyhpc_jax.parallel.mesh import make_slab_mesh
from nbodyhpc_jax.parallel.tree_sharded import (
    build_tree_sharded,
    knn_query_tree_sharded,
)


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) == 8, "tests expect the virtual 8-device CPU mesh"
    return make_slab_mesh()


def _pts(n, seed, box=1.0):
    rng = np.random.Generator(np.random.Philox(seed))
    return (rng.random((n, 3)) * box).astype(np.float32)


def test_build_partitions_all_points(mesh):
    pts = _pts(4000, 41)
    st = build_tree_sharded(pts, mesh=mesh)
    assert st.counts.sum() == 4000
    assert st.n == 4000
    # every original index appears exactly once across shards
    idx = np.asarray(st.index).reshape(-1)
    real = idx[idx < 4000]
    assert np.array_equal(np.sort(real), np.arange(4000, dtype=np.uint32))


def test_sharded_tree_matches_single(mesh):
    pts = _pts(6000, 42)
    q = _pts(777, 43)  # odd count exercises routing pad
    st = build_tree_sharded(pts, mesh=mesh)
    d, i, overflow = knn_query_tree_sharded(st, q, 8)
    assert overflow == 0
    tree = KDTree(pts)
    dref, iref = tree.query(q, k=8)
    np.testing.assert_array_equal(i, iref)
    np.testing.assert_allclose(d, dref, rtol=1e-5, atol=1e-7)


def test_sharded_tree_periodic_matches_single(mesh):
    pts = _pts(4000, 44)
    q = _pts(512, 45)
    st = build_tree_sharded(pts, boxsize=1.0, mesh=mesh)
    d, i, overflow = knn_query_tree_sharded(st, q, 6)
    assert overflow == 0
    tree = KDTree(pts, boxsize=1.0)
    dref, iref = tree.query(q, k=6)
    np.testing.assert_array_equal(i, iref)
    np.testing.assert_allclose(d, dref, rtol=1e-5, atol=1e-7)


def test_sharded_tree_boundary_queries_cross_slabs(mesh):
    """Queries pinned to slab faces with k large enough that the top-k MUST
    include neighbors from adjacent slabs: the ppermute exchange is load-
    bearing, not decorative."""
    pts = _pts(3000, 46)
    nd = 8
    zb = (np.arange(1, nd) / nd).astype(np.float32)  # slab boundaries
    q = np.stack(
        [np.full(nd - 1, 0.5), np.full(nd - 1, 0.5), zb], axis=1
    ).astype(np.float32)
    st = build_tree_sharded(pts, mesh=mesh)
    d, i, overflow = knn_query_tree_sharded(st, q, 32)
    assert overflow == 0
    tree = KDTree(pts)
    dref, iref = tree.query(q, k=32)
    np.testing.assert_array_equal(i, iref)
    np.testing.assert_allclose(d, dref, rtol=1e-5, atol=1e-7)


def test_sharded_tree_periodic_wrap_hop(mesh):
    """Queries at the z~0 face of a periodic box need candidates from the
    LAST slab (ring wrap): the hop exchange must ride the wrapped ppermute
    edge and the min-image metric."""
    pts = _pts(2500, 47)
    rng = np.random.Generator(np.random.Philox(48))
    q = rng.random((64, 3)).astype(np.float32)
    q[:, 2] = (rng.random(64) * 0.02 - 0.01) % 1.0  # straddle z = 0
    st = build_tree_sharded(pts, boxsize=1.0, mesh=mesh)
    d, i, overflow = knn_query_tree_sharded(st, q, 16)
    assert overflow == 0
    tree = KDTree(pts, boxsize=1.0)
    dref, iref = tree.query(q, k=16)
    np.testing.assert_array_equal(i, iref)
    np.testing.assert_allclose(d, dref, rtol=1e-5, atol=1e-7)


def test_sharded_tree_limited_hops_certifies(mesh):
    """hops=1 answers most queries; any it cannot certify must be counted
    in overflow, never silently wrong: every query either matches the
    exact reference or is covered by the overflow certificate."""
    pts = _pts(3000, 49)
    q = _pts(256, 50)
    st = build_tree_sharded(pts, mesh=mesh)
    d, i, overflow = knn_query_tree_sharded(st, q, 4, hops=1)
    tree = KDTree(pts)
    dref, iref = tree.query(q, k=4)
    mismatch = int(np.sum(np.any(i != iref, axis=1)))
    assert mismatch <= overflow
    # dense uniform data at k=4: hop 1 should certify everything
    assert overflow == 0
    np.testing.assert_array_equal(i, iref)


def test_sharded_tree_k_exceeds_slab_population(mesh):
    """k larger than any single slab's population: answers must pull from
    many slabs (deep hops) and still match the reference exactly."""
    pts = _pts(400, 51)  # ~50 per slab
    q = _pts(64, 52)
    st = build_tree_sharded(pts, mesh=mesh)
    d, i, overflow = knn_query_tree_sharded(st, q, 128)
    assert overflow == 0
    tree = KDTree(pts)
    dref, iref = tree.query(q, k=128)
    np.testing.assert_array_equal(i, iref)
    np.testing.assert_allclose(d, dref, rtol=1e-5, atol=1e-7)


def test_sharded_tree_queries_outside_box(mesh):
    """Non-periodic trees accept queries outside the point cloud's bounding
    box (scipy semantics); routing clips them to edge slabs."""
    pts = _pts(2000, 53)
    rng = np.random.Generator(np.random.Philox(54))
    q = (rng.random((64, 3)) * 2.0 - 0.5).astype(np.float32)  # in [-0.5, 1.5)
    st = build_tree_sharded(pts, mesh=mesh)
    d, i, overflow = knn_query_tree_sharded(st, q, 5)
    assert overflow == 0
    tree = KDTree(pts)
    dref, iref = tree.query(q, k=5)
    np.testing.assert_array_equal(i, iref)
    np.testing.assert_allclose(d, dref, rtol=1e-5, atol=1e-7)


def test_sharded_tree_k_exceeds_n(mesh):
    """k > n: missing neighbors get distance inf and index n, matching the
    single-device contract."""
    pts = _pts(100, 55)
    q = _pts(16, 56)
    st = build_tree_sharded(pts, mesh=mesh)
    d, i, overflow = knn_query_tree_sharded(st, q, 128)
    assert overflow == 0
    tree = KDTree(pts)
    dref, iref = tree.query(q, k=128)
    np.testing.assert_array_equal(i, iref)
    finite = np.isfinite(dref)
    np.testing.assert_allclose(d[finite], dref[finite], rtol=1e-5, atol=1e-7)
    assert np.all(np.isinf(d[~finite]))
    assert np.all(i[:, 100:] == 100)


def test_sharded_tree_scale_1e6_8shards(mesh):
    """Production-scale validation on the CPU mesh (VERDICT r4 #5): 1e6
    points partitioned across all 8 slabs, periodic box, 4096 queries —
    overflow must certify 0 and indices must match scipy exactly (the
    single-tree oracle at this scale). Also pins the device routing path
    (sort -> slab rows -> unsort) at a row height where every shard is
    hit."""
    import scipy.spatial as sps

    n, nq, k = 1_000_000, 4096, 8
    pts = _pts(n, 61)
    q = _pts(nq, 62)
    st = build_tree_sharded(pts, boxsize=1.0, mesh=mesh)
    assert st.counts.sum() == n and (st.counts > 0).all()
    d, i, overflow = knn_query_tree_sharded(st, q, k)
    assert overflow == 0
    ref = sps.cKDTree(pts, boxsize=1.0)
    rd, ri = ref.query(q, k=k)
    np.testing.assert_allclose(d, rd.astype(np.float32), rtol=2e-6, atol=2e-7)
    match = (i == ri).mean()
    # identical indices except possible f32-degenerate ties
    assert match > 0.9999, f"index match {match}"


def test_device_resident_build_and_query(mesh):
    """Device-resident points build the sharded tree without a host round
    trip (device slab sort + per-shard slicing; the host syncs only the
    nd counts) and must answer identically to the host-partitioned build.
    Device queries come back as device arrays."""
    import jax.numpy as jnp

    pts = _pts(20000, 71)
    q = _pts(1500, 72)
    st_h = build_tree_sharded(pts, boxsize=1.0, mesh=mesh)
    st_d = build_tree_sharded(jnp.asarray(pts), boxsize=1.0, mesh=mesh)
    assert st_d.counts.sum() == 20000
    np.testing.assert_array_equal(st_h.counts, st_d.counts)
    dh, ih, ovh = knn_query_tree_sharded(st_h, q, 6)
    dd, id_, ovd = knn_query_tree_sharded(st_d, jnp.asarray(q), 6)
    assert ovh == 0 and ovd == 0
    assert not isinstance(dd, np.ndarray)  # device in -> device out
    np.testing.assert_array_equal(ih, np.asarray(id_))
    np.testing.assert_allclose(dh, np.asarray(dd), rtol=1e-6, atol=1e-7)


def test_single_slab_periodic_z_wrap(mesh):
    """A 1-device mesh owns the whole z extent: z must bin periodically
    (wrap-adjacent cells reachable by the ladder) or every z-boundary
    query falls through to the brute backstop — at production scale that
    was minutes of device time per chunk.
    Exactness pinned with queries ON the z faces against scipy."""
    import jax as _jax
    import scipy.spatial as sps
    from jax.sharding import Mesh

    m1 = Mesh(np.asarray(_jax.devices()[:1]), ("slab",))
    pts = _pts(30000, 83)
    st = build_tree_sharded(pts, boxsize=1.0, mesh=m1)
    rng = np.random.Generator(np.random.Philox(84))
    q = rng.random((512, 3)).astype(np.float32)
    q[:200, 2] = rng.uniform(0.0, 0.004, 200)    # hugging z=0
    q[200:400, 2] = rng.uniform(0.996, 1.0, 200)  # hugging z=L
    d, i, overflow = knn_query_tree_sharded(st, q, 8)
    assert overflow == 0
    ref = sps.cKDTree(pts, boxsize=1.0)
    rd, ri = ref.query(q, k=8)
    np.testing.assert_allclose(d, rd.astype(np.float32), rtol=2e-6, atol=2e-7)
    assert (i == ri).mean() > 0.999
