"""KDTree parity tests.

Reproduces the reference's Python integration test strategy (reference:
kdtree/tests/test_kdtree.py:1-35 — exact index equality and allclose distances
vs scipy.spatial.KDTree, plain and periodic) plus the C++ suites' brute-force
oracle checks (kdtree/src/cpp/tests/test.cpp:14-37,89-111)."""
import numpy as np
import pytest
import scipy.spatial

from nbodyhpc_jax.kdtree import KDTree
from nbodyhpc_jax.ops import knn as _knn


def _random_points(n, seed, box=1.0):
    rng = np.random.Generator(np.random.Philox(seed))
    return (rng.random(size=(n, 3)) * box).astype(np.float32)


def test_kdtree_matches_scipy():
    # reference: kdtree/tests/test_kdtree.py:6-19
    points = _random_points(10000, 42)
    queries = _random_points(200, 43)

    tree = KDTree(points)
    dist, idx = tree.query(queries, k=4)

    ref = scipy.spatial.KDTree(points)
    rdist, ridx = ref.query(queries, k=4)

    np.testing.assert_array_equal(idx, ridx.astype(np.uint32))
    np.testing.assert_allclose(dist, rdist, rtol=1e-5, atol=1e-6)


def test_kdtree_matches_scipy_periodic():
    # reference: kdtree/tests/test_kdtree.py:21-35
    boxsize = 2.0
    points = _random_points(10000, 7, box=boxsize)
    queries = _random_points(200, 8, box=boxsize)

    tree = KDTree(points, boxsize=boxsize)
    dist, idx = tree.query(queries, k=4)

    ref = scipy.spatial.KDTree(points, boxsize=boxsize)
    rdist, ridx = ref.query(queries, k=4)

    np.testing.assert_array_equal(idx, ridx.astype(np.uint32))
    np.testing.assert_allclose(dist, rdist, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n", [10, 100, 1000])
@pytest.mark.parametrize("periodic", [False, True])
def test_small_trees_vs_bruteforce(n, periodic):
    # reference: kdtree/src/cpp/tests/test.cpp:113-114 parametrizes N in {10,100,1000}
    box = 1.0
    points = _random_points(n, 100 + n, box=box)
    queries = _random_points(100, 200 + n, box=box)
    k = min(8, n)

    tree = KDTree(points, boxsize=box if periodic else None)
    dist, idx = tree.query(queries, k=k)

    if periodic:
        ref = scipy.spatial.KDTree(points, boxsize=box)
    else:
        ref = scipy.spatial.KDTree(points)
    rdist, ridx = ref.query(queries, k=k)
    if k == 1:
        rdist, ridx = rdist[:, None], ridx[:, None]

    np.testing.assert_array_equal(idx, ridx.astype(np.uint32))
    np.testing.assert_allclose(dist, rdist, rtol=1e-5, atol=1e-6)


def test_self_query_returns_zero_distance():
    # the CLI benchmark self-query invariant, reference kdtree/src/cpp/main.cpp:74-88
    points = _random_points(2000, 3)
    tree = KDTree(points)
    dist, idx = tree.query(points[:100], k=1)
    np.testing.assert_array_equal(idx[:, 0], np.arange(100, dtype=np.uint32))
    np.testing.assert_allclose(dist[:, 0], 0.0, atol=1e-6)


def test_query_reshape_semantics():
    # reference wrapper reshapes (..., 3) queries, kdtree/__init__.py:44-55
    points = _random_points(500, 11)
    queries = _random_points(24, 12).reshape(2, 3, 4, 3)
    tree = KDTree(points)
    dist, idx = tree.query(queries, k=2)
    assert dist.shape == (2, 3, 4, 2)
    assert idx.shape == (2, 3, 4, 2)
    d2, i2 = tree.query(queries.reshape(-1, 3), k=2)
    np.testing.assert_array_equal(idx.reshape(-1, 2), i2)


def test_unknown_kwargs_warn():
    # reference kdtree/__init__.py:37-38,41-42
    points = _random_points(100, 1)
    with pytest.warns(UserWarning):
        tree = KDTree(points, bogus_arg=1)
    with pytest.warns(UserWarning):
        tree.query(points[:4], k=1, bogus=2)


def test_invalid_inputs():
    points = _random_points(100, 1)
    tree = KDTree(points)
    with pytest.raises(ValueError):
        tree.query(points[:4], k=0)  # reference pybind.cpp:92-94
    with pytest.raises(ValueError):
        KDTree(np.zeros((4, 2)))
    with pytest.raises(ValueError):
        # out-of-box points with periodic boxsize, reference pybind.cpp:42-46
        KDTree(points * 10.0, boxsize=1.0)


def test_k_larger_than_n():
    points = _random_points(5, 21)
    tree = KDTree(points)
    dist, idx = tree.query(points[:3], k=8)
    assert np.all(np.isfinite(dist[:, :5]))
    assert np.all(np.isinf(dist[:, 5:]))
    assert np.all(idx[:, 5:] == 5)


def test_properties():
    points = _random_points(300, 33, box=2.0)
    tree = KDTree(points, boxsize=2.0)
    assert tree.n == 300
    assert tree.size == 300
    assert tree.periodic
    assert tree.boxsize == 2.0
    tree2 = KDTree(points)
    assert not tree2.periodic
    assert tree2.boxsize is None


def test_query_statistics():
    points = _random_points(5000, 55)
    tree = KDTree(points)
    dist, idx, stats = tree.query_with_statistics(points[:50], k=4)
    assert stats.cells_scanned.shape == (50,)
    assert np.all(stats.points_visited >= 4)
    # visiting a small fraction of all points is the entire point of the index
    assert np.mean(stats.points_visited) < 0.5 * tree.n
    # ... and the complement was PRUNED by the convergence bound (reference
    # nodes_pruned analog): pruned + scanned covers the whole grid for
    # bound-converged queries, and most cells are pruned, not scanned
    assert stats.cells_pruned.shape == (50,)
    ncells = tree._tree.ncells
    assert np.all(stats.cells_pruned + stats.cells_scanned >= 0.9 * ncells)
    assert np.mean(stats.cells_pruned) > 0.5 * ncells


def test_ball_count_matches_scipy():
    points = _random_points(2000, 77)
    queries = _random_points(64, 78)
    tree = KDTree(points)
    counts = tree.query_radius_count(queries, 0.1)
    ref = scipy.spatial.KDTree(points)
    expected = np.array([len(x) for x in ref.query_ball_point(queries, 0.1)])
    np.testing.assert_array_equal(counts, expected)


def test_ball_count_periodic():
    box = 1.0
    points = _random_points(1500, 79, box=box)
    queries = _random_points(32, 80, box=box)
    tree = KDTree(points, boxsize=box)
    counts = tree.query_radius_count(queries, 0.15)
    ref = scipy.spatial.KDTree(points, boxsize=box)
    expected = np.array([len(x) for x in ref.query_ball_point(queries, 0.15)])
    np.testing.assert_array_equal(counts, expected)


def test_ball_count_cell_engine_vs_dense():
    """The cell-cube engine (small radii) must agree exactly with the dense
    O(N*Q) scan on the same tree — including per-query radii, clustered
    data, and queries outside the data extent."""
    from nbodyhpc_jax.ops import ball

    rng = np.random.Generator(np.random.Philox(81))
    # clustered: half uniform, half in a tight blob (stresses ccap sizing)
    a = rng.random((3000, 3)).astype(np.float32)
    b = (rng.random((1000, 3)) * 0.05 + 0.4).astype(np.float32)
    points = np.concatenate([a, b]).astype(np.float32)
    queries = np.concatenate(
        [rng.random((48, 3)), rng.random((8, 3)) * 0.1 + 0.38,
         rng.random((8, 3)) + 2.0]  # outside the extent
    ).astype(np.float32)
    radii = (rng.random(64) * 0.12 + 0.005).astype(np.float32)

    tree = KDTree(points)
    counts = tree.query_radius_count(queries, radii)

    # cross-check both engines regardless of what "auto" picked
    cells = ball.ball_count(tree._tree, tree._dev, queries, radii, engine="cells")
    dense = ball.ball_count(tree._tree, tree._dev, queries, radii, engine="dense")
    np.testing.assert_array_equal(cells, dense)
    np.testing.assert_array_equal(counts, dense)

    ref = scipy.spatial.KDTree(points)
    sp = np.array(
        [len(ref.query_ball_point(q, float(r))) for q, r in zip(queries, radii)]
    )
    np.testing.assert_array_equal(counts, sp)


def test_ball_count_periodic_cube_wrap():
    """Periodic radii large enough that the cell cube wraps the whole box in
    a dimension: wrapped duplicate cells must be counted exactly once."""
    box = 1.0
    points = _random_points(800, 82, box=box)
    queries = _random_points(24, 83, box=box)
    from nbodyhpc_jax.ops import ball

    tree = KDTree(points, boxsize=box)
    counts = ball.ball_count(tree._tree, tree._dev, queries, 0.4, engine="cells")
    ref = scipy.spatial.KDTree(points, boxsize=box)
    expected = np.array([len(x) for x in ref.query_ball_point(queries, 0.4)])
    np.testing.assert_array_equal(counts, expected)


def test_far_outside_queries_hit_fallback():
    """Queries far outside the data extent must stay exact (regression: the
    streaming fallback used to truncate the tail when the padded point count
    was not divisible by the scan block)."""
    rng = np.random.Generator(np.random.Philox(1234))
    pts = (rng.random((50000, 3)) * 3.0).astype(np.float32)  # npad=50048, 128-only divisor
    far = (rng.random((8, 3)) * 3.0 + 100.0).astype(np.float32)
    tree = KDTree(pts)
    d, i = tree.query(far, k=3)
    from nbodyhpc_jax.ops.knn import brute_force_knn

    bd, bi = brute_force_knn(pts, far, 3)
    np.testing.assert_array_equal(i, np.asarray(bi).astype(np.uint32))
    np.testing.assert_allclose(d, np.asarray(bd), rtol=1e-6)


def test_clustered_points_escalation():
    """Heavily clustered data must stay exact (escalation ladder / fallback)."""
    rng = np.random.Generator(np.random.Philox(5))
    cluster = rng.normal(scale=0.001, size=(3000, 3)).astype(np.float32) + 0.5
    sparse = rng.random(size=(50, 3)).astype(np.float32)
    points = np.concatenate([cluster, sparse]).astype(np.float32)
    points = np.clip(points, 0.0, 0.999999)
    queries = rng.random(size=(100, 3)).astype(np.float32)

    tree = KDTree(points)
    dist, idx = tree.query(queries, k=6)
    ref = scipy.spatial.KDTree(points)
    rdist, ridx = ref.query(queries, k=6)
    np.testing.assert_allclose(dist, rdist, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(idx, ridx.astype(np.uint32))


def test_device_build_matches_host_build():
    from nbodyhpc_jax.core.cells import build_cell_list

    pts = _random_points(5000, 91)
    th = build_cell_list(pts, device=False)
    td = build_cell_list(pts, device=True)
    assert td.dev is not None
    assert td.offsets is None  # device build defers the offsets D2H
    np.testing.assert_array_equal(td.offsets_host(), th.offsets)
    np.testing.assert_array_equal(np.asarray(td.xyz)[:3, : td.n], th.xyz[:3, : th.n])
    np.testing.assert_array_equal(np.asarray(td.index)[: td.n], th.index[: th.n])
    assert td.max_cell_count == th.max_cell_count

    # and queries agree end-to-end
    from nbodyhpc_jax.ops import knn

    q = _random_points(200, 92)
    rh = knn.cell_knn_query(th, tuple(map(np.asarray, (th.xyz, th.index, th.offsets))), q, 4)
    import jax.numpy as jnp

    rd = knn.cell_knn_query(td, td.dev, q, 4)
    np.testing.assert_array_equal(rh.indices, rd.indices)
    np.testing.assert_allclose(rh.distances, rd.distances, rtol=1e-6)


def test_device_resident_points_build():
    """KDTree accepts device-resident points (no host round trip): same
    tree and query results as the numpy build, box validation still
    raises, non-periodic extent deduced on device."""
    import jax.numpy as jnp

    from nbodyhpc_jax.kdtree import KDTree

    pts = _random_points(4000, 93)
    q = _random_points(150, 94)
    for boxsize in (None, 1.0):
        th = KDTree(pts, boxsize=boxsize)
        td = KDTree(jnp.asarray(pts), boxsize=boxsize)
        dh, ih = th.query(q, k=5)
        dd, idd = td.query(q, k=5)
        np.testing.assert_array_equal(ih, idd)
        np.testing.assert_allclose(dh, dd, rtol=1e-6)
    bad = pts.copy()
    bad[7, 1] = 1.5
    with np.testing.assert_raises(ValueError):
        KDTree(jnp.asarray(bad), boxsize=1.0)


def test_boundary_cell_convergence_small_dims():
    """Regression: with r+1 < C <= 2r+1 cells in a non-periodic dimension, a
    boundary-cell query's clipped cube misses the far cells; the old static
    'side >= C means fully scanned' shortcut certified a wrong neighbor as
    converged. The bound must be evaluated per query."""
    # 216 uniform-ish points -> dims (3, 3, 3); plant a decoy inside the
    # query's r=1 cube and the true nearest in the unscanned far cell
    rng = np.random.Generator(np.random.Philox(99))
    pts = (rng.random((216, 3)) * 0.98 + 0.01).astype(np.float32)
    pts[214] = (0.70, 0.50, 0.50)   # true nearest (far x-cell)
    pts[215] = (0.30, 0.95, 0.50)   # decoy inside the cube
    q = np.array([[0.30, 0.50, 0.50]], np.float32)
    tree = KDTree(pts)
    d, i = tree.query(q, k=1)
    from scipy.spatial import KDTree as SKD

    dref, iref = SKD(pts.astype(np.float64)).query(q, k=1)
    np.testing.assert_allclose(d[:, 0], dref, rtol=1e-6)
    np.testing.assert_array_equal(i[:, 0], iref)


def test_kernel_path_tiny_periodic_dims_no_duplicates():
    """Regression: periodic trees with < 3 cells in x/y alias wrapped
    neighbor columns; the ladder must answer them exactly, with no
    neighbor twice."""
    rng = np.random.Generator(np.random.Philox(7))
    pts = rng.random((64, 3), dtype=np.float32)  # dims ~ (2, 2, 2)
    tree = KDTree(pts, boxsize=1.0)
    q = pts[:8]
    res = _knn.cell_knn_query(tree._tree, tree._dev, q, 4)
    from scipy.spatial import KDTree as SKD

    dref, iref = SKD(pts.astype(np.float64), boxsize=1.0).query(q, k=4)
    np.testing.assert_allclose(res.distances, dref, rtol=1e-5, atol=1e-6)
    # no duplicate neighbors within a row
    for row in res.indices:
        assert len(set(row.tolist())) == len(row)


def test_large_ladder_budget_end_of_array_cells():
    """Regression: a user ladder rung with budget beyond the array padding
    clamped its slice start and evaluated the wrong points for cells at the
    end of the sorted array."""
    rng = np.random.Generator(np.random.Philox(5))
    pts = rng.random((3000, 3), dtype=np.float32)
    tree = KDTree(pts)
    q = pts[:64]
    res = _knn.cell_knn_query(
        tree._tree, tree._dev, q, 4, ladder=((1, 4096), (4, 4096)),
    )
    dref, iref = tree.query(q, k=4)
    np.testing.assert_allclose(res.distances, dref, rtol=1e-6)
    np.testing.assert_array_equal(res.indices, iref)


def test_metrics_zero_box_degrades_to_plain_l2():
    """The min-image wrap with a non-positive box length must degrade to the
    plain metric (reference L2PeriodicDistance's min-selection does at L=0)
    instead of producing NaN from a division by zero."""
    import jax.numpy as jnp

    from nbodyhpc_jax.ops import metrics

    a = jnp.asarray([[0.9, 0.2, 0.7]], jnp.float32)
    b = jnp.asarray([[0.1, 0.9, 0.1]], jnp.float32)
    d_mixed = metrics.squared_l2_periodic(a, b, (1.0, 1.0, 0.0))
    dx = 0.8 - 1.0  # wrapped
    dy = -0.7 + 1.0
    dz = 0.6        # unwrapped (disabled dimension)
    expect = np.float32(dx) ** 2 + np.float32(dy) ** 2 + np.float32(dz) ** 2
    assert np.isfinite(float(d_mixed[0]))
    np.testing.assert_allclose(float(d_mixed[0]), expect, rtol=1e-6)
