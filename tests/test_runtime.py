"""Host-runtime tests: native _hostio extension (when built) and fallbacks."""
import numpy as np

from nbodyhpc_jax import runtime


def test_generate_uniform_deterministic():
    a = runtime.generate_uniform(1000, seed=5)
    b = runtime.generate_uniform(1000, seed=5)
    np.testing.assert_array_equal(a, b)
    c = runtime.generate_uniform(1000, seed=6)
    assert not np.array_equal(a, c)
    assert a.dtype == np.float32 and a.shape == (1000, 3)
    assert a.min() >= 0.0 and a.max() < 1.0


def test_particle_io_roundtrip(tmp_path):
    rng = np.random.Generator(np.random.Philox(3))
    pos = rng.random((100, 3)).astype(np.float32)
    w = rng.random(100).astype(np.float32)
    r = rng.random(100).astype(np.float32)
    path = str(tmp_path / "p.bin")
    runtime.save_particles(path, pos, w, r)
    p2, w2, r2 = runtime.load_particles(path)
    np.testing.assert_array_equal(pos, p2)
    np.testing.assert_array_equal(w, w2)
    np.testing.assert_array_equal(r, r2)


def test_load_points(tmp_path):
    pts = np.arange(30, dtype=np.float32).reshape(10, 3)
    path = str(tmp_path / "pts.bin")
    pts.tofile(path)
    got = runtime.load_points(path)
    np.testing.assert_array_equal(got, pts)


def test_native_matches_numpy_fallback_format():
    """Native and fallback must agree on dtype/shape/range semantics (values
    differ: different Philox keying), so downstream code is agnostic."""
    a = runtime.generate_uniform(64, seed=1, boxsize=2.0)
    assert a.shape == (64, 3) and a.dtype == np.float32
    assert a.min() >= 0.0 and a.max() < 2.0


def test_field_save_load_roundtrip(tmp_path):
    rng = np.random.Generator(np.random.Philox(8))
    field = rng.random((8, 12, 16)).astype(np.float32)
    path = str(tmp_path / "field.bin")
    runtime.save_field(path, field)
    got = runtime.load_field(path)
    np.testing.assert_array_equal(got, field)


def test_profiling_timer():
    from nbodyhpc_jax.utils.profiling import timer

    out = []
    with timer("x", sink=out.append) as box:
        pass
    assert "seconds" in box and out and out[0].startswith("x:")


def test_stream_particles_matches_bulk_load(tmp_path):
    """The double-buffered streaming loader must reproduce the bulk read,
    including ragged final batches and multiple concurrent streams."""
    from nbodyhpc_jax import runtime

    rng = np.random.Generator(np.random.Philox(23))
    n = 10_000
    pos = rng.random((n, 3)).astype(np.float32)
    w = rng.random(n).astype(np.float32)
    r = rng.random(n).astype(np.float32)
    path = str(tmp_path / "parts.bin")
    runtime.save_particles(path, pos, w, r)

    for batch in (n, 4096, 1000, 3):  # exact, pow2, ragged tail, tiny
        chunks = list(runtime.stream_particles(path, batch_rows=batch))
        got_p = np.concatenate([c[0] for c in chunks])
        got_w = np.concatenate([c[1] for c in chunks])
        got_r = np.concatenate([c[2] for c in chunks])
        np.testing.assert_array_equal(got_p, pos)
        np.testing.assert_array_equal(got_w, w)
        np.testing.assert_array_equal(got_r, r)

    # two interleaved streams must not interfere (per-loader prefetch state)
    s1 = runtime.stream_particles(path, batch_rows=2048)
    s2 = runtime.stream_particles(path, batch_rows=1500)
    a1 = [next(s1)[1], next(s2)[1], next(s1)[1], next(s2)[1]]
    assert a1[0].shape == (2048,) and a1[1].shape == (1500,)
    np.testing.assert_array_equal(a1[2], w[2048:4096])
    np.testing.assert_array_equal(a1[3], w[1500:3000])
    s1.close()
    s2.close()
