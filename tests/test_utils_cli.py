"""Tests for utilities (PNG writer, stats, philox) and the CLI entry points
(the reference's kdtree_main / rasterizer_main analogs)."""
import os
import struct
import zlib

import numpy as np
import pytest


def test_png_writer_roundtrip(tmp_path):
    from nbodyhpc_jax.utils.png import write_png_grayscale

    img = np.outer(np.arange(16), np.arange(8)).astype(np.float32)
    path = tmp_path / "t.png"
    write_png_grayscale(str(path), img)
    data = path.read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    w, h = struct.unpack(">II", data[16:24])
    assert (w, h) == (8, 16)
    # decode IDAT and check the max pixel
    idat_off = data.index(b"IDAT") + 4
    ln = struct.unpack(">I", data[idat_off - 8 : idat_off - 4])[0]
    raw = zlib.decompress(data[idat_off : idat_off + ln])
    rows = np.frombuffer(raw, np.uint8).reshape(16, 9)[:, 1:]
    assert rows[-1, -1] == 255 and rows[0, 0] == 0


def test_philox_determinism():
    from nbodyhpc_jax.utils.philox import random_particles, random_points

    a = random_points(100, seed=7)
    b = random_points(100, seed=7)
    np.testing.assert_array_equal(a, b)
    p1, w1, r1 = random_particles(50, seed=3)
    p2, w2, r2 = random_particles(50, seed=3)
    np.testing.assert_array_equal(r1, r2)


def test_knn_cdf_uniform():
    from nbodyhpc_jax.utils.stats import knn_cdf

    rng = np.random.Generator(np.random.Philox(1))
    pts = rng.random((5000, 3)).astype(np.float32)
    radii, cdf = knn_cdf(pts, k=(1, 4), n_queries=2000, boxsize=1.0, seed=2)
    assert cdf.shape == (2, radii.size)
    # CDFs are monotone, in [0, 1], and k=1 dominates k=4
    assert np.all(np.diff(cdf, axis=1) >= 0)
    assert np.all((cdf >= 0) & (cdf <= 1))
    assert np.all(cdf[0] >= cdf[1])
    # analytic check: P(d_1 <= r) = 1 - exp(-n 4/3 pi r^3) for a Poisson field
    n = 5000
    expect = 1.0 - np.exp(-n * 4.0 / 3.0 * np.pi * radii**3)
    mid = (cdf[0] > 0.2) & (cdf[0] < 0.8)
    assert np.allclose(cdf[0][mid], expect[mid], atol=0.05)


def test_kdtree_bench_cli(capsys):
    from nbodyhpc_jax.cli.kdtree_bench import main

    rc = main(["--num-points", "2000", "--num-queries", "500", "-k", "4"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "self-query exact: True" in out
    assert "% points visited" in out


def test_rasterizer_demo_cli(tmp_path, capsys):
    from nbodyhpc_jax.cli.rasterizer_demo import main

    png = str(tmp_path / "slice.png")
    rc = main(["--grid", "32", "--png", png])
    out = capsys.readouterr().out
    assert rc == 0
    assert "total weight" in out
    assert os.path.exists(png)


def test_rasterizer_demo_cli_file(tmp_path, capsys):
    from nbodyhpc_jax.cli.rasterizer_demo import main

    rng = np.random.Generator(np.random.Philox(9))
    n = 200
    rec = np.zeros((n, 5), np.float32)
    rec[:, :3] = rng.random((n, 3)) * 0.8 + 0.1
    rec[:, 3] = 1.0
    rec[:, 4] = 0.02
    f = tmp_path / "parts.bin"
    rec.tofile(f)
    rc = main(["--file", str(f), "--grid", "32", "--pixels-per-unit", "32"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "mass conservation" in out
