"""Rasterizer validation/demo CLI, mirroring the reference ``rasterizer_main``.

Reference behavior (rasterization/src/cpp/main.cpp:53-159): render a single
analytic sphere and check mass conservation (total deposited weight ~= 1),
the lit-voxel fraction, and the central voxel value, dumping a PNG slice —
or render a packed ``Vertex{pos[3], weight, radius}`` binary file and report
the rendered/input mass ratio.

Usage: ``python -m nbodyhpc_jax.cli.rasterizer_demo [--file F] [--grid 256]``
"""
from __future__ import annotations

import argparse
import math
import sys
import time

import numpy as np


def render_single_sphere(grid: int, subsample: int, png: str | None):
    from ..rasterizer import render_points_volume

    ppu = float(grid)
    pos = np.array([[0.5, 0.5, 0.5]], np.float32)
    w = np.array([1.0], np.float32)
    radius = 0.25
    r = np.array([radius], np.float32)

    t0 = time.perf_counter()
    vol = render_points_volume(pos, w, r, ppu, grid, subsample_factor=subsample)
    dt = time.perf_counter() - t0

    total = float(vol.sum())
    center = float(vol[grid // 2, grid // 2, grid // 2])
    density = 1.0 / (4.0 / 3.0 * math.pi * radius**3) / ppu**3
    lit = int(np.count_nonzero(vol))
    sphere_vox = 4.0 / 3.0 * math.pi * (radius * ppu) ** 3
    print(f"render: {dt:.3f} s  grid {grid}^3  subsample {subsample}")
    print(f"total weight: {total:.6f} (expect ~1)")
    print(f"center voxel: {center:.3e} (uniform density {density:.3e})")
    print(f"lit voxels: {lit} (sphere volume {sphere_vox:.0f})")
    ok = abs(total - 1.0) < 0.05
    if png:
        from ..utils.png import write_png_grayscale

        write_png_grayscale(png, np.log1p(vol[:, :, grid // 2]))
        print(f"wrote {png}")
    return ok


def render_points_from_file(path: str, grid, ppu: float, subsample: int,
                            periodic: bool, png: str | None,
                            stream_rows: int = 0):
    from ..rasterizer import render_points_volume

    if stream_rows:
        # bounded-memory path: the native double-buffered loader prefetches
        # the next batch while the engine renders the current one, and the
        # density accumulates across batches (deposition is linear). Files
        # larger than RAM render fine; periodic wrap still needs whole-file
        # ghosting, so it uses the bulk path.
        from ..runtime import stream_particles

        if periodic:
            raise SystemExit("--stream does not support --periodic "
                             "(ghost augmentation needs the full set)")
        vol = None
        n = 0
        wsum = 0.0
        t0 = time.perf_counter()
        for pos, w, r in stream_particles(path, batch_rows=stream_rows):
            part = render_points_volume(pos, w, r, ppu, grid,
                                        subsample_factor=subsample)
            vol = part if vol is None else vol + part
            n += len(w)
            wsum += float(w.sum())
        dt = time.perf_counter() - t0
        if vol is None:
            raise SystemExit(f"{path} contains no particles")
        print(f"streamed {n} particles from {path} "
              f"(batches of {stream_rows})")
        ratio = float(vol.sum()) / wsum
        print(f"render: {dt:.3f} s ({n/dt/1e6:.2f} Mparticles/s)")
        print(f"mass conservation rendered/input: {ratio:.6f}")
        if png:
            from ..utils.png import write_png_grayscale

            g = vol.shape[2] // 2
            write_png_grayscale(png, np.log1p(vol[:, :, g]))
            print(f"wrote {png}")
        return abs(ratio - 1.0) < 0.1

    raw = np.fromfile(path, dtype=np.float32).reshape(-1, 5)
    pos, w, r = raw[:, :3].copy(), raw[:, 3].copy(), raw[:, 4].copy()
    print(f"loaded {len(pos)} particles from {path}")
    t0 = time.perf_counter()
    vol = render_points_volume(pos, w, r, ppu, grid, periodic=periodic,
                               subsample_factor=subsample)
    dt = time.perf_counter() - t0
    ratio = float(vol.sum()) / float(w.sum())
    print(f"render: {dt:.3f} s ({len(pos)/dt/1e6:.2f} Mparticles/s)")
    print(f"mass conservation rendered/input: {ratio:.6f}")
    if png:
        from ..utils.png import write_png_grayscale

        g = vol.shape[2] // 2
        write_png_grayscale(png, np.log1p(vol[:, :, g]))
        print(f"wrote {png}")
    return abs(ratio - 1.0) < 0.1


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--file", type=str, default=None,
                    help="packed float32 (x,y,z,weight,radius) records")
    ap.add_argument("--grid", type=int, default=128)
    ap.add_argument("--pixels-per-unit", type=float, default=None)
    ap.add_argument("--subsample", type=int, default=4)
    ap.add_argument("--periodic", action="store_true")
    ap.add_argument("--png", type=str, default=None)
    ap.add_argument("--stream", type=int, default=0, metavar="ROWS",
                    help="render --file in prefetched batches of ROWS "
                         "records (bounded memory; non-periodic only)")
    args = ap.parse_args(argv)

    ppu = args.pixels_per_unit if args.pixels_per_unit else float(args.grid)
    if args.file:
        ok = render_points_from_file(args.file, args.grid, ppu, args.subsample,
                                     args.periodic, args.png, args.stream)
    else:
        ok = render_single_sphere(args.grid, args.subsample, args.png)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
