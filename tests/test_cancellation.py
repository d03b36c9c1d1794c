"""Cooperative-cancellation contract: Ctrl-C aborts long host-chunked loops.

The reference polls ``PyErr_CheckSignals`` every 1000 queries inside the GIL-
released query fan-out (reference: kdtree/src/cpp/pybind.cpp:127-134) and in
20 ms fence-wait slices during rendering (rasterization/src/cpp/
point_renderer.cpp:797-818). This design's analog is its host-chunked
loops: every chunk boundary performs a blocking device sync at which Python
delivers pending signals. This test pins that contract by
actually sending SIGINT to a subprocess mid-query and asserting a prompt,
clean KeyboardInterrupt — not a hang, not a crash."""
import os
import signal
import subprocess
import sys
import time

CHILD = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
from nbodyhpc_jax.kdtree import KDTree
from nbodyhpc_jax.ops.knn import cell_knn_query

rng = np.random.Generator(np.random.Philox(5))
pts = rng.random((50000, 3)).astype(np.float32)
t = KDTree(pts)
q = rng.random((300000, 3)).astype(np.float32)
# warm the compile cache with one chunk-shaped call so the long query below
# spends its time in the chunk loop (whose boundaries are the cancellation
# points), not in XLA compilation
cell_knn_query(t._tree, t._dev, q[:2048], 8, chunk=2048)
print("WARM", flush=True)
try:
    res = cell_knn_query(t._tree, t._dev, q, 8, chunk=2048)
    print("DONE", flush=True)
    sys.exit(1)
except KeyboardInterrupt:
    print("INTERRUPTED", flush=True)
    sys.exit(42)
"""


RENDER_CHILD = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
from nbodyhpc_jax.rasterizer import render_points_volume

rng = np.random.Generator(np.random.Philox(9))
n = 2_000_000
pos = rng.random((n, 3)).astype(np.float32)
w = np.ones(n, np.float32)
r = (rng.random(n) * 0.04 + 0.01).astype(np.float32)
# warm the per-chunk program with a short render of the same chunk shape,
# grid and radius class, so the long render below spends its time in the
# chunked dispatch loop (whose boundaries are the cancellation points)
render_points_volume(pos[:256], w[:256], r[:256], 32.0, 32)
print("WARM", flush=True)
try:
    render_points_volume(pos, w, r, 32.0, 32)
    print("DONE", flush=True)
    sys.exit(1)
except KeyboardInterrupt:
    print("INTERRUPTED", flush=True)
    sys.exit(42)
"""


def _run_sigint_child(child_src):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"  # the child never opens a card
    p = subprocess.Popen(
        [sys.executable, "-c", child_src],
        stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL,
        text=True,
        env=env,
    )
    try:
        line = ""
        while "WARM" not in line:
            line = p.stdout.readline()
            assert line, "child exited before warm-up finished"
            assert "DONE" not in line
        time.sleep(0.5)  # land inside the chunk loop
        p.send_signal(signal.SIGINT)
        t0 = time.time()
        out, _ = p.communicate(timeout=120)
        latency = time.time() - t0
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()
    assert "INTERRUPTED" in out, out
    assert p.returncode == 42
    # abort must come at the next chunk boundary, not after the whole batch
    assert latency < 60.0, latency


def test_sigint_aborts_chunked_query():
    _run_sigint_child(CHILD)


def test_sigint_aborts_chunked_render():
    """A multi-batch volume render dies within one chunk of the SIGINT —
    the render-path half of the reference's cooperative cancellation
    (point_renderer.cpp:797-818 fence polling + pybind.cpp:15-23)."""
    _run_sigint_child(RENDER_CHILD)
