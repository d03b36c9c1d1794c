"""Fused deposit kernel (ops/deposit_kernel.py).

On the CPU the kernel runs in the Pallas interpreter, which neither masks
atomics nor sums an index repeated within one atomic call. The kernel is
built so that no call repeats an index (one particle's window block per
call, masked lanes sent to private slots past the volume), so the
interpreted sums equal the card's. Its lowering to the card's Triton
custom call is checked here too; the compiled kernel itself runs only on
the card (tests marked ``gpu``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from test_deposit import class_particles
from test_splat_dense import _quantum_atol

from nbodyhpc_jax.ops import deposit, deposit_kernel
from nbodyhpc_jax.ops.splat import splat_volume_oracle
from nbodyhpc_jax.utils.workloads import field_parity, subcell_quantum


@pytest.mark.parametrize("cls", range(deposit.DENSE + 1))
def test_kernel_interpret_matches_oracle_per_class(cls):
    grid, ppu = (20, 16, 24), 16.0
    pos, w, r = class_particles(cls, 12, 300 + cls, grid, ppu)
    want = splat_volume_oracle(pos, w, r, ppu, grid)
    got = np.asarray(
        deposit.splat_volume(pos, w, r, ppu, grid, engine="kernel",
                             interpret=True)
    )
    np.testing.assert_allclose(
        got, want, rtol=1e-6, atol=1e-7 + _quantum_atol(w, r * ppu)
    )


def test_kernel_interpret_overlapping_windows_sum():
    """Many particles on one voxel (every window overlaps every other):
    the per-program atomics must sum across programs, and masked lanes
    must not leak into the volume."""
    grid, ppu = (8, 8, 8), 8.0
    n = 40
    pos = np.full((n, 3), 0.5, np.float32) + np.linspace(
        -0.05, 0.05, n, dtype=np.float32)[:, None]
    w = np.ones(n, np.float32)
    r = np.linspace(0.02, 0.3, n).astype(np.float32)
    want = splat_volume_oracle(pos, w, r, ppu, grid)
    got = np.asarray(
        deposit.splat_volume(pos, w, r, ppu, grid, engine="kernel",
                             interpret=True, batch=128)
    )
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_dense_class_route():
    """The kernel takes the dense class while its window fits the grid's
    second axis (<= 65535 blocks); the plain engine and larger radii take
    the dense pass."""
    assert deposit.class_route(deposit.DENSE, "kernel", 15.2) == ("kernel", 20)
    assert deposit.class_route(deposit.DENSE, "kernel", 24.9) == ("kernel", 28)
    assert deposit.class_route(deposit.DENSE, "kernel", 160.0) == ("kernel", 160)
    assert deposit.class_route(deposit.DENSE, "kernel", 161.0)[0] == "dense"
    assert deposit.class_route(deposit.DENSE, "plain", 24.9)[0] == "dense"
    assert deposit.class_route(3, "kernel") == ("kernel", deposit.CLASS_HALF[3])
    for half in deposit.KERNEL_DENSE_HALF:
        nblk = -(-((2 * half + 1) ** 3) // deposit_kernel.window_block(half))
        assert nblk <= 65535


def test_window_block_sizes():
    for half in deposit.CLASS_HALF:
        blk = deposit_kernel.window_block(half)
        assert blk & (blk - 1) == 0 and 32 <= blk <= deposit_kernel.BLOCK
        assert blk >= min((2 * half + 1) ** 3, deposit_kernel.BLOCK)


@pytest.mark.parametrize("cls", range(deposit.DENSE + 1))
def test_kernel_lowers_for_the_card(cls):
    """Each class's kernel (the dense class at the CAMELS set's 24.9 px
    largest radius) lowers to the GPU's Triton custom call at the CAMELS
    width (1024^3 volume, 2^20-row batches) — shapes only, nothing is
    allocated."""
    S = jax.ShapeDtypeStruct
    cols = [S((1 << 24,), jnp.float32)] * 5
    route, half = deposit.class_route(cls, "kernel", 24.9)
    lowered = deposit._deposit_jit.trace(
        S((1 << 30,), jnp.float32), cols, 0, 1, route=route, halfwidth=half,
        cap=1 << 20, grid=(1024, 1024, 1024), subsample=4,
    ).lower(lowering_platforms=("cuda",))
    text = lowered.as_text()
    assert "xla.gpu.triton" in text and "splat_deposit" in text


# --- on the card -----------------------------------------------------------


def _mixed(n, grid, ppu, seed):
    rng = np.random.Generator(np.random.Philox(seed))
    box = np.array([g / ppu for g in grid], np.float32)
    pos = (rng.random((n, 3)) * box).astype(np.float32)
    w = (rng.random(n) + 0.5).astype(np.float32)
    rpx = np.exp(rng.normal(0.0, 0.6, n)) * 4.0
    rpx[:8] = np.linspace(0.1, 24.0, 8)
    return pos, w, (rpx / ppu).astype(np.float32)


@pytest.mark.gpu
def test_kernel_matches_plain_on_card(gpu):
    """Separately compiled programs may flip knife-edge subcells (fused
    multiply-adds placed differently), so the gate is field_parity's:
    round-off everywhere but rare one-quantum flips."""
    grid, ppu = (128, 128, 128), 128.0
    pos, w, r = _mixed(200_000, grid, ppu, 7)
    ker = deposit.splat_volume(pos, w, r, ppu, grid, engine="kernel")
    pln = deposit.splat_volume(pos, w, r, ppu, grid, engine="plain")
    p = field_parity(ker, pln, subcell_quantum(w, r * ppu))
    assert p["ok"], p
    np.testing.assert_allclose(float(ker.sum()), float(pln.sum()), rtol=1e-5)


@pytest.mark.gpu
def test_kernel_matches_oracle_on_card(gpu):
    grid, ppu = (48, 40, 56), 48.0
    pos, w, r = _mixed(400, grid, ppu, 9)
    want = splat_volume_oracle(pos, w, r, ppu, grid)
    got = deposit.splat_volume(pos, w, r, ppu, grid, engine="kernel")
    p = field_parity(got, want, subcell_quantum(w, r * ppu))
    assert p["ok"], p
