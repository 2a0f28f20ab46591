"""Fused NaN-sentinel panel kernels (ops/panel_pallas.py) in Pallas interpret
mode on the CPU: each kernel against direct NumPy, over ragged shapes that
leave partial tiles on both axes and both storage dtypes, plus the v-sweep
grid choice."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cuda_recommender_tpu.ops.panel_pallas import (
    TARGET_PROGRAMS, _round_to_storage, panel_update_vsweep, panel_usweep,
    panel_vsweep, vsweep_chunks)

# (M, W, bm, bw): exact tiles, ragged rows and columns, one tile, and a
# ragged panel with several row chunks per column block
SHAPES = [(48, 64, 16, 32), (50, 70, 16, 32), (16, 128, 16, 128),
          (333, 97, 32, 64)]


def _panel(M, W, seed):
    """NaN-sentinel panel (30% observed) and dyadic factor vectors. Dyadic
    values make every product and the delta exact in f32, so the updated
    residual has ONE correct value whether or not the backend contracts
    the delta into an FMA — the check can then demand bit-equality."""
    rng = np.random.default_rng(seed)
    mask = rng.random((M, W)) < 0.3
    Rd = np.where(mask, rng.normal(size=(M, W)).astype(np.float32), np.nan)
    uo, up, vo, vp = (rng.integers(-64, 65, size=s).astype(np.float32) / 64
                      for s in (M, M, W, W))
    return mask, Rd, uo, up, vo, vp


@pytest.mark.parametrize("kernel", ["update_vsweep", "vsweep", "usweep"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,W,bm,bw", SHAPES)
def test_panel_kernel_matches_numpy(kernel, dtype, M, W, bm, bw):
    mask, Rd, uo, up, vo, vp = _panel(M, W, seed=M * W)
    Rdj = jnp.asarray(Rd, dtype)
    Rm = np.where(mask, np.asarray(Rdj.astype(jnp.float32)), 0.0)
    mf = mask.astype(np.float32)
    if kernel == "update_vsweep":
        want = Rdj.astype(jnp.float32) + jnp.asarray(
            np.outer(uo, vo) - np.outer(up, vp))
        if dtype == "bfloat16":
            want = jax.lax.reduce_precision(want, 8, 7)
        Rn, g, h = panel_update_vsweep(
            Rdj, jnp.asarray(uo), jnp.asarray(up), jnp.asarray(vo),
            jnp.asarray(vp), bm=bm, bw=bw)
        Rn32 = np.asarray(Rn.astype(jnp.float32))
        assert Rn.dtype == Rdj.dtype
        assert np.isnan(Rn32[~mask]).all()              # sentinel preserved
        # the stored value is f32(R) + delta rounded ONCE to storage
        np.testing.assert_array_equal(Rn32[mask], np.asarray(want)[mask])
        Rm = np.where(mask, Rn32, 0.0)
        got, ref = (g, h), (uo @ Rm, (uo * uo) @ mf)
    elif kernel == "vsweep":
        got = panel_vsweep(Rdj, jnp.asarray(uo), bm=bm, bw=bw)
        ref = (uo @ Rm, (uo * uo) @ mf)
    else:
        got = panel_usweep(Rdj, jnp.asarray(vo), bm=bm, bw=bw)
        ref = (Rm @ vo, mf @ (vo * vo))
    for a, b in zip(got, ref):
        assert a.shape == b.shape
        np.testing.assert_allclose(np.asarray(a), b, rtol=2e-5, atol=2e-4)


@pytest.mark.parametrize("M,W", [(1, 1), (50, 70), (300_001, 17_770),
                                 (300_001, 2048), (4096, 17_770)])
def test_vsweep_grid_covers_rows(M, W):
    """The (column blocks × row chunks) grid covers every row exactly once
    with at most one partial chunk, and reaches the program target when
    there are enough rows."""
    steps, n_chunks = vsweep_chunks(M, W)
    row_blocks = -(-M // 32)
    assert (n_chunks - 1) * steps < row_blocks <= n_chunks * steps
    programs = n_chunks * -(-W // 128)
    assert programs >= min(TARGET_PROGRAMS, row_blocks * -(-W // 128))


@pytest.mark.parametrize("bits", [0x7FC00000, 0x7FFFFFFF, 0xFFC00000,
                                  0xFFFFFFFF])
def test_round_to_storage_keeps_nan(bits):
    """Every NaN encoding stays NaN through the bf16 rounding, including
    the all-ones mantissa a GPU produces for NaN arithmetic (the bias add
    would carry it into the sign bit)."""
    x = jax.lax.bitcast_convert_type(jnp.uint32(bits), jnp.float32)
    assert bool(jnp.isnan(_round_to_storage(x, jnp.bfloat16)))


def test_round_to_storage_is_round_to_nearest_even():
    """Finite values round exactly like a single f32 -> bf16 conversion."""
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.normal(size=4096).astype(np.float32)
                    * np.float32(2.0) ** rng.integers(-20, 20, size=4096))
    got = np.asarray(_round_to_storage(x, jnp.bfloat16))
    want = np.asarray(x.astype(jnp.bfloat16).astype(jnp.float32))
    np.testing.assert_array_equal(got, want)
