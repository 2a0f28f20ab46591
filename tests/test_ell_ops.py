"""Unit tests for the fused single-consumer ELL ops (ops/ell_ops.py).

The fused ops exist because a chunked gather tile fed to more than one
consumer op makes XLA re-run the whole gather per consumer. They
must be numerically interchangeable with the unfused composition they
replace — same UpdateRating / RankOneUpdate math
(/root/reference/src/CCD.cpp:6-43), one pass."""

import jax.numpy as jnp
import numpy as np
import pytest

from cuda_recommender_tpu.data.ell import build_ell_pair
from cuda_recommender_tpu.ops.ell_ops import (
    extend_zero, fused_sweep, fused_update_sweep, paired_gather,
    residual_update, stacked_remap, sweep_partials)


@pytest.fixture(scope="module")
def ell(small_data):
    R, _ = small_data
    return R, build_ell_pair(R, min_width=4, index_space="entity")


def _tiles(side):
    return (tuple(jnp.asarray(b.idx) for b in side.buckets),
            tuple(jnp.asarray(b.val) for b in side.buckets))


def test_stacked_remap_matches_single_gathers(ell):
    R, pair = ell
    rng = np.random.default_rng(0)
    a = jnp.asarray(rng.standard_normal(R.rows), jnp.float32)
    b = jnp.asarray(rng.standard_normal(R.rows), jnp.float32)
    # sentinel index R.rows must read the appended zero row
    idx = jnp.asarray(
        np.r_[rng.integers(0, R.rows, 777), [R.rows, R.rows]], jnp.int32)
    ga, gb = stacked_remap((a, b), idx)
    a_ext = np.r_[np.asarray(a), 0.0]
    b_ext = np.r_[np.asarray(b), 0.0]
    np.testing.assert_array_equal(np.asarray(ga), a_ext[np.asarray(idx)])
    np.testing.assert_array_equal(np.asarray(gb), b_ext[np.asarray(idx)])


def test_fused_sweep_matches_sweep_partials(ell):
    R, pair = ell
    cols = pair.cols_side
    idx_c, vals_c = _tiles(cols)
    rng = np.random.default_rng(1)
    u = jnp.asarray(rng.standard_normal(R.rows), jnp.float32)
    tab = extend_zero(jnp.stack([u, u], -1))
    pc = paired_gather(tab, idx_c)
    g_ref, h_ref, _ = sweep_partials(idx_c, vals_c, cols, None,
                                     gathered=[p[0] for p in pc])
    g, h = fused_sweep(idx_c, vals_c, cols, tab, sweep_col=0)
    # f32 reduction-order noise only (XLA may reassociate per program)
    np.testing.assert_allclose(np.asarray(g), np.asarray(g_ref),
                               rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(np.asarray(h), np.asarray(h_ref),
                               rtol=1e-5, atol=1e-3)


def test_fused_update_sweep_matches_unfused_composition(ell):
    """fused_update_sweep == residual_update(sign0) -> residual_update(sign1)
    -> sweep_partials on the UPDATED values, with update j consuming table
    column j and the sweep consuming ``sweep_col``."""
    R, pair = ell
    cols = pair.cols_side
    idx_c, vals_c = _tiles(cols)
    rng = np.random.default_rng(2)
    u_pend = jnp.asarray(rng.standard_normal(R.rows), jnp.float32)
    u_old = jnp.asarray(rng.standard_normal(R.rows), jnp.float32)
    own_p = jnp.asarray(rng.standard_normal(cols.n_slots), jnp.float32)
    own_o = jnp.asarray(rng.standard_normal(cols.n_slots), jnp.float32)

    tab = extend_zero(jnp.stack([u_pend, u_old], -1))
    pc = paired_gather(tab, idx_c)
    v_ref = residual_update(idx_c, vals_c, cols, None, own_p, -1.0,
                            gathered=[p[0] for p in pc])
    v_ref = residual_update(idx_c, v_ref, cols, None, own_o, +1.0,
                            gathered=[p[1] for p in pc])
    g_ref, h_ref, _ = sweep_partials(idx_c, v_ref, cols, None,
                                     gathered=[p[1] for p in pc])

    new_vals, g, h = fused_update_sweep(
        idx_c, vals_c, cols, tab, owns=(own_p, own_o), signs=(-1.0, 1.0),
        sweep_col=1)
    for nv, rv in zip(new_vals, v_ref):
        np.testing.assert_allclose(np.asarray(nv), np.asarray(rv),
                                   rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(np.asarray(g), np.asarray(g_ref),
                               rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(np.asarray(h), np.asarray(h_ref), rtol=1e-5, atol=1e-3)


def test_fused_update_sweep_three_wide_table(ell):
    """The rows-side rank pass gathers a 3-wide [v_pend, v_old, v_new] table:
    updates consume columns 0/1, the sweep column 2."""
    R, pair = ell
    rows = pair.rows_side
    idx_r, vals_r = _tiles(rows)
    rng = np.random.default_rng(3)
    v_pend = jnp.asarray(rng.standard_normal(R.cols), jnp.float32)
    v_old = jnp.asarray(rng.standard_normal(R.cols), jnp.float32)
    v_new = jnp.asarray(rng.standard_normal(R.cols), jnp.float32)
    own_p = jnp.asarray(rng.standard_normal(rows.n_slots), jnp.float32)
    own_o = jnp.asarray(rng.standard_normal(rows.n_slots), jnp.float32)

    tab3 = extend_zero(jnp.stack([v_pend, v_old, v_new], -1))
    new_vals, g, h = fused_update_sweep(
        idx_r, vals_r, rows, tab3, owns=(own_p, own_o), signs=(-1.0, 1.0),
        sweep_col=2)

    # reference composition via the unfused ops
    pp = paired_gather(extend_zero(jnp.stack([v_pend, v_old], -1)), idx_r)
    pn = paired_gather(extend_zero(jnp.stack([v_new, v_new], -1)), idx_r)
    v_ref = residual_update(idx_r, vals_r, rows, None, own_p, -1.0,
                            gathered=[p[0] for p in pp])
    v_ref = residual_update(idx_r, v_ref, rows, None, own_o, +1.0,
                            gathered=[p[1] for p in pp])
    g_ref, h_ref, _ = sweep_partials(idx_r, v_ref, rows, None,
                                     gathered=[p[0] for p in pn])
    for nv, rv in zip(new_vals, v_ref):
        np.testing.assert_allclose(np.asarray(nv), np.asarray(rv),
                                   rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(np.asarray(g), np.asarray(g_ref),
                               rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(np.asarray(h), np.asarray(h_ref), rtol=1e-5, atol=1e-3)


def test_fused_ops_empty_side():
    """A side with no buckets returns zero partials and untouched values."""
    from cuda_recommender_tpu.data.ell import EllSide
    side = EllSide(n_entities=0, num_shards=1, slots_per_shard=3,
                   buckets=(), bucket_offsets=(),
                   slot_of_entity=np.zeros(0, np.int32),
                   entity_of_slot=np.full(3, -1, np.int32),
                   slot_nnz=np.zeros(3, np.float32), other_zero_slot=0)
    tab = extend_zero(jnp.stack([jnp.zeros(4), jnp.zeros(4)], -1))
    nv, g, h = fused_update_sweep((), (), side, tab, owns=(), signs=(),
                                  sweep_col=0)
    assert nv == ()
    assert g.shape == (3,) and not np.asarray(g).any()
    g2, h2 = fused_sweep((), (), side, tab)
    assert g2.shape == (3,) and not np.asarray(h2).any()


def test_deferred_sweep_matches_composition(ell):
    """deferred_sweep + the caller's algebraic correction == apply the
    group's rank-1 deltas to the lanes, then sweep (the round-4 rank-
    deferred tail, ops/ell_ops.deferred_sweep docstring)."""
    R, pair = ell
    cols = pair.cols_side
    idx_c, vals_c = _tiles(cols)
    rng = np.random.default_rng(4)
    G = 2
    sweep = jnp.asarray(rng.standard_normal(R.rows), jnp.float32)
    defs = [jnp.asarray(rng.standard_normal(R.rows), jnp.float32)
            for _ in range(2 * G)]
    owns = [jnp.asarray(rng.standard_normal(cols.n_slots), jnp.float32)
            for _ in range(2 * G)]
    signs = [(-1.0 if c % 2 == 0 else 1.0) for c in range(2 * G)]

    # reference: materialize the updated lanes, then sweep
    v_ref = vals_c
    for d, o, s in zip(defs, owns, signs):
        pg = paired_gather(extend_zero(jnp.stack([d, d], -1)), idx_c)
        v_ref = residual_update(idx_c, v_ref, cols, None, o, s,
                                gathered=[p[0] for p in pg])
    ps = paired_gather(extend_zero(jnp.stack([sweep, sweep], -1)), idx_c)
    g_ref, h_ref, _ = sweep_partials(idx_c, v_ref, cols, None,
                                     gathered=[p[0] for p in ps])

    from cuda_recommender_tpu.ops.ell_ops import deferred_sweep
    tab = extend_zero(jnp.stack([sweep] + defs, -1))
    S0, Sc, h = deferred_sweep(idx_c, vals_c, cols, tab)
    g = S0
    for c in range(2 * G):
        g = g + jnp.float32(signs[c]) * owns[c] * Sc[c]
    np.testing.assert_allclose(np.asarray(g), np.asarray(g_ref),
                               rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(np.asarray(h), np.asarray(h_ref),
                               rtol=1e-5, atol=1e-3)


def test_deferred_flush_matches_sequential_updates(ell):
    """deferred_flush == the same 2G residual_updates applied one at a
    time (UpdateRating, src/CCD.cpp:18-43)."""
    R, pair = ell
    rows = pair.rows_side
    idx_r, vals_r = _tiles(rows)
    rng = np.random.default_rng(5)
    G = 2
    defs = [jnp.asarray(rng.standard_normal(R.cols), jnp.float32)
            for _ in range(2 * G)]
    owns = np.stack([rng.standard_normal(rows.n_slots).astype(np.float32)
                     for _ in range(2 * G)])
    signs = [(-1.0 if c % 2 == 0 else 1.0) for c in range(2 * G)]

    v_ref = vals_r
    for d, o, s in zip(defs, owns, signs):
        pg = paired_gather(extend_zero(jnp.stack([d, d], -1)), idx_r)
        v_ref = residual_update(idx_r, v_ref, rows, None, jnp.asarray(o), s,
                                gathered=[p[0] for p in pg])

    from cuda_recommender_tpu.ops.ell_ops import deferred_flush
    tab = extend_zero(jnp.stack(defs, -1))
    new_vals = deferred_flush(idx_r, vals_r, rows, tab, jnp.asarray(owns),
                              signs)
    for nv, rv in zip(new_vals, v_ref):
        np.testing.assert_allclose(np.asarray(nv), np.asarray(rv),
                                   rtol=1e-5, atol=1e-5)
