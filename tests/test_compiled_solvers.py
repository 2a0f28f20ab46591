"""Compiled-backend golden validation: every compiled backend must reproduce the
NumPy golden solver from identical init within the reference's 10% per-entry
tolerance (the reference's own dual-backend discipline,
/root/reference/src/main.cpp:109-144) — and in practice to ~1e-5."""

import numpy as np
import pytest

from cuda_recommender_tpu.core.config import Config
from cuda_recommender_tpu.core.init import init_factors_np
from cuda_recommender_tpu.eval.metrics import golden_compare
from cuda_recommender_tpu.solvers.als_ell import als_ell_train
from cuda_recommender_tpu.solvers.ccd_dense import ccd_dense_train
from cuda_recommender_tpu.solvers.ccd_ell import ccd_ell_train
from cuda_recommender_tpu.solvers.reference import als_reference, ccd_reference

K = 6


@pytest.fixture(scope="module")
def ccd_golden(small_data):
    R, T = small_data
    W0, H0 = init_factors_np(K, R.rows, R.cols, seed=0)
    W, H = W0.copy(), H0.copy()
    stats = ccd_reference(R, W, H, T, lambda_=0.1, maxiter=3, maxinneriter=1)
    return W0, H0, W, H, stats


@pytest.fixture(scope="module")
def als_golden(small_data):
    R, T = small_data
    W0, H0 = init_factors_np(K, R.rows, R.cols, seed=0, entity_major=True)
    W, H = W0.copy(), H0.copy()
    stats = als_reference(R, W, H, T, lambda_=0.1, maxiter=3)
    return W0, H0, W, H, stats


def _assert_matches(W, H, stats, Wr, Hr, stats_r, tol=1e-3):
    assert golden_compare(W, Wr, atol=1e-3).passed
    assert golden_compare(H, Hr, atol=1e-3).passed
    for a, b in zip(stats, stats_r):
        assert abs(a.rmse - b.rmse) < tol


def test_ccd_dense_golden(small_data, ccd_golden):
    R, T = small_data
    W0, H0, Wr, Hr, stats_r = ccd_golden
    cfg = Config(k=K, maxiter=3, maxinneriter=1, lambda_=0.1, backend="dense")
    W, H, stats = ccd_dense_train(R, W0.copy(), H0.copy(), T, cfg)
    _assert_matches(W, H, stats, Wr, Hr, stats_r)


def test_ccd_dense_int8_mask_identical(small_data):
    """cfg.mask_dtype='int8' is bit-identical to the bf16 default ({0,1}
    exact in both; the sweeps convert at the operand load — the knob only
    halves the mask's HBM footprint/traffic)."""
    R, T = small_data
    W0, H0 = init_factors_np(K, R.rows, R.cols, seed=0)
    outs = []
    for mdt in ("bfloat16", "int8"):
        cfg = Config(k=K, maxiter=3, maxinneriter=1, lambda_=0.1,
                     backend="dense", mask_dtype=mdt)
        outs.append(ccd_dense_train(R, W0.copy(), H0.copy(), T, cfg))
    np.testing.assert_array_equal(outs[0][0], outs[1][0])
    np.testing.assert_array_equal(outs[0][1], outs[1][1])


def test_ccd_ell_golden(small_data, ccd_golden):
    R, T = small_data
    W0, H0, Wr, Hr, stats_r = ccd_golden
    cfg = Config(k=K, maxiter=3, maxinneriter=1, lambda_=0.1, backend="ell")
    W, H, stats = ccd_ell_train(R, W0.copy(), H0.copy(), T, cfg)
    _assert_matches(W, H, stats, Wr, Hr, stats_r)


def test_ccd_backends_agree_inner2(tiny_data):
    """Dense and ELL must agree with each other (and golden) at inner iters=2."""
    R, T = tiny_data
    W0, H0 = init_factors_np(4, R.rows, R.cols, seed=1)
    cfg = Config(k=4, maxiter=2, maxinneriter=2, lambda_=0.05)
    Wd, Hd, _ = ccd_dense_train(R, W0.copy(), H0.copy(), T, cfg)
    We, He, _ = ccd_ell_train(R, W0.copy(), H0.copy(), T, cfg)
    np.testing.assert_allclose(Wd, We, atol=1e-4)
    np.testing.assert_allclose(Hd, He, atol=1e-4)


def test_ccd_dense_fused_iters_equivalent(small_data):
    """fused_outer_iters groups dispatches without changing results."""
    R, T = small_data
    W0, H0 = init_factors_np(K, R.rows, R.cols, seed=0)
    cfg1 = Config(k=K, maxiter=5, lambda_=0.1, backend="dense")
    cfg3 = Config(k=K, maxiter=5, lambda_=0.1, backend="dense",
                  fused_outer_iters=3)
    W1, H1, s1 = ccd_dense_train(R, W0.copy(), H0.copy(), T, cfg1)
    W3, H3, s3 = ccd_dense_train(R, W0.copy(), H0.copy(), T, cfg3)
    np.testing.assert_allclose(W1, W3, atol=1e-6)
    np.testing.assert_allclose(H1, H3, atol=1e-6)
    assert [s.oiter for s in s3] == [1, 2, 3, 4, 5]
    for a, b in zip(s1, s3):
        assert abs(a.rmse - b.rmse) < 1e-5


def test_ell_and_als_fused_iters_equivalent(small_data):
    R, T = small_data
    W0, H0 = init_factors_np(K, R.rows, R.cols, seed=0)
    c1 = Config(k=K, maxiter=5, lambda_=0.1, backend="ell")
    c3 = Config(k=K, maxiter=5, lambda_=0.1, backend="ell",
                fused_outer_iters=3)
    W1, H1, _ = ccd_ell_train(R, W0.copy(), H0.copy(), T, c1)
    W3, H3, _ = ccd_ell_train(R, W0.copy(), H0.copy(), T, c3)
    np.testing.assert_allclose(W1, W3, atol=1e-6)

    Wa, Ha = init_factors_np(K, R.rows, R.cols, seed=0, entity_major=True)
    a1 = Config(solver="als", k=K, maxiter=4, lambda_=0.1)
    a2 = Config(solver="als", k=K, maxiter=4, lambda_=0.1,
                fused_outer_iters=4)
    Wx, _, sx = als_ell_train(R, Wa.copy(), Ha.copy(), T, a1)
    Wy, _, sy = als_ell_train(R, Wa.copy(), Ha.copy(), T, a2)
    np.testing.assert_allclose(Wx, Wy, atol=1e-6)
    for a, b in zip(sx, sy):
        assert abs(a.rmse - b.rmse) < 1e-5


def test_als_ell_golden(small_data, als_golden):
    R, T = small_data
    W0, H0, Wr, Hr, stats_r = als_golden
    cfg = Config(solver="als", k=K, maxiter=3, lambda_=0.1, backend="ell",
                 ell_chunk=256)
    W, H, stats = als_ell_train(R, W0.copy(), H0.copy(), T, cfg)
    _assert_matches(W, H, stats, Wr, Hr, stats_r)


def test_ccd_dense_bf16_residual(small_data, ccd_golden):
    """bf16 residual halves HBM traffic; RMSE must track f32 closely (the
    mask is exact in bf16, only residual values round)."""
    R, T = small_data
    W0, H0, Wr, Hr, stats_r = ccd_golden
    cfg = Config(k=K, maxiter=3, lambda_=0.1, backend="dense",
                 residual_dtype="bfloat16")
    W, H, stats = ccd_dense_train(R, W0.copy(), H0.copy(), T, cfg)
    assert np.isfinite(W).all()
    for a, b in zip(stats, stats_r):
        assert abs(a.rmse - b.rmse) < 0.02


def test_als_default_precision_close(small_data, als_golden):
    """als_precision='default' (reduced-precision grams) stays within a few permil of
    the golden trajectory — the production-speed option."""
    R, T = small_data
    W0, H0, Wr, Hr, stats_r = als_golden
    cfg = Config(solver="als", k=K, maxiter=3, lambda_=0.1,
                 als_precision="default")
    W, H, stats = als_ell_train(R, W0.copy(), H0.copy(), T, cfg)
    for a, b in zip(stats, stats_r):
        assert abs(a.rmse - b.rmse) < 0.01


def test_ccd_empty_entities_zero_lambda():
    """Empty rows/cols with λ=0 must give exact-0 factors, never NaN
    (reference: empty column returns 0, src/CCD.cpp:8)."""
    from cuda_recommender_tpu.data.sparse import from_coo, make_test
    R = from_coo(6, 5, [0, 1, 1, 3], [0, 1, 2, 0], [4.0, 3.0, 5.0, 2.0])
    T = make_test(6, 5, [0], [0], [4.0])
    W0, H0 = init_factors_np(3, 6, 5, seed=0)
    cfg = Config(k=3, maxiter=2, lambda_=0.0, backend="dense")
    W, H, _ = ccd_dense_train(R, W0.copy(), H0.copy(), T, cfg)
    assert np.all(W[:, [2, 4, 5]] == 0)       # empty user rows
    assert np.all(H[:, [3, 4]] == 0)          # empty item cols
    assert np.isfinite(W).all() and np.isfinite(H).all()
    cfg2 = Config(k=3, maxiter=2, lambda_=0.0, backend="ell")
    W2, H2, _ = ccd_ell_train(R, W0.copy(), H0.copy(), T, cfg2)
    assert np.all(W2[:, [2, 4, 5]] == 0) and np.all(H2[:, [3, 4]] == 0)
    assert np.isfinite(W2).all() and np.isfinite(H2).all()


def test_als_empty_entities():
    from cuda_recommender_tpu.data.sparse import from_coo, make_test
    R = from_coo(6, 5, [0, 1, 1, 3], [0, 1, 2, 0], [4.0, 3.0, 5.0, 2.0])
    T = make_test(6, 5, [0], [0], [4.0])
    W0, H0 = init_factors_np(3, 6, 5, seed=0, entity_major=True)
    cfg = Config(solver="als", k=3, maxiter=2, lambda_=0.1, backend="ell")
    W, H, _ = als_ell_train(R, W0.copy(), H0.copy(), T, cfg)
    assert np.all(W[[2, 4, 5]] == 0) and np.all(H[[3, 4]] == 0)
    assert np.isfinite(W).all() and np.isfinite(H).all()


def test_gauss_jordan_solve_matches_numpy(rng):
    from cuda_recommender_tpu.solvers.als_ell import gauss_jordan_solve
    import jax.numpy as jnp
    S, k = 64, 12
    F = rng.normal(size=(S, 30, k)).astype(np.float32)
    A = np.einsum("sek,sel->skl", F, F) + 0.1 * np.eye(k, dtype=np.float32)
    b = rng.normal(size=(S, k)).astype(np.float32)
    x = np.asarray(gauss_jordan_solve(jnp.asarray(A), jnp.asarray(b)))
    want = np.linalg.solve(A, b[..., None])[..., 0]
    np.testing.assert_allclose(x, want, rtol=2e-3, atol=2e-4)


@pytest.mark.parametrize("solver", ["lax", "gj_xla"])
@pytest.mark.parametrize("k", [1, 4, 10, 40, 128])
def test_als_solve_matches_numpy(rng, solver, k):
    """The batched XLA k×k solve on SPD grams F^T F + λI against float64
    np.linalg.solve, normwise per system (f32 arithmetic; the grams are
    well conditioned, so 1e-4 leaves a wide margin)."""
    import jax.numpy as jnp

    from cuda_recommender_tpu.solvers.als_ell import _solve_kxk

    S = 32
    F = rng.normal(size=(S, 2 * k, k)).astype(np.float32)
    A = np.einsum("sek,sel->skl", F, F) + 0.1 * np.eye(k, dtype=np.float32)
    b = rng.normal(size=(S, k)).astype(np.float32)
    x = np.asarray(_solve_kxk(jnp.asarray(A), jnp.asarray(b), solver))
    want = np.linalg.solve(A.astype(np.float64),
                           b.astype(np.float64)[..., None])[..., 0]
    err = np.linalg.norm(x - want, axis=1) / np.linalg.norm(want, axis=1)
    assert err.max() <= 1e-4


@pytest.mark.parametrize("k", [1, 4, 10, 40, 128])
def test_als_zero_lambda_empty_slots_exact_zero(k):
    """λ=0 makes an empty entity's gram singular (all zeros); its factor
    must come out as exact 0 — never NaN — at every rank, and the
    non-empty factors (degree > k, so their grams are nonsingular) stay
    finite."""
    from cuda_recommender_tpu.data.sparse import from_coo, make_test

    rng = np.random.default_rng(k)
    m, n = 2 * k + 20, 2 * k + 10
    r, c = np.nonzero(rng.random((m, n)) < 0.9)
    keep = ~np.isin(r, [3, 17]) & ~np.isin(c, [5, n - 1])  # empty entities
    R = from_coo(m, n, r[keep], c[keep],
                 rng.normal(3, 1, keep.sum()).astype(np.float32))
    T = make_test(m, n, [0], [0], [3.0])
    W0, H0 = init_factors_np(k, m, n, seed=0, entity_major=True)
    cfg = Config(solver="als", k=k, maxiter=1, lambda_=0.0)
    W, H, _ = als_ell_train(R, W0, H0, T, cfg)
    assert np.all(W[[3, 17]] == 0) and np.all(H[[5, n - 1]] == 0)
    assert np.isfinite(W).all() and np.isfinite(H).all()


def test_als_wide_bucket_not_chunk_divisible():
    """Data-driven ladder widths need not divide the gram scan chunk
    (ell_chunk=512): a ~700-wide bucket must stream 512 + a 188-column
    remainder (solvers/als_ell.py gram_and_rhs) and still match golden.
    Regression: the pre-ladder code reshaped (rows, L) -> (rows, L//chunk,
    chunk), which crashes for L % chunk != 0."""
    rng = np.random.default_rng(0)
    m, n = 300, 800
    r = np.concatenate([np.full(700, 0), rng.integers(1, m, 4000)])
    c = np.concatenate([rng.choice(n, 700, replace=False),
                        rng.integers(0, n, 4000)])
    u, _ = np.unique(np.stack([r, c]), axis=1, return_index=True)
    r, c = u[0].astype(np.int32), u[1].astype(np.int32)
    v = rng.uniform(1, 5, r.size).astype(np.float32)
    from cuda_recommender_tpu.data.sparse import from_coo, make_test
    R = from_coo(m, n, r, c, v)
    T = make_test(m, n, rng.integers(0, m, 500).astype(np.int32),
                  rng.integers(0, n, 500).astype(np.int32),
                  rng.uniform(1, 5, 500).astype(np.float32))
    assert int(np.diff(R.csr_ptr).max()) == 700
    W0, H0 = init_factors_np(K, m, n, seed=0, entity_major=True)
    Wr, Hr = W0.copy(), H0.copy()
    als_reference(R, Wr, Hr, T, lambda_=0.1, maxiter=3)
    W, H, _ = als_ell_train(R, W0.copy(), H0.copy(), T,
                            Config(k=K, lambda_=0.1, maxiter=3,
                                   solver="als", backend="ell"))
    assert golden_compare(W, Wr, atol=1e-3).passed
    assert golden_compare(H, Hr, atol=1e-3).passed


@pytest.mark.parametrize("tile_mb,group_mb", [(0.002, 2048), (0, 1),
                                              (0.002, 1)])
def test_als_gather_tiled_matches_classic(tile_mb, group_mb):
    """Gather tiling and row groups: forcing a tiny tile threshold
    partitions every p==1 bucket's lanes by other-side table tile, and a
    tiny group budget splits each bucket into many lax.map row groups;
    either way (and both at once) the factors must reproduce the untiled
    single-group path (same sums up to f32 accumulation order) and match
    the golden reference. Needs high-degree rows so the rows side has wide
    (p==1) buckets."""
    from cuda_recommender_tpu.data.datasets import synthetic
    from cuda_recommender_tpu.data.ell import build_ell_pair
    from cuda_recommender_tpu.solvers.als_ell import (
        _row_groups, als_ell_train, build_side_gather_tiles)
    from cuda_recommender_tpu.solvers.reference import als_reference

    R, T = synthetic(m=200, n=300, nnz=30_000, seed=4, test_fraction=0.05)
    k = 6
    W0, H0 = init_factors_np(k, R.rows, R.cols, seed=0, entity_major=True)
    base = dict(solver="als", k=k, lambda_=0.1, maxiter=3)
    Wc, Hc, sc = als_ell_train(R, W0.copy(), H0.copy(), T,
                               Config(als_gather_tile_mb=0, **base))
    # ~2 KB tiles -> many tiles over the 300-slot cols table; 1 MB groups
    # -> several row groups per wide bucket
    cfg_t = Config(als_gather_tile_mb=tile_mb, als_group_mb=group_mb, **base)
    ell = build_ell_pair(R, min_width=cfg_t.als_min_width, num_shards=1)
    tb, _ = build_side_gather_tiles(ell.rows_side, ell.cols_side.n_slots,
                                    k, cfg_t.als_gather_tile_mb)
    assert bool(tb) == (tile_mb > 0), "tiling must trigger iff requested"
    groups = max(len(_row_groups(b.idx.shape[0], b.L, b.p, k,
                                 group_mb << 20))
                 for b in ell.rows_side.buckets)
    assert (groups > 1) == (group_mb == 1)
    Wt, Ht, st = als_ell_train(R, W0.copy(), H0.copy(), T, cfg_t)
    np.testing.assert_allclose(Wt, Wc, atol=5e-4, rtol=5e-4)
    np.testing.assert_allclose(Ht, Hc, atol=5e-4, rtol=5e-4)
    for a, c in zip(st, sc):
        assert abs(a.rmse - c.rmse) < 1e-4
    stats_g = als_reference(R, W0.copy(), H0.copy(), T, lambda_=0.1,
                            maxiter=3)
    for a, g in zip(st, stats_g):
        assert abs(a.rmse - g.rmse) < 1e-3
