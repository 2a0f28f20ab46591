"""Panel-hybrid CCD++ backend: golden parity across panel budgets,
degenerate configurations (all-dense / pure-ELL), inner iterations, empty
entities, checkpoint/resume — the same discipline as the other compiled
backends (reference dual-backend validation,
/root/reference/src/main.cpp:109-144)."""

import numpy as np
import pytest

from cuda_recommender_tpu.core.config import Backend, Config
from cuda_recommender_tpu.core.init import init_factors_np
from cuda_recommender_tpu.eval.metrics import golden_compare
from cuda_recommender_tpu.solvers.ccd_dense import ccd_dense_train
from cuda_recommender_tpu.solvers.ccd_hybrid import ccd_hybrid_train, plan_hybrid
from cuda_recommender_tpu.solvers.reference import ccd_reference

K = 6


@pytest.fixture(scope="module")
def ccd_golden(small_data):
    R, T = small_data
    W0, H0 = init_factors_np(K, R.rows, R.cols, seed=0)
    W, H = W0.copy(), H0.copy()
    stats = ccd_reference(R, W, H, T, lambda_=0.1, maxiter=3, maxinneriter=1)
    return W0, H0, W, H, stats


def _assert_matches(W, H, stats, Wr, Hr, stats_r, tol=1e-3):
    assert golden_compare(W, Wr, atol=1e-3).passed
    assert golden_compare(H, Hr, atol=1e-3).passed
    for a, b in zip(stats, stats_r):
        assert abs(a.rmse - b.rmse) < tol


@pytest.mark.parametrize("dense_cells,widths", [
    (100 * 120, (32, 16)),    # multi-panel stair + ELL tail
    (300 * 120, (32,)),       # budget covers everything: all-dense
    (0, ()),                  # no panels: pure ELL
    (40 * 120, ()),           # single full-width panel + ELL tail
])
def test_hybrid_golden_across_budgets(small_data, ccd_golden, dense_cells,
                                      widths):
    R, T = small_data
    W0, H0, Wr, Hr, stats_r = ccd_golden
    cfg = Config(k=K, maxiter=3, maxinneriter=1, lambda_=0.1,
                 backend="hybrid", hybrid_dense_cells=dense_cells,
                 hybrid_panel_widths=widths)
    W, H, stats = ccd_hybrid_train(R, W0.copy(), H0.copy(), T, cfg)
    _assert_matches(W, H, stats, Wr, Hr, stats_r)


def test_hybrid_plan_panels(small_data):
    """Panels form a contiguous stair over degree-sorted users with
    decreasing widths, respect the cell budget, and every rating lands in
    exactly one panel or the ELL remainder."""
    R, _ = small_data
    cfg = Config(backend="hybrid", hybrid_dense_cells=60 * R.cols,
                 hybrid_panel_widths=(32, 16))
    plan = plan_hybrid(R, cfg)
    assert plan.panels, "budget admits at least one panel"
    prev_r, prev_w = 0, R.cols + 1
    cells = 0
    for r0, r1, w in plan.panels:
        assert r0 == prev_r and r1 > r0 and w < prev_w
        prev_r, prev_w = r1, w
        cells += (r1 - r0) * w
    assert cells <= 60 * R.cols
    covered = sum(int(Mp.sum()) for Mp in plan.Md)
    assert covered + plan.nnz_light == R.nnz
    # degree sort: panel-1 users are the top-degree users
    deg = R.row_nnz
    r1 = plan.panels[0][1]
    top = plan.user_order[:r1]
    rest = plan.user_order[r1:]
    assert deg[top].min() >= deg[rest].max()


def test_hybrid_matches_dense_inner2(tiny_data):
    R, T = tiny_data
    W0, H0 = init_factors_np(4, R.rows, R.cols, seed=1)
    cfg_d = Config(k=4, maxiter=2, maxinneriter=2, lambda_=0.05)
    cfg_h = Config(k=4, maxiter=2, maxinneriter=2, lambda_=0.05,
                   backend="hybrid", hybrid_dense_cells=20 * R.cols,
                   hybrid_panel_widths=(8,))
    Wd, Hd, _ = ccd_dense_train(R, W0.copy(), H0.copy(), T, cfg_d)
    Wh, Hh, _ = ccd_hybrid_train(R, W0.copy(), H0.copy(), T, cfg_h)
    np.testing.assert_allclose(Wd, Wh, atol=1e-4)
    np.testing.assert_allclose(Hd, Hh, atol=1e-4)


def test_hybrid_empty_entities_zero_lambda():
    """Empty rows/cols with λ=0 give exact-0 factors, never NaN, in both
    parts of the split (src/CCD.cpp:8)."""
    from cuda_recommender_tpu.data.sparse import from_coo, make_test
    R = from_coo(6, 5, [0, 1, 1, 3], [0, 1, 2, 0], [4.0, 3.0, 5.0, 2.0])
    T = make_test(6, 5, [0], [0], [4.0])
    W0, H0 = init_factors_np(3, 6, 5, seed=0)
    cfg = Config(k=3, maxiter=2, lambda_=0.0, backend="hybrid",
                 hybrid_dense_cells=2 * 5, hybrid_panel_widths=())
    W, H, _ = ccd_hybrid_train(R, W0.copy(), H0.copy(), T, cfg)
    assert np.all(W[:, [2, 4, 5]] == 0)
    assert np.all(H[:, [3, 4]] == 0)
    assert np.isfinite(W).all() and np.isfinite(H).all()


def test_hybrid_fused_iters_equivalent(small_data):
    R, T = small_data
    W0, H0 = init_factors_np(K, R.rows, R.cols, seed=0)
    base = dict(k=K, maxiter=4, lambda_=0.1, backend="hybrid",
                hybrid_dense_cells=100 * R.cols, hybrid_panel_widths=(32,))
    W1, H1, s1 = ccd_hybrid_train(R, W0.copy(), H0.copy(), T,
                                  Config(**base))
    W3, H3, s3 = ccd_hybrid_train(R, W0.copy(), H0.copy(), T,
                                  Config(fused_outer_iters=3, **base))
    np.testing.assert_allclose(W1, W3, atol=1e-6)
    np.testing.assert_allclose(H1, H3, atol=1e-6)
    for a, b in zip(s1, s3):
        assert abs(a.rmse - b.rmse) < 1e-5


def test_hybrid_int8_mask_identical(small_data, ccd_golden):
    """int8 mask storage is bit-identical to the bf16 mask: {0,1} is exact
    in both, the sweeps convert at the operand load
    (cfg.mask_dtype; the knob exists purely to halve the mask's HBM
    footprint for larger panel budgets)."""
    R, T = small_data
    W0, H0, Wr, Hr, stats_r = ccd_golden
    outs = []
    for mdt in ("bfloat16", "int8"):
        cfg = Config(k=K, maxiter=3, maxinneriter=1, lambda_=0.1,
                     backend="hybrid", hybrid_dense_cells=100 * R.cols,
                     hybrid_panel_widths=(32, 16), mask_dtype=mdt)
        outs.append(ccd_hybrid_train(R, W0.copy(), H0.copy(), T, cfg))
    W8, H8, stats8 = outs[1]
    np.testing.assert_array_equal(outs[0][0], W8)
    np.testing.assert_array_equal(outs[0][1], H8)
    _assert_matches(W8, H8, stats8, Wr, Hr, stats_r)


def test_hybrid_nan_mask_identical(small_data, ccd_golden):
    """mask_dtype='nan' (no mask array; unobserved panel cells hold a NaN
    sentinel in the residual) is bit-identical to the explicit bf16 mask at
    f32 residual: the update's masked delta and the sweeps' masked operands
    see exactly the same values — only the storage encoding differs."""
    R, T = small_data
    W0, H0, Wr, Hr, stats_r = ccd_golden
    outs = []
    for mdt in ("bfloat16", "nan"):
        cfg = Config(k=K, maxiter=3, maxinneriter=1, lambda_=0.1,
                     backend="hybrid", hybrid_dense_cells=100 * R.cols,
                     hybrid_panel_widths=(32, 16), mask_dtype=mdt)
        outs.append(ccd_hybrid_train(R, W0.copy(), H0.copy(), T, cfg))
    Wn, Hn, statsn = outs[1]
    np.testing.assert_array_equal(outs[0][0], Wn)
    np.testing.assert_array_equal(outs[0][1], Hn)
    _assert_matches(Wn, Hn, statsn, Wr, Hr, stats_r)


def test_hybrid_panel_kernel_golden(small_data, ccd_golden):
    """Fused Pallas panel kernels (update+v-sweep RMW pass, u-sweep read
    pass, ops/panel_pallas.py; interpret mode on CPU): golden parity with
    the reference solver, and ULP-level agreement with the XLA nan-mask
    path (blocked f32 accumulation differs only in FMA/sum order)."""
    R, T = small_data
    W0, H0, Wr, Hr, stats_r = ccd_golden
    base = dict(k=K, maxiter=3, maxinneriter=1, lambda_=0.1,
                backend="hybrid", hybrid_dense_cells=100 * R.cols,
                hybrid_panel_widths=(32, 16), mask_dtype="nan")
    Wx, Hx, _ = ccd_hybrid_train(R, W0.copy(), H0.copy(), T,
                                 Config(**base))
    W, H, stats = ccd_hybrid_train(R, W0.copy(), H0.copy(), T,
                                   Config(hybrid_panel_kernel=True, **base))
    np.testing.assert_allclose(W, Wx, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(H, Hx, rtol=1e-4, atol=1e-5)
    _assert_matches(W, H, stats, Wr, Hr, stats_r)


def test_hybrid_panel_kernel_inner2(small_data):
    """Kernel mode with maxinneriter=2 exercises the read-only v-sweep
    kernel (i > 0) and still matches the golden solver."""
    R, T = small_data
    W0, H0 = init_factors_np(K, R.rows, R.cols, seed=0)
    Wr, Hr = W0.copy(), H0.copy()
    ccd_reference(R, Wr, Hr, T, lambda_=0.1, maxiter=2, maxinneriter=2)
    cfg = Config(k=K, maxiter=2, maxinneriter=2, lambda_=0.1,
                 backend="hybrid", hybrid_dense_cells=100 * R.cols,
                 hybrid_panel_widths=(32, 16), mask_dtype="nan",
                 hybrid_panel_kernel=True)
    W, H, _ = ccd_hybrid_train(R, W0.copy(), H0.copy(), T, cfg)
    assert golden_compare(W, Wr, atol=1e-3).passed
    assert golden_compare(H, Hr, atol=1e-3).passed


def test_hybrid_nan_mask_inner2_and_resume(small_data, tmp_path):
    """NaN-sentinel mode with maxinneriter=2 (the i>0 sweep reads the
    NaN-carrying residual with no preceding update) matches the golden
    solver, and checkpoint/resume reproduces the uninterrupted run (the
    sentinel survives the npz round-trip)."""
    from cuda_recommender_tpu.core.trainer import train
    R, T = small_data
    W0, H0 = init_factors_np(K, R.rows, R.cols, seed=0)
    Wr, Hr = W0.copy(), H0.copy()
    ccd_reference(R, Wr, Hr, T, lambda_=0.1, maxiter=3, maxinneriter=2)
    base = dict(k=K, maxinneriter=2, lambda_=0.1, backend="hybrid",
                hybrid_dense_cells=100 * R.cols,
                hybrid_panel_widths=(32, 16), mask_dtype="nan")
    full = train(Config(maxiter=3, **base), R, T)
    assert golden_compare(full.W, Wr, atol=1e-3).passed
    assert golden_compare(full.H, Hr, atol=1e-3).passed

    ck = str(tmp_path / "ck")
    train(Config(maxiter=2, checkpoint_dir=ck, checkpoint_every=1, **base),
          R, T)
    resumed = train(Config(maxiter=3, checkpoint_dir=ck, checkpoint_every=1,
                           **base), R, T, resume_from_checkpoint=True)
    np.testing.assert_allclose(full.W, resumed.W, atol=1e-6)
    np.testing.assert_allclose(full.H, resumed.H, atol=1e-6)


@pytest.mark.parametrize("rdt,tol", [("bfloat16", 0.02),
                                     ("float8_e4m3fn", 0.05)])
def test_hybrid_lowprec_residual(small_data, ccd_golden, rdt, tol):
    """Reduced-precision residual storage tracks the golden RMSE trajectory
    over a FEW iterations. fp8-e4m3 is fine early but stalls at a worse
    plateau at convergence (on the ml1m fixture at 15 iters: 0.764 vs
    0.710) — its ~6% storage quantization feeds back through the rank
    recursion, so fp8 is opt-in for screening, never the default."""
    R, T = small_data
    W0, H0, Wr, Hr, stats_r = ccd_golden
    cfg = Config(k=K, maxiter=3, lambda_=0.1, backend="hybrid",
                 hybrid_dense_cells=100 * R.cols,
                 residual_dtype=rdt)
    W, H, stats = ccd_hybrid_train(R, W0.copy(), H0.copy(), T, cfg)
    assert np.isfinite(W).all()
    for a, b in zip(stats, stats_r):
        assert abs(a.rmse - b.rmse) < tol


def test_hybrid_coo_plan_matches_materialized(small_data):
    """materialize_dense=False exposes per-panel COO that scatters to the
    same dense blocks (the device-side densify path for huge matrices)."""
    R, _ = small_data
    cfg = Config(backend="hybrid", hybrid_dense_cells=80 * R.cols,
                 hybrid_panel_widths=(32,))
    pm = plan_hybrid(R, cfg, materialize_dense=True)
    pc = plan_hybrid(R, cfg, materialize_dense=False)
    assert pc.panel_coo is not None and len(pc.panel_coo) == len(pm.Rd)
    for (lr, lc, lv), A, (r0, r1, w) in zip(pc.panel_coo, pm.Rd, pm.panels):
        B = np.zeros((r1 - r0, w), np.float32)
        B[lr, lc] = lv
        np.testing.assert_array_equal(A, B)


def test_hybrid_trainer_resume(small_data, tmp_path):
    from cuda_recommender_tpu.core.trainer import train
    R, T = small_data
    base = dict(k=4, lambda_=0.1, backend="hybrid",
                hybrid_dense_cells=100 * R.cols,
                hybrid_panel_widths=(32,))
    full = train(Config(maxiter=4, **base), R, T)
    ck = str(tmp_path / "ck")
    train(Config(maxiter=2, checkpoint_dir=ck, checkpoint_every=1, **base),
          R, T)
    resumed = train(Config(maxiter=4, checkpoint_dir=ck, checkpoint_every=1,
                           **base), R, T, resume_from_checkpoint=True)
    np.testing.assert_allclose(full.W, resumed.W, atol=1e-6)
    np.testing.assert_allclose(full.H, resumed.H, atol=1e-6)


def test_auto_resolves_hybrid_when_dense_too_big():
    cfg = Config(backend="auto", dense_max_cells=1000)
    assert cfg.resolve_backend(1000, 1000) == Backend.HYBRID
    # ALS never routes to hybrid
    assert Config(solver="als", backend="hybrid").resolve_backend(5, 5) \
        == Backend.ELL


def test_hybrid_full_budget_has_no_tail(small_data, ccd_golden):
    """A budget >= m*n yields ONE full panel and an empty ELL tail — the
    dense case as a degenerate hybrid plan (boundary candidates include the
    exact, unaligned row count in the single-shard planner)."""
    R, T = small_data
    W0, H0, Wr, Hr, stats_r = ccd_golden
    cfg = Config(k=K, maxiter=3, maxinneriter=1, lambda_=0.1,
                 backend="hybrid", hybrid_dense_cells=R.rows * R.cols,
                 hybrid_panel_widths=(32,), mask_dtype="nan",
                 hybrid_panel_kernel=True)
    plan = plan_hybrid(R, cfg, materialize_dense=False)
    assert plan.panels == ((0, R.rows, R.cols),)
    assert plan.nnz_light == 0
    W, H, stats = ccd_hybrid_train(R, W0.copy(), H0.copy(), T, cfg)
    _assert_matches(W, H, stats, Wr, Hr, stats_r)


def test_hybrid_auto_stair_plan_properties():
    """The data-driven stair (hybrid_panel_widths='auto'): budget respected,
    widths non-increasing over a contiguous row stair, panel count capped,
    and coverage at least matching the hand-width legacy planner at the
    same budget."""
    from cuda_recommender_tpu.data import datasets
    R, _ = datasets.synthetic(m=2000, n=600, nnz=40000, seed=11)
    budget = 60 * R.cols
    cfg = Config(backend="hybrid", hybrid_dense_cells=budget,
                 hybrid_panel_widths="auto", hybrid_max_panels=4)
    plan = plan_hybrid(R, cfg, materialize_dense=False)
    assert plan.panels and len(plan.panels) <= 4
    prev_r, prev_w = 0, R.cols + 1
    cells = 0
    for r0, r1, w in plan.panels:
        assert r0 == prev_r and r1 > r0 and w < prev_w
        prev_r, prev_w = r1, w
        cells += (r1 - r0) * w
    assert cells <= budget
    cfg_legacy = Config(backend="hybrid", hybrid_dense_cells=budget,
                        hybrid_panel_widths=(256, 128))
    plan_legacy = plan_hybrid(R, cfg_legacy, materialize_dense=False)
    assert plan.nnz_light <= plan_legacy.nnz_light


def test_hybrid_auto_stair_golden(small_data, ccd_golden):
    """Auto-stair plans train to the same factors as the reference solver
    (the planner changes the decomposition, never the math)."""
    R, T = small_data
    W0, H0, Wr, Hr, stats_r = ccd_golden
    cfg = Config(k=K, maxiter=3, maxinneriter=1, lambda_=0.1,
                 backend="hybrid", hybrid_dense_cells=100 * R.cols,
                 hybrid_panel_widths="auto")
    W, H, stats = ccd_hybrid_train(R, W0.copy(), H0.copy(), T, cfg)
    _assert_matches(W, H, stats, Wr, Hr, stats_r)


def test_hybrid_auto_stair_full_budget(small_data):
    """budget >= m*n: the auto stair degenerates to one full panel."""
    R, _ = small_data
    cfg = Config(backend="hybrid", hybrid_dense_cells=R.rows * R.cols,
                 hybrid_panel_widths="auto")
    plan = plan_hybrid(R, cfg, materialize_dense=False)
    assert plan.panels == ((0, R.rows, R.cols),)
    assert plan.nnz_light == 0


@pytest.mark.parametrize("defer,inner", [(2, 1), (3, 2), (16, 1)])
def test_hybrid_defer_group_equivalent(small_data, defer, inner):
    """The rank-deferred ELL tail (hybrid_defer_group=G) is numerically
    interchangeable with the per-rank fused path (G=0): same RankOneUpdate
    / UpdateRating math, different FMA order. Covers a G that divides k, a
    G with a partial trailing group + inner iterations, and G > k (single
    group flushed at the last rank)."""
    R, T = small_data
    W0, H0 = init_factors_np(K, R.rows, R.cols, seed=0)
    base = dict(k=K, maxiter=3, maxinneriter=inner, lambda_=0.1,
                backend="hybrid", hybrid_dense_cells=100 * 120,
                hybrid_panel_widths=(32, 16))
    W_a, H_a, st_a = ccd_hybrid_train(R, W0.copy(), H0.copy(), T,
                                      Config(hybrid_defer_group=0, **base))
    W_b, H_b, st_b = ccd_hybrid_train(R, W0.copy(), H0.copy(), T,
                                      Config(hybrid_defer_group=defer,
                                             **base))
    np.testing.assert_allclose(W_b, W_a, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(H_b, H_a, rtol=1e-3, atol=1e-4)
    for a, b in zip(st_a, st_b):
        assert abs(a.rmse - b.rmse) < 1e-4


def test_hybrid_transpose_golden(small_data):
    """hybrid_transpose=True solves R^T with the item side seeded — the
    trajectories must match the golden reference run on the TRANSPOSED
    problem exactly (same dual-backend discipline, orientation flipped)."""
    from cuda_recommender_tpu.data.sparse import make_test
    R, T = small_data
    W0, H0 = init_factors_np(K, R.rows, R.cols, seed=0)
    cfg = Config(k=K, maxiter=3, maxinneriter=1, lambda_=0.1,
                 backend="hybrid", hybrid_dense_cells=100 * 120,
                 hybrid_panel_widths=(32, 16), hybrid_transpose=True)
    W, H, stats = ccd_hybrid_train(R, W0.copy(), H0.copy(), T, cfg)
    assert W.shape == (K, R.rows) and H.shape == (K, R.cols)
    # reference on the transposed problem: item side seeded with H0
    Tt = make_test(T.cols, T.rows, T.col_idx, T.row_idx, T.val)
    Wt, Ht = H0.copy(), W0.copy()
    stats_r = ccd_reference(R.transpose(), Wt, Ht, Tt, lambda_=0.1,
                            maxiter=3, maxinneriter=1)
    _assert_matches(W, H, stats, Ht, Wt, stats_r)


def test_hybrid_transpose_auto_picks_small_tail():
    """'auto' keeps the orientation with the smaller uncovered tail: with
    zipf ITEM degrees and flat user degrees, the top-item stair covers far
    more nnz at equal budget than the classic top-user stair."""
    from cuda_recommender_tpu.data.sparse import from_coo
    from cuda_recommender_tpu.solvers.ccd_hybrid import (
        resolve_hybrid_transpose)
    rng = np.random.default_rng(11)
    m, n, nnz = 600, 400, 20_000
    rows = rng.integers(0, m, nnz)                      # flat users
    cols = (rng.zipf(1.3, nnz) - 1) % n                 # zipf items
    key = rows * n + cols
    _, u = np.unique(key, return_index=True)
    R = from_coo(m, n, rows[u].astype(np.int32), cols[u].astype(np.int32),
                 rng.standard_normal(u.size).astype(np.float32))
    cfg = Config(backend="hybrid", hybrid_dense_cells=30_000,
                 hybrid_panel_widths="auto", hybrid_transpose="auto")
    assert resolve_hybrid_transpose(R, cfg) is True
    # and the symmetric case prefers the classic stair
    Rt = R.transpose()
    assert resolve_hybrid_transpose(Rt, cfg) is False
