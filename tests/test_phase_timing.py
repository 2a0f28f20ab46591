"""Phase-timing mode: real rank_time/update_time split + per-rank verbose
RMSE (the reference's per-phase timers src/CCD.cpp:76-139,158 and commented
calrmse_r1 verbose path src/CCD.cpp:141-148)."""

import numpy as np
import pytest

from cuda_recommender_tpu.core.config import Config
from cuda_recommender_tpu.core.init import init_factors_np
from cuda_recommender_tpu.core.trainer import train
from cuda_recommender_tpu.solvers.ccd_dense import ccd_dense_train
from cuda_recommender_tpu.solvers.ccd_ell import ccd_ell_train

K = 5


@pytest.mark.parametrize("train_fn,backend", [
    (ccd_dense_train, "dense"), (ccd_ell_train, "ell")])
def test_phase_mode_matches_fused(small_data, train_fn, backend):
    """The phase-split plain schedule must produce the same factors and RMSE
    trajectory as the fused deferred-subtract schedule, with BOTH phase
    timers carrying real (nonzero) measurements."""
    R, T = small_data
    W0, H0 = init_factors_np(K, R.rows, R.cols, seed=0)
    base = dict(k=K, maxiter=3, lambda_=0.1, backend=backend)
    Wf, Hf, sf = train_fn(R, W0.copy(), H0.copy(), T, Config(**base))
    Wp, Hp, sp = train_fn(R, W0.copy(), H0.copy(), T,
                          Config(phase_timing=True, **base))
    np.testing.assert_allclose(Wf, Wp, atol=1e-5)
    np.testing.assert_allclose(Hf, Hp, atol=1e-5)
    for a, b in zip(sf, sp):
        assert abs(a.rmse - b.rmse) < 1e-5
    for st in sp:
        assert st.rank_time > 0 and st.update_time > 0
        assert st.rmse_time is not None and st.rmse_time > 0


def test_phase_mode_rank_rmse_converges_to_iteration_rmse(small_data):
    """After the last rank of an outer iteration the residual-RMSE trick
    (calrmse_r1 semantics) equals the full test RMSE of the current factors."""
    R, T = small_data
    W0, H0 = init_factors_np(K, R.rows, R.cols, seed=0)
    seen = []

    def rank_cb(oiter, t, dt, rmse):
        assert dt > 0
        seen.append((oiter, t, rmse))

    cfg = Config(k=K, maxiter=2, lambda_=0.1, backend="dense",
                 phase_timing=True)
    _, _, stats = ccd_dense_train(R, W0.copy(), H0.copy(), T, cfg,
                                  rank_callback=rank_cb)
    assert len(seen) == 2 * K
    by_iter = {o: [r for oo, tt, r in seen if oo == o] for o in (1, 2)}
    for st in stats:
        assert abs(by_iter[st.oiter][-1] - st.rmse) < 1e-5


def test_phase_mode_through_trainer_verbose(small_data, capsys):
    """--phase-timing -q: iteration lines carry nonzero update_time AND a
    measured rmse time; per-rank `iter %d rank %d` lines appear."""
    R, T = small_data
    cfg = Config(k=4, maxiter=2, lambda_=0.1, backend="ell",
                 phase_timing=True, verbose=True)
    train(cfg, R, T)
    out = capsys.readouterr().out
    iter_lines = [ln for ln in out.splitlines() if ln.startswith("[-INFO-]")]
    assert len(iter_lines) == 2
    for ln in iter_lines:
        upd = float(ln.split("update_time")[1].split("|")[0])
        assert upd > 0.0
        assert "time:" in ln           # measured rmse_time present
    rank_lines = [ln for ln in out.splitlines() if ln.startswith("iter ")]
    assert len(rank_lines) == 2 * 4
    assert all("rmse" in ln for ln in rank_lines)


def test_phase_mode_unsupported_combinations(small_data):
    R, T = small_data
    with pytest.raises(NotImplementedError, match="CCD telemetry"):
        train(Config(solver="als", k=4, maxiter=1, phase_timing=True), R, T)
    from cuda_recommender_tpu.parallel.mesh import make_mesh
    with pytest.raises(NotImplementedError, match="single-device"):
        train(Config(k=4, maxiter=1, backend="ell", phase_timing=True), R, T,
              mesh=make_mesh())


def test_phase_mode_hybrid(small_data):
    """The flagship hybrid backend produces the
    reference's populated rank/update/rmse split (src/CCD.cpp:158) in
    --phase-timing mode, golden-identical to the reference solver."""
    R, T = small_data
    res = train(Config(k=4, maxiter=3, lambda_=0.1, backend="hybrid",
                       phase_timing=True, hybrid_dense_cells=50 * R.cols,
                       hybrid_panel_widths=(16,), golden=True), R, T)
    assert res.golden_W.passed and res.golden_H.passed
    for st in res.stats:
        assert st.rank_time > 0 and st.rmse_time is not None
        if st.oiter > 1:
            assert st.update_time > 0
