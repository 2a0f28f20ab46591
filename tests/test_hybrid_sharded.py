"""Sharded panel-hybrid: sharded == single-device on the 8-virtual-device
CPU mesh (the discipline every sharded backend follows, tests/test_sharded.py)."""

import numpy as np
import pytest

from cuda_recommender_tpu.core.config import Backend, Config
from cuda_recommender_tpu.core.init import init_factors_np
from cuda_recommender_tpu.parallel.ccd_hybrid_sharded import (
    ccd_hybrid_train_sharded)
from cuda_recommender_tpu.parallel.mesh import make_mesh
from cuda_recommender_tpu.solvers.ccd_hybrid import ccd_hybrid_train

K = 5


@pytest.mark.parametrize("dense_cells,widths,inner", [
    (100 * 120, (32, 16), 1),     # multi-panel stair + ELL tail
    (0, (), 1),                   # pure ELL
    (300 * 120, (32,), 1),        # all-dense
    (100 * 120, (32,), 2),        # inner iterations
])
def test_sharded_hybrid_matches_single(small_data, dense_cells, widths,
                                       inner):
    R, T = small_data
    W0, H0 = init_factors_np(K, R.rows, R.cols, seed=0)
    cfg = Config(k=K, maxiter=3, maxinneriter=inner, lambda_=0.1,
                 backend="hybrid", hybrid_dense_cells=dense_cells,
                 hybrid_panel_widths=widths)
    W1, H1, s1 = ccd_hybrid_train(R, W0.copy(), H0.copy(), T, cfg)
    W8, H8, s8 = ccd_hybrid_train_sharded(R, W0.copy(), H0.copy(), T, cfg,
                                          make_mesh())
    np.testing.assert_allclose(W1, W8, atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(H1, H8, atol=2e-5, rtol=1e-4)
    for a, b in zip(s1, s8):
        assert abs(a.rmse - b.rmse) < 1e-5


def test_sharded_hybrid_nan_mask_matches_single(small_data):
    """NaN-sentinel masking under shard_map: sharded == single-device, and
    both == the explicit-mask single-device run (the per-device math only
    changes the mask's storage encoding)."""
    R, T = small_data
    W0, H0 = init_factors_np(K, R.rows, R.cols, seed=0)
    base = dict(k=K, maxiter=3, maxinneriter=1, lambda_=0.1,
                backend="hybrid", hybrid_dense_cells=100 * R.cols,
                hybrid_panel_widths=(32, 16))
    Wm, Hm, _ = ccd_hybrid_train(R, W0.copy(), H0.copy(), T,
                                 Config(mask_dtype="bfloat16", **base))
    cfg = Config(mask_dtype="nan", **base)
    W1, H1, s1 = ccd_hybrid_train(R, W0.copy(), H0.copy(), T, cfg)
    W8, H8, s8 = ccd_hybrid_train_sharded(R, W0.copy(), H0.copy(), T, cfg,
                                          make_mesh())
    np.testing.assert_array_equal(W1, Wm)
    np.testing.assert_allclose(W1, W8, atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(H1, H8, atol=2e-5, rtol=1e-4)
    for a, b in zip(s1, s8):
        assert abs(a.rmse - b.rmse) < 1e-5


def test_sharded_hybrid_panel_kernel_matches_single(small_data):
    """Fused Pallas panel passes under shard_map (per-device local blocks,
    interpret mode on CPU): sharded+kernel == single-device+kernel ==
    single-device XLA schedule."""
    R, T = small_data
    W0, H0 = init_factors_np(K, R.rows, R.cols, seed=0)
    base = dict(k=K, maxiter=3, maxinneriter=2, lambda_=0.1,
                backend="hybrid", hybrid_dense_cells=100 * R.cols,
                hybrid_panel_widths=(32, 16), mask_dtype="nan")
    Wx, Hx, _ = ccd_hybrid_train(R, W0.copy(), H0.copy(), T,
                                 Config(**base))
    cfg = Config(hybrid_panel_kernel=True, **base)
    W1, H1, s1 = ccd_hybrid_train(R, W0.copy(), H0.copy(), T, cfg)
    W8, H8, s8 = ccd_hybrid_train_sharded(R, W0.copy(), H0.copy(), T, cfg,
                                          make_mesh())
    np.testing.assert_allclose(W1, Wx, atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(W1, W8, atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(H1, H8, atol=2e-5, rtol=1e-4)
    for a, b in zip(s1, s8):
        assert abs(a.rmse - b.rmse) < 1e-5


def test_sharded_hybrid_through_trainer(small_data):
    from cuda_recommender_tpu.core.trainer import train
    R, T = small_data
    cfg = Config(k=4, maxiter=2, lambda_=0.1, backend="hybrid",
                 hybrid_dense_cells=80 * R.cols, hybrid_panel_widths=(32,))
    res_m = train(cfg, R, T, mesh=make_mesh())
    res_1 = train(cfg, R, T)
    np.testing.assert_allclose(res_m.W, res_1.W, atol=2e-5, rtol=1e-4)
    assert res_m.backend == "hybrid"


def test_auto_resolves_hybrid_for_large():
    cfg = Config(backend="auto", dense_max_cells=1000)
    assert cfg.resolve_backend(1000, 1000) == Backend.HYBRID


def test_sharded_hybrid_resume(small_data, tmp_path):
    from cuda_recommender_tpu.core.trainer import train
    R, T = small_data
    base = dict(k=4, lambda_=0.1, backend="hybrid",
                hybrid_dense_cells=80 * R.cols, hybrid_panel_widths=(32,))
    mesh = make_mesh()
    full = train(Config(maxiter=4, **base), R, T, mesh=mesh)
    ck = str(tmp_path / "ck")
    train(Config(maxiter=2, checkpoint_dir=ck, checkpoint_every=1, **base),
          R, T, mesh=mesh)
    resumed = train(Config(maxiter=4, checkpoint_dir=ck, checkpoint_every=1,
                           **base), R, T, mesh=mesh,
                    resume_from_checkpoint=True)
    np.testing.assert_allclose(full.W, resumed.W, atol=1e-6)


def test_sharded_hybrid_phase_fns_match_and_emit_line(small_data, capsys):
    """Sharded phase-split telemetry: the per-phase
    shard_map dispatches (make_sharded_hybrid_phase_fns) reproduce the
    fused single-device hybrid result on the 8-virtual-device CPU mesh, and
    the iteration line carries measured NONZERO rank/update times from the
    fenced multi-device phases — the reference's rank_time/update_time
    split (src/CCD.cpp:158) for the multi-chip path."""

    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from cuda_recommender_tpu.core.metrics_log import MetricsLog
    from cuda_recommender_tpu.parallel.ccd_hybrid_sharded import (
        make_sharded_hybrid_phase_fns)
    from cuda_recommender_tpu.parallel.mesh import AXIS
    from cuda_recommender_tpu.solvers.ccd_hybrid import (
        densify_panels, plan_hybrid)
    from cuda_recommender_tpu.solvers.phase_loop import phased_ccd_loop

    R, T = small_data
    W0, H0 = init_factors_np(K, R.rows, R.cols, seed=0)
    cfg = Config(k=K, maxiter=2, maxinneriter=1, lambda_=0.1,
                 backend="hybrid", hybrid_dense_cells=100 * R.cols,
                 hybrid_panel_widths=(32, 16))
    Wref, Href, sref = ccd_hybrid_train(R, W0.copy(), H0.copy(), T, cfg)

    mesh = make_mesh()
    N = mesh.devices.size
    plan = plan_hybrid(R, cfg, num_shards=N, materialize_dense=False)
    rows_g, cols_g = plan.ell.rows_side, plan.ell.cols_side
    shard = NamedSharding(mesh, P(AXIS, None))
    svec = NamedSharding(mesh, P(AXIS))
    rep = NamedSharding(mesh, P())
    idx_r = tuple(jax.device_put(b.idx, shard) for b in rows_g.buckets)
    idx_c = tuple(jax.device_put(b.idx, shard) for b in cols_g.buckets)
    Rds, masks = densify_panels(plan, jnp.float32, sharding=shard,
                                mask_dtype=cfg.mask_dtype)
    W = jax.device_put(np.asarray(W0, np.float32)[:, plan.user_order], rep)
    H = jax.device_put(np.zeros((K, R.cols), np.float32), rep)
    vals_r = tuple(jax.device_put(b.val, shard) for b in rows_g.buckets)
    vals_c = tuple(jax.device_put(b.val, shard) for b in cols_g.buckets)
    row_nnz = jax.device_put(plan.row_nnz, rep)
    col_nnz = jax.device_put(plan.col_nnz, rep)
    eosr = jax.device_put(plan.upos_of_slot_safe, svec)
    eosi = jax.device_put(plan.ipos_of_slot_safe, svec)

    def local_map(slot_of_pos, slots_per_shard, n_ent):
        out = np.full((N, n_ent), slots_per_shard, np.int32)
        owner = slot_of_pos // slots_per_shard
        local = slot_of_pos % slots_per_shard
        out[owner, np.arange(n_ent)] = local
        return out

    lsu = jax.device_put(local_map(plan.slot_of_upos.astype(np.int64),
                                   rows_g.slots_per_shard, R.rows), shard)
    lsi = jax.device_put(local_map(plan.slot_of_ipos.astype(np.int64),
                                   cols_g.slots_per_shard, R.cols), shard)

    addback, sweeps, subtract = make_sharded_hybrid_phase_fns(
        plan, mesh, cfg.lambda_, maxinneriter=1,
        nan_mask=cfg.mask_dtype == "nan")

    box = {"s": (Rds, vals_r, vals_c, W, H)}

    def _ab(t):
        Rds, vals_r, vals_c, W, H = box["s"]
        Rds, vals_r, vals_c = addback(idx_r, idx_c, Rds, masks, vals_r,
                                      vals_c, W, H, t, eosr, eosi)
        box["s"] = (Rds, vals_r, vals_c, W, H)
        return Rds[0] if Rds else vals_r[0]

    def _sw(t):
        Rds, vals_r, vals_c, W, H = box["s"]
        W, H = sweeps(idx_r, idx_c, Rds, masks, vals_r, vals_c, W, H, t,
                      row_nnz, col_nnz, lsu, lsi)
        box["s"] = (Rds, vals_r, vals_c, W, H)
        return W

    def _sub(t):
        Rds, vals_r, vals_c, W, H = box["s"]
        Rds, vals_r, vals_c = subtract(idx_r, idx_c, Rds, masks, vals_r,
                                       vals_c, W, H, t, eosr, eosi)
        box["s"] = (Rds, vals_r, vals_c, W, H)
        return Rds[0] if Rds else vals_r[0]

    def do_rmse():
        from cuda_recommender_tpu.eval.metrics import calrmse_np
        _, _, _, W, H = box["s"]
        return calrmse_np(T, np.asarray(W)[:, plan.user_pos],
                          np.asarray(H)[:, plan.item_pos],
                          entity_major=False)

    log = MetricsLog()
    acc = {"rank": 0.0, "upd": 0.0}

    def cb(st):
        acc["rank"] += st.rank_time
        acc["upd"] += st.update_time
        log.iteration("ccd", "hybrid-sharded", st.oiter, st.rmse,
                      st.rank_time, acc["rank"], st.update_time, acc["upd"])

    stats = phased_ccd_loop(
        start_oiter=1, maxiter=cfg.maxiter, k=K, addback=_ab, sweeps=_sw,
        subtract=_sub, do_rmse=do_rmse,
        get_rank_rows=lambda t: (None, None),
        ti=None, tj=None, tv=None, callback=cb)

    _, _, _, W, H = box["s"]
    W_ent = np.asarray(W)[:, plan.user_pos]
    H_ent = np.asarray(H)[:, plan.item_pos]
    np.testing.assert_allclose(W_ent, Wref, atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(H_ent, Href, atol=2e-5, rtol=1e-4)
    for a, b in zip(stats, sref):
        assert abs(a.rmse - b.rmse) < 1e-5
    # measured, nonzero phase split on the mesh; line format parity
    assert all(s.rank_time > 0 for s in stats)
    assert stats[-1].update_time > 0          # oiter 2 has addback+subtract
    out = capsys.readouterr().out
    assert "[-INFO-]" in out and "rank_time" in out and "update_time" in out
