"""Training driver: backend selection, dual-run golden validation, telemetry.

The orchestration counterpart of the reference's main()
(/root/reference/src/main.cpp:38-173): pick solver (CCD default, ALS flag),
initialize identically-seeded factor copies per enabled backend, run the
compiled backend (the reference's CUDA role) and optionally the NumPy
golden backend (the OMP role), compute an independent final RMSE per backend
(calculate_rmse_directly, src/extras.cpp:182-216), then cross-validate with
golden_compare (src/main.cpp:133-144) and report phase timings.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np

from ..data.sparse import RatingMatrix, TestCOO
from ..eval.metrics import GoldenResult, calrmse_np, golden_compare
from .checkpoint import Checkpointer
from .config import Backend, Config, Solver
from .init import init_factors_np
from .metrics_log import MetricsLog


@dataclasses.dataclass
class TrainResult:
    W: np.ndarray
    H: np.ndarray
    stats: list
    entity_major: bool
    backend: str
    final_rmse: float
    train_time: float
    ref_stats: Optional[list] = None
    ref_final_rmse: Optional[float] = None
    golden_W: Optional[GoldenResult] = None
    golden_H: Optional[GoldenResult] = None
    validate_time: float = 0.0


def _run_compiled(cfg: Config, backend: Backend, R, W0, H0, T, log,
                  mesh=None, ckpt=None, resume=None):
    from ..solvers.als_ell import als_ell_train
    from ..solvers.ccd_dense import ccd_dense_train
    from ..solvers.ccd_ell import ccd_ell_train

    acc = {"rank": 0.0, "upd": 0.0}

    def cb(st):
        if cfg.solver == Solver.ALS:
            # ALS emits one wall time per iteration; the reference prints it
            # under the update_time label (src/ALS.cpp:224-229).
            acc["upd"] += st.rank_time
            log.iteration(cfg.solver.value, backend.value, st.oiter, st.rmse,
                          0.0, 0.0, st.rank_time, acc["upd"],
                          rmse_time=getattr(st, "rmse_time", None))
            return
        acc["rank"] += st.rank_time
        acc["upd"] += st.update_time
        log.iteration(cfg.solver.value, backend.value, st.oiter, st.rmse,
                      st.rank_time, acc["rank"], st.update_time, acc["upd"],
                      rmse_time=getattr(st, "rmse_time", None))

    if backend == Backend.REF:
        # the NumPy golden solver requested explicitly as the main backend
        W, H, stats = _run_reference(cfg, R, W0, H0, T, log)
        return W, H, stats

    kw: dict = dict(callback=cb)
    if cfg.phase_timing and cfg.solver == Solver.ALS:
        raise NotImplementedError(
            "phase_timing is a CCD telemetry mode (the reference splits CCD "
            "iterations into rank/update phases, src/CCD.cpp:76-139; its ALS "
            "prints one per-iteration time, which the normal loop already "
            "measures)")
    if cfg.phase_timing and cfg.solver == Solver.CCD:
        if mesh is not None:
            raise NotImplementedError(
                "phase_timing is single-device in the trainer loop; the "
                "sharded hybrid path has per-phase shard_map dispatches "
                "(parallel.ccd_hybrid_sharded.make_sharded_hybrid_phase_"
                "fns, exercised with measured rank/update times on a "
                "2+-device mesh by tests/test_hybrid_sharded.py)")
        if cfg.verbose:
            kw["rank_callback"] = (
                lambda oiter, t, dt, rmse: log.rank(
                    cfg.solver.value, backend.value, oiter, t, dt, rmse))
    if ckpt is not None:
        meta = checkpoint_meta(cfg, backend, mesh)
        kw.update(ckpt_every=cfg.checkpoint_every,
                  ckpt_fn=lambda oiter, payload: ckpt.save(
                      oiter, W=payload.pop("W"), H=payload.pop("H"),
                      solver=cfg.solver.value, backend=backend.value,
                      extra=payload, meta=meta))
    if resume is not None:
        kw.update(resume=resume)

    if cfg.solver == Solver.ALS:
        if mesh is not None:
            from ..parallel.als_ell_sharded import als_ell_train_sharded
            return als_ell_train_sharded(R, W0, H0, T, cfg, mesh, **kw)
        return als_ell_train(R, W0, H0, T, cfg, **kw)
    if backend == Backend.HYBRID:
        if mesh is not None:
            if cfg.hybrid_transpose:
                raise NotImplementedError(
                    "hybrid_transpose is single-device-only (the sharded "
                    "hybrid plans the classic user-axis stair)")
            from ..parallel.ccd_hybrid_sharded import ccd_hybrid_train_sharded
            return ccd_hybrid_train_sharded(R, W0, H0, T, cfg, mesh, **kw)
        from ..solvers.ccd_hybrid import ccd_hybrid_train
        return ccd_hybrid_train(R, W0, H0, T, cfg, **kw)
    if backend == Backend.DENSE:
        if mesh is not None:
            from ..parallel.mesh import (dense_ccd_shardings,
                                         dense_ccd_shardings_2d)
            kw["shardings"] = (dense_ccd_shardings_2d(mesh)
                               if mesh.devices.ndim == 2
                               else dense_ccd_shardings(mesh))
        return ccd_dense_train(R, W0, H0, T, cfg, **kw)
    if mesh is not None:
        from ..parallel.ccd_ell_sharded import ccd_ell_train_sharded
        return ccd_ell_train_sharded(R, W0, H0, T, cfg, mesh, **kw)
    return ccd_ell_train(R, W0, H0, T, cfg, **kw)


def checkpoint_meta(cfg: Config, backend: Backend, mesh) -> dict:
    """Layout-determining knobs stamped into the checkpoint manifest,
    per backend: ELL/hybrid payloads are slot-/panel-space, so resuming
    under a different k / shard count / bucket-width / panel plan would map
    them onto a different layout — a shape error at best, silently wrong
    factors when shapes coincide. Only knobs the backend's payload actually
    depends on are stamped (a dense resume must not be rejected for an
    irrelevant ELL knob)."""
    meta: dict = {
        # slot-layout algorithm version: 2 = data-driven width ladder
        # (data/ell.py _choose_widths); bumping invalidates older slot-space
        # checkpoints loudly instead of remapping them silently wrong
        "ell_layout": 2,
        "k": cfg.k,
        "num_shards": int(mesh.devices.size) if mesh is not None else 1,
    }
    if cfg.solver == Solver.ALS:
        meta["min_width"] = cfg.als_min_width
    elif backend in (Backend.ELL, Backend.HYBRID):
        meta["min_width"] = cfg.ell_min_width
    if backend == Backend.HYBRID:
        meta["hybrid_dense_cells"] = cfg.hybrid_dense_cells
        meta["hybrid_panel_widths"] = list(cfg.hybrid_panel_widths)
    return meta


def _run_reference(cfg: Config, R, W0, H0, T, log):
    from ..solvers.reference import als_reference, ccd_reference

    acc = {"rank": 0.0, "upd": 0.0}

    def cb(st):
        acc["rank"] += st.rank_time
        acc["upd"] += st.update_time
        log.iteration(cfg.solver.value, "ref", st.oiter, st.rmse,
                      st.rank_time, acc["rank"], st.update_time, acc["upd"],
                      rmse_time=getattr(st, "rmse_time", None))

    W, H = W0.copy(), H0.copy()
    if cfg.solver == Solver.ALS:
        stats = als_reference(R, W, H, T, lambda_=cfg.lambda_,
                              maxiter=cfg.maxiter, callback=cb,
                              early_stop_eps=cfg.eps if cfg.early_stop else 0.0)
    else:
        stats = ccd_reference(R, W, H, T, lambda_=cfg.lambda_,
                              maxiter=cfg.maxiter, nmf=cfg.do_nmf,
                              maxinneriter=cfg.maxinneriter, callback=cb,
                              early_stop_eps=cfg.eps if cfg.early_stop else 0.0)
    return W, H, stats


def train(cfg: Config, R: RatingMatrix, T: TestCOO, *,
          mesh=None, log: Optional[MetricsLog] = None,
          resume_from_checkpoint: bool = False) -> TrainResult:
    """Full training run with optional golden validation (cfg.golden) and
    checkpoint/resume (cfg.checkpoint_dir / resume_from_checkpoint)."""
    log = log or MetricsLog(cfg.metrics_file)
    entity_major = cfg.solver == Solver.ALS
    backend = cfg.resolve_backend(R.rows, R.cols)
    log.info(f"[info] Picked Version: {cfg.solver.value.upper()}!")
    log.info("[info] Backend = %s | K = %d | InnerIter = %d | OuterIter = %d "
             "| L = %.3f" % (backend.value, cfg.k, cfg.maxinneriter,
                             cfg.maxiter, cfg.lambda_))

    # identical init for every backend copy — the reference's srand(0)
    # discipline that makes golden_compare meaningful (src/main.cpp:86-98)
    W0, H0 = init_factors_np(cfg.k, R.rows, R.cols, seed=cfg.seed,
                             entity_major=entity_major)

    ckpt = Checkpointer(cfg.checkpoint_dir) if cfg.checkpoint_dir else None
    resume = None
    if resume_from_checkpoint:
        if ckpt is None:
            raise ValueError("resume requested but no checkpoint_dir set")
        latest = ckpt.latest()
        if latest is not None:
            if (latest.get("solver") and latest["solver"] != cfg.solver.value) \
                    or (latest.get("backend")
                        and latest["backend"] != backend.value):
                raise ValueError(
                    f"checkpoint was written by solver="
                    f"{latest.get('solver')} backend={latest.get('backend')} "
                    f"but this run is solver={cfg.solver.value} "
                    f"backend={backend.value} — payloads are incompatible")
            want = checkpoint_meta(cfg, backend, mesh)
            have = latest.get("meta") or {}
            bad = {key: (have[key], want[key]) for key in want
                   if key in have and have[key] != want[key]}
            if bad:
                raise ValueError(
                    "checkpoint layout mismatch (slot-space payloads are only "
                    "valid under the writing run's layout knobs): "
                    + ", ".join(f"{key}: checkpoint={a} run={b}"
                                for key, (a, b) in bad.items()))
            resume = {"oiter": latest["oiter"], "W": latest["W"],
                      "H": latest["H"], **latest["extra"]}
            log.info(f"[info] resuming from checkpoint oiter={latest['oiter']}")

    log.info(f"[INFO] Computing with {backend.value} backend...")
    t0 = time.perf_counter()
    W, H, stats = _run_compiled(cfg, backend, R, W0.copy(), H0.copy(), T, log,
                                mesh=mesh, ckpt=ckpt, resume=resume)
    train_time = time.perf_counter() - t0
    log.info("[info] %s Training time: %f s." % (backend.value, train_time))
    t0 = time.perf_counter()
    final_rmse = calrmse_np(T, W, H, entity_major=entity_major)
    log.info("Test RMSE = %f. Calculated in %fs"
             % (final_rmse, time.perf_counter() - t0))

    result = TrainResult(W=W, H=H, stats=stats, entity_major=entity_major,
                         backend=backend.value, final_rmse=final_rmse,
                         train_time=train_time)

    if cfg.golden:
        log.info("[INFO] Computing with reference (golden) backend...")
        t0 = time.perf_counter()
        if (backend == Backend.HYBRID and cfg.solver == Solver.CCD
                and cfg.hybrid_transpose and mesh is None):
            # transposed stair: the compiled run solved R^T with the item
            # side seeded — golden parity is against the reference on the
            # SAME transposed problem (solvers/ccd_hybrid.py docstring)
            from ..data.sparse import make_test
            from ..solvers.ccd_hybrid import resolve_hybrid_transpose
            if resolve_hybrid_transpose(R, cfg):
                Tt = make_test(T.cols, T.rows, T.col_idx, T.row_idx, T.val)
                Wt, Ht, ref_stats = _run_reference(
                    cfg, R.transpose(), H0, W0, Tt, log)
                W_ref, H_ref = Ht, Wt
            else:
                W_ref, H_ref, ref_stats = _run_reference(cfg, R, W0, H0, T,
                                                         log)
        else:
            W_ref, H_ref, ref_stats = _run_reference(cfg, R, W0, H0, T, log)
        log.info("[info] ref Training time: %f s." % (time.perf_counter() - t0))
        result.ref_stats = ref_stats
        result.ref_final_rmse = calrmse_np(T, W_ref, H_ref,
                                           entity_major=entity_major)
        log.info("Test RMSE = %f." % result.ref_final_rmse)
        log.info("[info] validate the results.")
        t0 = time.perf_counter()
        result.golden_W = golden_compare(W, W_ref)
        result.golden_H = golden_compare(H, H_ref)
        result.validate_time = time.perf_counter() - t0
        log.info(result.golden_W.message())
        log.info(result.golden_H.message())
        log.info("[info] Validate Time: %f s." % result.validate_time)
        log.event("golden", W_pass=result.golden_W.passed,
                  H_pass=result.golden_H.passed,
                  W_err_pct=result.golden_W.error_percentage,
                  H_err_pct=result.golden_H.error_percentage)
    return result
