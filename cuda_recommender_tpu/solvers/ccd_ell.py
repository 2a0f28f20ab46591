"""CCD++ — compiled padded-ELL backend (XLA, general sparse path).

The counterpart of the reference's CUDA CCD++ kernels
(/root/reference/cuda_src/CCD_CUDA.cu:3-104) for matrices whose dense residual
would not fit device memory. Ratings live in the degree-bucketed lane-packed ELL layout
(data/ell.py) in BOTH orientations, mirroring the reference's dual R/Rt
residual storage (cuda_src/CCD_CUDA.cu:300-316); factors live in slot space
for the whole run so the hot loop has zero scatters.

Gather budget: per rank at maxinneriter=1 this does ~2.3 nnz-sized gather-equivalents instead of a
naive 6:
  * **cols side — ONE stacked row-gather per rank.** The subtract of rank
    t-1's new outer product is DEFERRED (carried as ``(u_pend, v_pend)``
    state, exactly like the dense backend's schedule) and folded into rank
    t's pass: gather the 2-wide stacked table ``[u_pend, u_old]`` once, apply
    ``- u_pend⊗v_pend + u_old⊗v_old`` to the residual tiles, and reuse the
    ``u_old`` column for the v-sweep reduction.
  * **rows side — ONE stacked row-gather per rank**: ``[v_old, v_new]``
    serves the add-back and the u-sweep, and the sweep's gather is reused by
    the immediate rows-side subtract.
(one gather of a 2-wide table fetches both columns of a row.) The add-back runs unconditionally: in outer iteration
1 ``H[t]`` is still 0, so the term vanishes identically and one compiled
step covers all iterations (the reference's ``oiter > 1`` gate at
src/CCD.cpp:100 is an optimization, not semantics).

Semantics preserved (SURVEY.md §7): H zeroed at entry (src/CCD.cpp:56-60);
λ·nnz regularization (src/CCD.cpp:112,120); v-sweep before u-sweep each inner
iteration (src/CCD.cpp:110-121); empty entity -> 0 factor; rank-major factor
layout. ``fused_outer_iters`` groups outer iterations (and their on-device
RMSE) into one dispatch, amortizing host round-trips.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..core.config import Config
from ..data.ell import EllPair, build_ell_pair
from ..data.sparse import RatingMatrix, TestCOO
from ..eval.metrics import calrmse_device, default_eval_chunk
from ..ops.ell_ops import (extend_zero, fused_sweep, fused_update_sweep,
                           residual_update, sweep_new_values)
from .pipeline import pipelined_loop
from .reference import IterStats


def make_ell_outer_step(ell: EllPair, lam: float, maxinneriter: int,
                        jit_compile: bool = True, nmf: bool = False):
    """One outer iteration over all k ranks (lax.fori_loop)."""
    rows, cols = ell.rows_side, ell.cols_side
    lam_ = jnp.float32(lam)

    def step(idx_r, idx_c, vals_r, vals_c, W, H, rnnz_r, rnnz_c,
             u_pend, v_pend):
        def new_from(g, h, rnnz):
            out = jnp.where(rnnz > 0, g / (lam_ * rnnz + h), 0.0)
            return jnp.maximum(out, 0.0) if nmf else out

        def rank_body(t, carry):
            vals_r, vals_c, W, H, u_pend, v_pend = carry
            u_old = jax.lax.dynamic_slice_in_dim(W, t, 1, 0)[0]
            v_old = jax.lax.dynamic_slice_in_dim(H, t, 1, 0)[0]
            u, v = u_old, v_old
            for i in range(maxinneriter):
                # ---- v-sweep (cols side): deferred subtract + add-back +
                # sweep, all inside ONE fused pass off a stacked
                # [u_pend, u_old] row-gather (a gathered tile fed to >1
                # consumer re-runs the gather per consumer) ----
                if i == 0:
                    vals_c, g, h = fused_update_sweep(
                        idx_c, vals_c, cols,
                        extend_zero(jnp.stack([u_pend, u_old], axis=-1)),
                        owns=(v_pend, v_old), signs=(-1.0, 1.0), sweep_col=1)
                else:
                    g, h = fused_sweep(idx_c, vals_c, cols,
                                       extend_zero(jnp.stack([u, u], -1)))
                v = new_from(g, h, rnnz_c)
                # ---- u-sweep (rows side): 3-wide [v_pend, v_old, v_new]
                # table (same row-mode price as a pair) — deferred subtract,
                # add-back, and sweep with the NEW v in one pass; the rank-t
                # subtract is itself deferred via (u_pend, v_pend) ----
                if i == 0:
                    vals_r, gu, hu = fused_update_sweep(
                        idx_r, vals_r, rows,
                        extend_zero(jnp.stack([v_pend, v_old, v], axis=-1)),
                        owns=(u_pend, u_old), signs=(-1.0, 1.0), sweep_col=2)
                else:
                    gu, hu = fused_sweep(idx_r, vals_r, rows,
                                         extend_zero(jnp.stack([v, v], -1)))
                u = new_from(gu, hu, rnnz_r)
            # ---- write back (src/CCD.cpp:128-134); EVERY side's subtract
            # of rank t's new outer product deferred to rank t+1 ----
            W = jax.lax.dynamic_update_slice_in_dim(W, u[None], t, 0)
            H = jax.lax.dynamic_update_slice_in_dim(H, v[None], t, 0)
            return (vals_r, vals_c, W, H, u, v)

        k = W.shape[0]
        return jax.lax.fori_loop(
            0, k, rank_body, (vals_r, vals_c, W, H, u_pend, v_pend))

    if not jit_compile:
        return step
    return jax.jit(step, donate_argnums=(2, 3, 4, 5, 8, 9))


def make_ell_phase_fns(ell: EllPair, lam: float, maxinneriter: int,
                       nmf: bool = False):
    """Phase-split step functions for the phase-timing mode (phase_loop.py):
    plain reference schedule (add-back / sweeps / immediate subtract,
    src/CCD.cpp:74-139) with separate fence-able dispatches per phase — same
    math as make_ell_outer_step's gather-fused schedule, without the pend
    state. Rank ``t`` is traced: one compiled program per phase."""
    rows, cols = ell.rows_side, ell.cols_side
    lam_ = jnp.float32(lam)

    def _both_sides(idx_r, idx_c, vals_r, vals_c, W, H, t, sign):
        u = jax.lax.dynamic_slice_in_dim(W, t, 1, 0)[0]
        v = jax.lax.dynamic_slice_in_dim(H, t, 1, 0)[0]
        vals_c = residual_update(idx_c, vals_c, cols, extend_zero(u), v, sign)
        vals_r = residual_update(idx_r, vals_r, rows, extend_zero(v), u, sign)
        return vals_r, vals_c

    @functools.partial(jax.jit, donate_argnums=(2, 3))
    def addback(idx_r, idx_c, vals_r, vals_c, W, H, t):
        return _both_sides(idx_r, idx_c, vals_r, vals_c, W, H, t, 1.0)

    @functools.partial(jax.jit, donate_argnums=(2, 3))
    def subtract(idx_r, idx_c, vals_r, vals_c, W, H, t):
        return _both_sides(idx_r, idx_c, vals_r, vals_c, W, H, t, -1.0)

    @functools.partial(jax.jit, donate_argnums=(4, 5))
    def sweeps(idx_r, idx_c, vals_r, vals_c, W, H, rnnz_r, rnnz_c, t):
        u = jax.lax.dynamic_slice_in_dim(W, t, 1, 0)[0]
        v = jax.lax.dynamic_slice_in_dim(H, t, 1, 0)[0]
        for _ in range(maxinneriter):          # src/CCD.cpp:107-123
            v, _ = sweep_new_values(idx_c, vals_c, cols, extend_zero(u),
                                    lam_, rnnz_c, nmf=nmf)
            u, _ = sweep_new_values(idx_r, vals_r, rows, extend_zero(v),
                                    lam_, rnnz_r, nmf=nmf)
        W = jax.lax.dynamic_update_slice_in_dim(W, u[None], t, 0)
        H = jax.lax.dynamic_update_slice_in_dim(H, v[None], t, 0)
        return W, H

    return addback, sweeps, subtract


def factors_to_slots(F: np.ndarray, side) -> np.ndarray:
    """(k, n_entities) entity order -> (k, n_slots) slot space."""
    out = np.zeros((F.shape[0], side.n_slots), dtype=np.float32)
    out[:, side.slot_of_entity] = F
    return out


def ccd_ell_train(R: RatingMatrix, W0: np.ndarray, H0: np.ndarray,
                  T: TestCOO, cfg: Config, *,
                  callback: Optional[Callable[[IterStats], None]] = None,
                  ell: Optional[EllPair] = None,
                  ckpt_every: int = 0, ckpt_fn=None, resume=None,
                  rank_callback=None,
                  ) -> tuple[np.ndarray, np.ndarray, list[IterStats]]:
    """Train CCD++ on the ELL backend (single device). Returns (W, H, stats)
    in the reference's rank-major entity order. Checkpoint payloads carry the
    slot-space factors plus both residual bucket value sets (CCD++'s residual
    is training state, src/CCD.cpp:100-134)."""
    if ell is None:
        ell = build_ell_pair(R, min_width=cfg.ell_min_width, num_shards=1)
    rows, cols = ell.rows_side, ell.cols_side

    idx_r = tuple(jnp.asarray(b.idx) for b in rows.buckets)
    idx_c = tuple(jnp.asarray(b.idx) for b in cols.buckets)
    start_oiter = 1
    if resume is not None:
        start_oiter = int(resume["oiter"]) + 1
        vals_r = tuple(jnp.asarray(resume[f"vals_r_{i}"])
                       for i in range(len(rows.buckets)))
        vals_c = tuple(jnp.asarray(resume[f"vals_c_{i}"])
                       for i in range(len(cols.buckets)))
        W = jnp.asarray(resume["W"])
        H = jnp.asarray(resume["H"])
        u_pend = jnp.asarray(resume["u_pend"])
        v_pend = jnp.asarray(resume["v_pend"])
    else:
        vals_r = tuple(jnp.asarray(b.val) for b in rows.buckets)
        vals_c = tuple(jnp.asarray(b.val) for b in cols.buckets)
        W = jnp.asarray(factors_to_slots(np.asarray(W0, np.float32), rows))
        H = jnp.zeros((H0.shape[0], cols.n_slots), jnp.float32)  # src/CCD.cpp:56-60
        u_pend = jnp.zeros(rows.n_slots, jnp.float32)
        v_pend = jnp.zeros(cols.n_slots, jnp.float32)
    rnnz_r = jnp.asarray(rows.slot_nnz)
    rnnz_c = jnp.asarray(cols.slot_nnz)

    ti = jnp.asarray(rows.slot_of_entity[T.row_idx])
    tj = jnp.asarray(cols.slot_of_entity[T.col_idx])
    tv = jnp.asarray(T.val)

    rmse_fn = jax.jit(functools.partial(
        calrmse_device, entity_major=False,
        chunk=default_eval_chunk(T.nnz, cfg.eval_chunk)))

    box = {"s": (vals_r, vals_c, W, H, u_pend, v_pend)}

    def get_payload():
        vals_r, vals_c, W, H, u_pend, v_pend = box["s"]
        payload = {"W": np.asarray(W), "H": np.asarray(H),
                   "u_pend": np.asarray(u_pend),
                   "v_pend": np.asarray(v_pend)}
        for i, v_ in enumerate(vals_r):
            payload[f"vals_r_{i}"] = np.asarray(v_)
        for i, v_ in enumerate(vals_c):
            payload[f"vals_c_{i}"] = np.asarray(v_)
        return payload

    if cfg.phase_timing:
        if resume is not None and (np.asarray(resume["u_pend"]).any()
                                   or np.asarray(resume["v_pend"]).any()):
            raise ValueError("cannot resume a fused-schedule checkpoint "
                             "(pending outer product) in phase-timing mode")
        ab, sw, sub = make_ell_phase_fns(ell, cfg.lambda_, cfg.maxinneriter,
                                         nmf=cfg.do_nmf)

        def _ab(t):
            vals_r, vals_c, W, H, up, vp = box["s"]
            vals_r, vals_c = ab(idx_r, idx_c, vals_r, vals_c, W, H, t)
            box["s"] = (vals_r, vals_c, W, H, up, vp)
            return vals_r

        def _sw(t):
            vals_r, vals_c, W, H, up, vp = box["s"]
            W, H = sw(idx_r, idx_c, vals_r, vals_c, W, H, rnnz_r, rnnz_c, t)
            box["s"] = (vals_r, vals_c, W, H, up, vp)
            return W

        def _sub(t):
            vals_r, vals_c, W, H, up, vp = box["s"]
            vals_r, vals_c = sub(idx_r, idx_c, vals_r, vals_c, W, H, t)
            box["s"] = (vals_r, vals_c, W, H, up, vp)
            return vals_r

        def get_rank_rows(t):
            _, _, W, H, _, _ = box["s"]
            return np.asarray(W[t]), np.asarray(H[t])

        def do_rmse_p():
            _, _, W, H, _, _ = box["s"]
            return rmse_fn(ti, tj, tv, W, H)

        from .phase_loop import phased_ccd_loop
        stats = phased_ccd_loop(
            start_oiter=start_oiter, maxiter=cfg.maxiter, k=W0.shape[0],
            addback=_ab, sweeps=_sw, subtract=_sub, do_rmse=do_rmse_p,
            get_rank_rows=get_rank_rows,
            ti=rows.slot_of_entity[T.row_idx],
            tj=cols.slot_of_entity[T.col_idx], tv=np.asarray(T.val),
            callback=callback, rank_callback=rank_callback,
            ckpt_every=ckpt_every, ckpt_fn=ckpt_fn,
            get_payload=get_payload,
        early_stop_eps=cfg.eps if cfg.early_stop else 0.0)
        _, _, W, H, _, _ = box["s"]
        W_ent = np.asarray(W)[:, rows.slot_of_entity]
        H_ent = np.asarray(H)[:, cols.slot_of_entity]
        return W_ent, H_ent, stats

    step_fn = make_ell_outer_step(ell, cfg.lambda_, cfg.maxinneriter,
                                  nmf=cfg.do_nmf)

    def do_step():
        vals_r, vals_c, W, H, u_pend, v_pend = box["s"]
        box["s"] = step_fn(idx_r, idx_c, vals_r, vals_c, W, H,
                           rnnz_r, rnnz_c, u_pend, v_pend)
        return box["s"][2]

    def do_rmse():
        _, _, W, H, _, _ = box["s"]
        return rmse_fn(ti, tj, tv, W, H)

    stats = pipelined_loop(
        start_oiter=start_oiter, maxiter=cfg.maxiter,
        fuse=cfg.fused_outer_iters, do_step=do_step, do_rmse=do_rmse,
        callback=callback, ckpt_every=ckpt_every, ckpt_fn=ckpt_fn,
        get_payload=get_payload,
        early_stop_eps=cfg.eps if cfg.early_stop else 0.0)

    _, _, W, H, _, _ = box["s"]
    W_ent = np.asarray(W)[:, rows.slot_of_entity]
    H_ent = np.asarray(H)[:, cols.slot_of_entity]
    return W_ent, H_ent, stats
