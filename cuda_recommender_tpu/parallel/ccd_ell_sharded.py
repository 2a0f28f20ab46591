"""CCD++ ELL backend, sharded over a 1-D device mesh with shard_map.

Decomposition (new design — the reference has no multi-device story,
SURVEY.md §2): both ELL orientations are built with ``num_shards = N`` so
every bucket's physical rows are dealt round-robin across devices
(degree-balanced) and padded shard-uniform; global slot order is shard-major,
so each device's factor slots are one contiguous block and
``jax.lax.all_gather(..., tiled=True)`` reassembles the global table as a
plain concat. Per rank sweep:

  * the swept side's updates are local to each shard (its slot block);
  * the opposite-side vector is all-gathered (the only communication,
    2-3 gathers of (n_slots,) floats per rank);
  * residual bucket tiles are updated locally — never communicated.

The per-shard kernel body is byte-identical math to the single-device solver
(solvers/ccd_ell.py), reusing ops/ell_ops on each side's ``local_view()``.
"""

from __future__ import annotations

import functools
import time
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..core.config import Config
from ..data.ell import EllPair, build_ell_pair
from ..data.sparse import RatingMatrix, TestCOO
from ..eval.metrics import calrmse_device, default_eval_chunk
from ..ops.ell_ops import (extend_zero, fused_sweep, fused_update_sweep)
from ..solvers.pipeline import early_stopped
from ..solvers.reference import IterStats
from .mesh import AXIS, ell_shardings


def make_sharded_ell_step(ell: EllPair, mesh: Mesh, lam: float,
                          maxinneriter: int, axis: str = AXIS,
                          nmf: bool = False):
    rows, cols = ell.rows_side.local_view(), ell.cols_side.local_view()
    lam_ = jnp.float32(lam)

    def gather_stack(vecs):
        """Local slot blocks -> stacked global slot table (+ zero row)."""
        return extend_zero(jax.lax.all_gather(
            jnp.stack(list(vecs), axis=-1), axis, axis=0, tiled=True))

    def step_local(idx_r, idx_c, vals_r, vals_c, W, H, nnz_r, nnz_c,
                   u_pend, v_pend):
        def new_from(g, h, nnz):
            out = jnp.where(nnz > 0, g / (lam_ * nnz + h), 0.0)
            return jnp.maximum(out, 0.0) if nmf else out

        def rank_body(t, carry):
            vals_r, vals_c, W, H, u_pend, v_pend = carry
            u_old = jax.lax.dynamic_slice_in_dim(W, t, 1, 0)[0]   # local slots
            v_old = jax.lax.dynamic_slice_in_dim(H, t, 1, 0)[0]
            u, v = u_old, v_old
            for i in range(maxinneriter):
                if i == 0:
                    # deferred cols-side subtract of the previous rank +
                    # add-back + sweep, ALL inside one fused pass off a
                    # stacked all_gather of [u_pend, u_old]
                    # (solvers/ccd_ell.py; a gathered tile fed to >1
                    # consumer re-runs the gather per consumer)
                    vals_c, g, h = fused_update_sweep(
                        idx_c, vals_c, cols, gather_stack((u_pend, u_old)),
                        owns=(v_pend, v_old), signs=(-1.0, 1.0), sweep_col=1)
                else:
                    g, h = fused_sweep(idx_c, vals_c, cols,
                                       gather_stack((u, u)))
                v = new_from(g, h, nnz_c)
                if i == 0:
                    # 3-wide [v_pend, v_old, v_new] table: the rows-side
                    # subtract is deferred via (u_pend, v_pend) too
                    vals_r, gu, hu = fused_update_sweep(
                        idx_r, vals_r, rows, gather_stack((v_pend, v_old, v)),
                        owns=(u_pend, u_old), signs=(-1.0, 1.0), sweep_col=2)
                else:
                    gu, hu = fused_sweep(idx_r, vals_r, rows,
                                         gather_stack((v, v)))
                u = new_from(gu, hu, nnz_r)
            W = jax.lax.dynamic_update_slice_in_dim(W, u[None], t, 0)
            H = jax.lax.dynamic_update_slice_in_dim(H, v[None], t, 0)
            return (vals_r, vals_c, W, H, u, v)

        k = W.shape[0]
        return jax.lax.fori_loop(
            0, k, rank_body, (vals_r, vals_c, W, H, u_pend, v_pend))

    nb_r = len(rows.buckets)
    nb_c = len(cols.buckets)
    bspec = P(axis, None)
    in_specs = (tuple([bspec] * nb_r), tuple([bspec] * nb_c),
                tuple([bspec] * nb_r), tuple([bspec] * nb_c),
                P(None, axis), P(None, axis), P(axis), P(axis),
                P(axis), P(axis))
    out_specs = (tuple([bspec] * nb_r), tuple([bspec] * nb_c),
                 P(None, axis), P(None, axis), P(axis), P(axis))
    fn = jax.shard_map(step_local, mesh=mesh, in_specs=in_specs,
                       out_specs=out_specs, check_vma=False)
    return jax.jit(fn, donate_argnums=(2, 3, 4, 5, 8, 9))


def ccd_ell_train_sharded(R: RatingMatrix, W0: np.ndarray, H0: np.ndarray,
                          T: TestCOO, cfg: Config, mesh: Mesh, *,
                          callback: Optional[Callable[[IterStats], None]] = None,
                          ckpt_every: int = 0, ckpt_fn=None, resume=None,
                          ) -> tuple[np.ndarray, np.ndarray, list[IterStats]]:
    """Multi-device CCD++ training. Factors/stats returned in reference
    rank-major entity order; numerically equivalent to the single-device ELL
    backend (validated by tests/test_sharded.py on an 8-device CPU mesh)."""
    n_dev = mesh.devices.size
    ell = build_ell_pair(R, min_width=cfg.ell_min_width, num_shards=n_dev)
    rows, cols = ell.rows_side, ell.cols_side
    sh = ell_shardings(mesh)

    put_b = functools.partial(jax.device_put, device=sh["bucket"])
    idx_r = tuple(put_b(b.idx) for b in rows.buckets)
    idx_c = tuple(put_b(b.idx) for b in cols.buckets)
    vals_r = tuple(put_b(b.val) for b in rows.buckets)
    vals_c = tuple(put_b(b.val) for b in cols.buckets)

    start_oiter = 1
    if resume is not None:
        start_oiter = int(resume["oiter"]) + 1
        W = jax.device_put(resume["W"], sh["factors_rank_major"])
        H = jax.device_put(resume["H"], sh["factors_rank_major"])
        u_pend = jax.device_put(resume["u_pend"], sh["slots"])
        v_pend = jax.device_put(resume["v_pend"], sh["slots"])
        vals_r = tuple(put_b(resume[f"vals_r_{i}"])
                       for i in range(len(rows.buckets)))
        vals_c = tuple(put_b(resume[f"vals_c_{i}"])
                       for i in range(len(cols.buckets)))
    else:
        W_s = np.zeros((W0.shape[0], rows.n_slots), np.float32)
        W_s[:, rows.slot_of_entity] = np.asarray(W0, np.float32)
        W = jax.device_put(W_s, sh["factors_rank_major"])
        H = jax.device_put(np.zeros((H0.shape[0], cols.n_slots), np.float32),
                           sh["factors_rank_major"])      # src/CCD.cpp:56-60
        u_pend = jax.device_put(np.zeros(rows.n_slots, np.float32), sh["slots"])
        v_pend = jax.device_put(np.zeros(cols.n_slots, np.float32), sh["slots"])
    nnz_r = jax.device_put(rows.slot_nnz, sh["slots"])
    nnz_c = jax.device_put(cols.slot_nnz, sh["slots"])

    rep = sh["rep"]
    ti = jax.device_put(rows.slot_of_entity[T.row_idx], rep)
    tj = jax.device_put(cols.slot_of_entity[T.col_idx], rep)
    tv = jax.device_put(np.asarray(T.val), rep)

    step = make_sharded_ell_step(ell, mesh, cfg.lambda_,
                                 cfg.maxinneriter, nmf=cfg.do_nmf)
    rmse_fn = jax.jit(functools.partial(
        calrmse_device, entity_major=False,
        chunk=default_eval_chunk(T.nnz, cfg.eval_chunk)))

    stats: list[IterStats] = []
    for oiter in range(start_oiter, cfg.maxiter + 1):
        t0 = time.perf_counter()
        vals_r, vals_c, W, H, u_pend, v_pend = step(
            idx_r, idx_c, vals_r, vals_c, W, H, nnz_r, nnz_c, u_pend, v_pend)
        rmse = float(np.asarray(rmse_fn(ti, tj, tv, W, H)))
        st = IterStats(oiter=oiter, rmse=rmse,
                       rank_time=time.perf_counter() - t0)
        stats.append(st)
        if callback:
            callback(st)
        if ckpt_every and ckpt_fn and oiter % ckpt_every == 0:
            payload = {"W": np.asarray(W), "H": np.asarray(H),
                       "u_pend": np.asarray(u_pend),
                       "v_pend": np.asarray(v_pend)}
            for i, v_ in enumerate(vals_r):
                payload[f"vals_r_{i}"] = np.asarray(v_)
            for i, v_ in enumerate(vals_c):
                payload[f"vals_c_{i}"] = np.asarray(v_)
            ckpt_fn(oiter, payload)
        if early_stopped(stats, cfg.eps if cfg.early_stop else 0.0):
            break

    W_ent = np.asarray(W)[:, rows.slot_of_entity]
    H_ent = np.asarray(H)[:, cols.slot_of_entity]
    return W_ent, H_ent, stats
