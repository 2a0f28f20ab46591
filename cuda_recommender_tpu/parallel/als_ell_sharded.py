"""ALS ELL backend sharded over a 1-D device mesh with shard_map.

Each device owns a contiguous slot block of both factor tables and the
matching ELL bucket rows (round-robin degree-balanced, data/ell.py). One ALS
half-iteration all-gathers the OPPOSITE side's factor table
((n_slots, k) floats — the only communication), then assembles grams and
solves the k×k systems entirely locally. Gauss-Seidel across sides is
preserved: the H update all-gathers the freshly computed W
(/root/reference/src/ALS.cpp:98-219 semantics).
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
from ..ops.ell_ops import extend_zero
from ..solvers.als_ell import _solve_side
from ..solvers.pipeline import early_stopped
from ..solvers.reference import IterStats
from .mesh import AXIS, ell_shardings


def make_sharded_als_step(ell: EllPair, mesh: Mesh, lam: float, chunk: int,
                          axis: str = AXIS, solver: str = "lax",
                          precision_name: str = "highest",
                          group_bytes: int | None = None):
    rows, cols = ell.rows_side.local_view(), ell.cols_side.local_view()
    lam_ = jnp.float32(lam)
    prec = (jax.lax.Precision.HIGHEST if precision_name == "highest"
            else jax.lax.Precision.DEFAULT)
    from ..solvers.als_ell import GROUP_TEMP_BYTES
    gb = GROUP_TEMP_BYTES if group_bytes is None else group_bytes

    def gather_table(F_loc):
        return extend_zero(jax.lax.all_gather(F_loc, axis, axis=0, tiled=True))

    def step_local(idx_r, idx_c, vals_r, vals_c, W, H, nnz_r, nnz_c):
        W = _solve_side(idx_r, vals_r, rows, gather_table(H), lam_, nnz_r,
                        chunk, prec, solver, gb)
        H = _solve_side(idx_c, vals_c, cols, gather_table(W), lam_, nnz_c,
                        chunk, prec, solver, gb)
        return W, H

    nb_r, nb_c = len(rows.buckets), len(cols.buckets)
    bspec = P(axis, None)
    in_specs = (tuple([bspec] * nb_r), tuple([bspec] * nb_c),
                tuple([bspec] * nb_r), tuple([bspec] * nb_c),
                P(axis, None), P(axis, None), P(axis), P(axis))
    out_specs = (P(axis, None), P(axis, None))
    fn = jax.shard_map(step_local, mesh=mesh, in_specs=in_specs,
                       out_specs=out_specs, check_vma=False)
    return jax.jit(fn, donate_argnums=(4, 5))


def als_ell_train_sharded(R: RatingMatrix, W0: np.ndarray, H0: np.ndarray,
                          T: TestCOO, cfg: Config, mesh: Mesh, *,
                          callback: Optional[Callable[[IterStats], None]] = None,
                          ckpt_every: int = 0, ckpt_fn=None, resume=None,
                          ) -> tuple[np.ndarray, np.ndarray, list[IterStats]]:
    """Multi-device ALS training, entity-major layout in and out."""
    n_dev = mesh.devices.size
    ell = build_ell_pair(R, min_width=cfg.als_min_width, num_shards=n_dev)
    rows, cols = ell.rows_side, ell.cols_side
    sh = ell_shardings(mesh)
    k = W0.shape[1]

    put_b = functools.partial(jax.device_put, device=sh["bucket"])
    idx_r = tuple(put_b(b.idx) for b in rows.buckets)
    idx_c = tuple(put_b(b.idx) for b in cols.buckets)
    vals_r = tuple(put_b(b.val) for b in rows.buckets)
    vals_c = tuple(put_b(b.val) for b in cols.buckets)

    start_oiter = 1
    fsh = sh["factors_entity_major"]
    if resume is not None:
        start_oiter = int(resume["oiter"]) + 1
        W_s, H_s = resume["W"], resume["H"]
    else:
        W_s = np.zeros((rows.n_slots, k), np.float32)
        W_s[rows.slot_of_entity] = np.asarray(W0, np.float32)
        H_s = np.zeros((cols.n_slots, k), np.float32)
        H_s[cols.slot_of_entity] = np.asarray(H0, np.float32)
    W, H = jax.device_put(W_s, fsh), jax.device_put(H_s, fsh)
    nnz_r = jax.device_put(rows.slot_nnz, sh["slots"])
    nnz_c = jax.device_put(cols.slot_nnz, sh["slots"])

    rep = sh["rep"]
    ti = jax.device_put(rows.slot_of_entity[T.row_idx], rep)
    tj = jax.device_put(cols.slot_of_entity[T.col_idx], rep)
    tv = jax.device_put(np.asarray(T.val), rep)

    step = make_sharded_als_step(ell, mesh, cfg.lambda_, cfg.ell_chunk,
                                 solver=cfg.als_solver,
                                 precision_name=cfg.als_precision,
                                 group_bytes=cfg.als_group_mb << 20)
    rmse_fn = jax.jit(functools.partial(
        calrmse_device, entity_major=True,
        chunk=default_eval_chunk(T.nnz, cfg.eval_chunk)))

    stats: list[IterStats] = []
    for oiter in range(start_oiter, cfg.maxiter + 1):
        t0 = time.perf_counter()
        W, H = step(idx_r, idx_c, vals_r, vals_c, W, H, nnz_r, nnz_c)
        rmse = float(np.asarray(rmse_fn(ti, tj, tv, W, H)))
        st = IterStats(oiter=oiter, rmse=rmse,
                       rank_time=time.perf_counter() - t0)
        stats.append(st)
        if callback:
            callback(st)
        if ckpt_every and ckpt_fn and oiter % ckpt_every == 0:
            ckpt_fn(oiter, {"W": np.asarray(W), "H": np.asarray(H)})
        if early_stopped(stats, cfg.eps if cfg.early_stop else 0.0):
            break

    return (np.asarray(W)[rows.slot_of_entity],
            np.asarray(H)[cols.slot_of_entity], stats)
