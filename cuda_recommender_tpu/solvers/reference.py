"""Golden-semantics solvers (NumPy, interpret mode).

These play the role of the reference's OpenMP backends — the slow,
obviously-correct implementations every compiled backend is cross-validated
against (the reference's own discipline: dual backends from identical init +
golden_compare, /root/reference/src/main.cpp:109-144).

Semantics are kept loop-faithful to:
  * CCD++: ccdr1_OMP (/root/reference/src/CCD.cpp:45-163) — H zeroed at entry,
    residual add-back only from outer iteration 2, λ scaled by entity nnz,
    v-sweep before u-sweep per inner iteration, empty column → 0 factor,
    rank-major (k, n) factor layout, float32 arithmetic.
  * ALS: ALS_OMP (/root/reference/src/ALS.cpp:81-233) — per-entity normal
    equations with unscaled λ on the diagonal, W update with current H then H
    update with NEW W, empty entities zeroed, entity-major (n, k) layout. We
    solve the k×k system (Cholesky) instead of forming the explicit inverse
    (src/ALS.cpp:41-64) — same math, better numerics.

Vectorized with NumPy where it does not change update order semantics
(within-sweep updates are Jacobi with respect to the swept side, so per-entity
order within a sweep is irrelevant — see src/CCD.cpp:110-121 where every column
update reads the frozen opposite-side vector).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from ..data.sparse import RatingMatrix, TestCOO
from ..eval.metrics import calrmse_np


@dataclasses.dataclass
class IterStats:
    oiter: int
    rmse: float
    rank_time: float = 0.0
    update_time: float = 0.0
    #: measured RMSE-eval wall time, or None when the loop fused the eval into
    #: the training dispatch and could not honestly separate it
    rmse_time: object = None


def early_stopped(stats: list, eps: float) -> bool:
    """Opt-in convergence stop (cfg.early_stop; OFF by default for reference
    parity — the reference parses ``-e eps`` but never consumes it,
    src/pmf.h:32): stop once the relative test-RMSE improvement of the last
    completed iteration falls below ``eps`` (also catches regressions)."""
    if eps <= 0 or len(stats) < 2:
        return False
    prev, cur = stats[-2].rmse, stats[-1].rmse
    return prev - cur < eps * abs(prev)


def _sweep_side(ptr, idx, vals, other, lam, nmf: bool = False):
    """One CCD rank-one sweep over one orientation: for each entity j,
    new_j = g / (lam*nnz_j + h) with g = Σ other[i]*val, h = Σ other[i]^2.
    Empty entity → 0 (src/CCD.cpp:8). float32 accumulation like the reference.

    ``nmf``: clamp each update at 0 (nonnegative MF, the original libpmf
    CCD++ semantics of the -N flag; the reference parses -N but never
    consumes it — src/pmf.h:33, no use anywhere in src/)."""
    n = ptr.shape[0] - 1
    out = np.zeros(n, dtype=np.float32)
    for j in range(n):
        lo, hi = ptr[j], ptr[j + 1]
        if lo == hi:
            continue
        o = other[idx[lo:hi]]
        g = np.float32(np.dot(o, vals[lo:hi]))
        h = np.float32(lam * (hi - lo)) + np.float32(np.dot(o, o))
        out[j] = max(g / h, np.float32(0.0)) if nmf else g / h
    return out


def _update_rating(ptr, idx, vals, wt, ht, add: bool):
    """Residual maintenance over one orientation (UpdateRating_Original_float,
    src/CCD.cpp:18-43): vals ± wt[idx]*ht[entity], in place."""
    n = ptr.shape[0] - 1
    sign = np.float32(1.0) if add else np.float32(-1.0)
    for j in range(n):
        lo, hi = ptr[j], ptr[j + 1]
        if lo == hi:
            continue
        vals[lo:hi] += sign * wt[idx[lo:hi]] * np.float32(ht[j])


def ccd_reference(R: RatingMatrix, W: np.ndarray, H: np.ndarray, T: TestCOO,
                  *, lambda_: float, maxiter: int, maxinneriter: int = 1,
                  nmf: bool = False, callback=None,
                  early_stop_eps: float = 0.0) -> list[IterStats]:
    """CCD++ golden solver. W (k, m) and H (k, n) are updated in place
    (rank-major layout, src/main.cpp:93-97). Returns per-iteration stats."""
    k = W.shape[0]
    lam = np.float32(lambda_)
    H[:] = 0.0                                    # src/CCD.cpp:56-60
    csc_vals = R.csc_val.copy()                   # residual, CSC order
    csr_vals = R.csr_val.copy()                   # residual, CSR order (the Rt copy)
    stats = []
    for oiter in range(1, maxiter + 1):
        # rank_time / update_time split per the reference's omp_get_wtime
        # phase accumulators (src/CCD.cpp:76-139)
        rank_t = upd_t = 0.0
        for t in range(k):
            u = W[t].copy()
            v = H[t].copy()
            if oiter > 1:                         # src/CCD.cpp:100-103
                t0 = time.perf_counter()
                _update_rating(R.csc_ptr, R.csc_idx, csc_vals, u, v, add=True)
                _update_rating(R.csr_ptr, R.csr_idx, csr_vals, v, u, add=True)
                upd_t += time.perf_counter() - t0
            t0 = time.perf_counter()
            for _ in range(maxinneriter):         # src/CCD.cpp:107-123
                v = _sweep_side(R.csc_ptr, R.csc_idx, csc_vals, u, lam, nmf)
                u = _sweep_side(R.csr_ptr, R.csr_idx, csr_vals, v, lam, nmf)
            rank_t += time.perf_counter() - t0
            W[t] = u                              # src/CCD.cpp:128-134
            H[t] = v
            t0 = time.perf_counter()
            _update_rating(R.csc_ptr, R.csc_idx, csc_vals, u, v, add=False)
            _update_rating(R.csr_ptr, R.csr_idx, csr_vals, v, u, add=False)
            upd_t += time.perf_counter() - t0
        t0 = time.perf_counter()
        rmse = calrmse_np(T, W, H, entity_major=False)
        stats.append(IterStats(oiter=oiter, rmse=rmse, rank_time=rank_t,
                               update_time=upd_t,
                               rmse_time=time.perf_counter() - t0))
        if callback:
            callback(stats[-1])
        if early_stopped(stats, early_stop_eps):
            break
    return stats


def _als_update_side(ptr, idx, vals, other_factors, lam, k):
    """One ALS half-iteration: per entity solve (F_Ω^T F_Ω + λI) x = F_Ω^T r
    (src/ALS.cpp:98-158). Cholesky solve instead of explicit inverse."""
    n = ptr.shape[0] - 1
    out = np.zeros((n, k), dtype=np.float32)
    eye = np.eye(k, dtype=np.float32)
    for j in range(n):
        lo, hi = ptr[j], ptr[j + 1]
        if lo == hi:
            continue                              # src/ALS.cpp:151-157 → zeros
        F = other_factors[idx[lo:hi]]             # (d, k)
        G = F.T @ F + lam * eye                   # λ unscaled (src/ALS.cpp:121)
        b = F.T @ vals[lo:hi]
        out[j] = np.linalg.solve(G, b).astype(np.float32)
    return out


def als_reference(R: RatingMatrix, W: np.ndarray, H: np.ndarray, T: TestCOO,
                  *, lambda_: float, maxiter: int, callback=None,
                  early_stop_eps: float = 0.0) -> list[IterStats]:
    """ALS golden solver. W (m, k) and H (n, k) updated in place
    (entity-major layout, src/main.cpp:87-91)."""
    k = W.shape[1]
    stats = []
    for oiter in range(1, maxiter + 1):
        t0 = time.perf_counter()
        W[:] = _als_update_side(R.csr_ptr, R.csr_idx, R.csr_val, H, lambda_, k)
        H[:] = _als_update_side(R.csc_ptr, R.csc_idx, R.csc_val, W, lambda_, k)
        upd_t = time.perf_counter() - t0
        t0 = time.perf_counter()
        rmse = calrmse_np(T, W, H, entity_major=True)
        stats.append(IterStats(oiter=oiter, rmse=rmse, rank_time=upd_t,
                               update_time=upd_t,
                               rmse_time=time.perf_counter() - t0))
        if callback:
            callback(stats[-1])
        if early_stopped(stats, early_stop_eps):
            break
    return stats
