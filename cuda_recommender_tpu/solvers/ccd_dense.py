"""CCD++ — compiled dense-residual backend (XLA, single chip or pjit-sharded).

This is a re-design of the reference's CUDA CCD++ path
(/root/reference/cuda_src/CCD_CUDA.cu:224-451). The reference walks CSC pointer
chains with one thread per column. Instead the residual is a dense (m, n)
array maintained only at observed entries (zero elsewhere) with a {0,1} mask,
and every sweep becomes a matvec pair — pure memory-bandwidth-bound work that
XLA fuses into streaming passes.

Traffic-optimized schedule (equivalent math, fewer HBM passes than the
reference's order):

* **Deferred subtract**: the reference subtracts rank t's new outer product
  at rank end and adds the old one back at rank start of the next sweep
  (src/CCD.cpp:100-134) — two rank-1 residual passes. Here the subtract of
  rank t and the add-back of rank t+1 fuse into ONE read-modify-write:
      Rhat += (outer(u_add, v_add) - outer(u_sub, v_sub)) * mask
  with (u_sub, v_sub) carried across ranks AND outer iterations in the state.
* **Unconditional add-back**: the reference gates add-back on oiter > 1; in
  outer iteration 1 H[t] is still 0 so the add-back term vanishes identically
  — one compiled step variant covers all iterations.
* **bf16 mask**: {0,1} is exact in bfloat16; mask traffic is halved, all
  arithmetic accumulates in f32.

Semantics preserved (SURVEY.md §7 checklist): H zeroed at solver entry
(src/CCD.cpp:56-60); λ scaled by the entity's nnz (src/CCD.cpp:112,120);
empty entity → factor 0 (src/CCD.cpp:8); v-sweep before u-sweep per inner
iteration (src/CCD.cpp:110-121); rank-major (k, n) factor layout
(src/main.cpp:93-97). All k ranks run inside one jitted outer iteration under
lax.fori_loop — no per-rank host dispatch, unlike the reference's 2·k·T
device syncs per outer iteration (cuda_src/CCD_CUDA.cu:218).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..core.config import Config
from ..data.sparse import RatingMatrix, TestCOO
from ..eval.metrics import calrmse_device, default_eval_chunk
from ..ops.densify import densify_coo
from .pipeline import pipelined_loop
from .reference import IterStats


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class DenseState:
    """Device state for the dense CCD++ backend (a pytree; donated per step).

    ``u_pend``/``v_pend`` is the not-yet-subtracted outer product of the last
    swept rank (deferred-subtract schedule); zeros before the first rank.
    """

    Rhat: jnp.ndarray      # (m, n) residual at observed entries, 0 elsewhere
    W: jnp.ndarray         # (k, m) rank-major user factors
    H: jnp.ndarray         # (k, n) rank-major item factors
    u_pend: jnp.ndarray    # (m,)
    v_pend: jnp.ndarray    # (n,)


def _half_sweep(other, Rhat_T, mask_T, lam, nnz, nmf: bool = False):
    """One side of a rank-one sweep: new_j = g_j / (lam*nnz_j + h_j).
    ``nmf`` clamps updates at 0 (libpmf -N semantics; the reference parses
    -N but never consumes it, src/pmf.h:33)."""
    g = jnp.einsum("m,mn->n", other, Rhat_T.astype(jnp.float32),
                   preferred_element_type=jnp.float32)
    h = lam * nnz + jnp.einsum("m,mn->n", other * other,
                               mask_T.astype(jnp.float32),
                               preferred_element_type=jnp.float32)
    out = jnp.where(h > 0, g / h, 0.0)
    return jnp.maximum(out, 0.0) if nmf else out


def make_outer_step(lam: float, maxinneriter: int,
                    residual_dtype=jnp.float32, jit_compile: bool = True,
                    nmf: bool = False):
    """Build the one-outer-iteration step function (jitted by default)."""

    def step(state: DenseState, mask, row_nnz, col_nnz) -> DenseState:
        lam_ = jnp.float32(lam)

        def rank_body(t, carry):
            Rhat, W, H, u_sub, v_sub = carry
            u = jax.lax.dynamic_slice_in_dim(W, t, 1, axis=0)[0]
            v = jax.lax.dynamic_slice_in_dim(H, t, 1, axis=0)[0]
            # fused deferred-subtract + add-back (single residual pass)
            delta = (jnp.outer(u, v) - jnp.outer(u_sub, v_sub))
            Rhat = Rhat + (delta * mask.astype(delta.dtype)).astype(residual_dtype)
            for _ in range(maxinneriter):      # src/CCD.cpp:107-123
                v = _half_sweep(u, Rhat, mask, lam_, col_nnz, nmf)
                u = _half_sweep(v, Rhat.T, mask.T, lam_, row_nnz, nmf)
            W = jax.lax.dynamic_update_slice_in_dim(W, u[None], t, axis=0)
            H = jax.lax.dynamic_update_slice_in_dim(H, v[None], t, axis=0)
            return (Rhat, W, H, u, v)

        k = state.W.shape[0]
        Rhat, W, H, u_pend, v_pend = jax.lax.fori_loop(
            0, k, rank_body,
            (state.Rhat, state.W, state.H, state.u_pend, state.v_pend))
        return DenseState(Rhat=Rhat, W=W, H=H, u_pend=u_pend, v_pend=v_pend)

    if not jit_compile:
        return step
    return jax.jit(step, donate_argnums=(0,))




def make_dense_phase_fns(lam: float, maxinneriter: int,
                         residual_dtype=jnp.float32, nmf: bool = False):
    """Phase-split step functions for the phase-timing mode (phase_loop.py):
    the reference's plain schedule (add-back / sweeps / subtract as separate
    dispatches, src/CCD.cpp:74-139) — identical math to make_outer_step's
    fused deferred-subtract schedule, but with fence-able phase boundaries.
    Rank index ``t`` is a traced argument: one compiled program per phase."""
    lam_ = jnp.float32(lam)

    def _outer_pass(state, mask, t, sign):
        u = jax.lax.dynamic_slice_in_dim(state.W, t, 1, 0)[0]
        v = jax.lax.dynamic_slice_in_dim(state.H, t, 1, 0)[0]
        delta = sign * jnp.outer(u, v)
        Rhat = state.Rhat + (delta * mask.astype(delta.dtype)).astype(
            state.Rhat.dtype)
        return dataclasses.replace(state, Rhat=Rhat)

    @functools.partial(jax.jit, donate_argnums=(0,))
    def addback(state, mask, t):
        return _outer_pass(state, mask, t, jnp.float32(1.0))

    @functools.partial(jax.jit, donate_argnums=(0,))
    def subtract(state, mask, t):
        return _outer_pass(state, mask, t, jnp.float32(-1.0))

    @functools.partial(jax.jit, donate_argnums=(0,))
    def sweeps(state, mask, row_nnz, col_nnz, t):
        u = jax.lax.dynamic_slice_in_dim(state.W, t, 1, 0)[0]
        v = jax.lax.dynamic_slice_in_dim(state.H, t, 1, 0)[0]
        for _ in range(maxinneriter):          # src/CCD.cpp:107-123
            v = _half_sweep(u, state.Rhat, mask, lam_, col_nnz, nmf)
            u = _half_sweep(v, state.Rhat.T, mask.T, lam_, row_nnz, nmf)
        W = jax.lax.dynamic_update_slice_in_dim(state.W, u[None], t, 0)
        H = jax.lax.dynamic_update_slice_in_dim(state.H, v[None], t, 0)
        return dataclasses.replace(state, W=W, H=H)

    return addback, sweeps, subtract


def build_dense_inputs(R: RatingMatrix, dtype=np.float32):
    """Host-side densification: residual init = ratings at observed coords,
    mask = observed pattern (NOT value != 0 — explicit zero ratings stay
    observed, matching the reference's structural sparsity)."""
    r, c, v = R.to_coo()
    Rd = np.zeros((R.rows, R.cols), dtype=np.float32)
    Md = np.zeros((R.rows, R.cols), dtype=np.float32)
    Rd[r, c] = v
    Md[r, c] = 1.0
    return Rd.astype(dtype), Md


def _device_densify(R: RatingMatrix, mp: int, np_: int, rdt,
                    mdt=jnp.bfloat16):
    """Device-side densification via one jitted COO scatter: ships ~12 B/nnz
    instead of the host-built (m, n) residual+mask (~4.5 GB at ml10M dims —
    300x the COO). ``mdt`` is the mask storage dtype (cfg.mask_dtype; int8
    halves mask traffic with identical numerics — {0,1} is exact in
    both)."""
    r, c, v = R.to_coo()
    mdt = jnp.dtype(mdt)

    @functools.partial(jax.jit, static_argnums=(3, 4))
    def densify(ri, ci, vv, mp, np_):
        # chunked scatter (ops/densify.py): unique_indices inside lets the
        # backend skip duplicate handling; chunking bounds the index temp
        return densify_coo(ri, ci, vv, mp, np_, rdt, mdt)

    return densify(jnp.asarray(r), jnp.asarray(c),
                   jnp.asarray(v.astype(np.float32)), mp, np_)


def ccd_dense_train(R: RatingMatrix, W0: np.ndarray, H0: np.ndarray,
                    T: TestCOO, cfg: Config, *,
                    callback: Optional[Callable[[IterStats], None]] = None,
                    shardings: Optional[dict] = None,
                    ckpt_every: int = 0, ckpt_fn=None, resume=None,
                    rank_callback=None,
                    ) -> tuple[np.ndarray, np.ndarray, list[IterStats]]:
    """Train CCD++ with the dense backend. Returns (W, H, per-iter stats) in
    the reference's rank-major layout. ``shardings`` optionally maps layout
    kinds to jax.sharding.Sharding for pjit execution (parallel/mesh.py).

    Checkpointing: every ``ckpt_every`` outer iters, ``ckpt_fn(oiter,
    payload)`` gets host copies of the full training state (factors, the
    dense residual AND the pending outer product — CCD++'s residual is
    state, src/CCD.cpp:100-134); ``resume`` takes such a payload plus its
    ``oiter`` to continue a run."""
    rdt = jnp.dtype(cfg.residual_dtype)
    row_nnz = np.diff(R.csr_ptr).astype(np.float32)
    col_nnz = np.diff(R.csc_ptr).astype(np.float32)

    # Sharded execution: pad each sharded axis to a multiple of its mesh
    # dimension (1-D meshes shard users only; 2-D meshes block both axes).
    # Pad entities are all-zero mask/residual with zero factors, so every
    # sweep keeps them exactly 0 (empty-entity rule, src/CCD.cpp:8).
    m, n = R.rows, R.cols
    m_pad = n_pad = 0
    if shardings is not None:
        row_div, col_div = shardings.get("_divs", (1, 1))
        m_pad, n_pad = (-m) % row_div, (-n) % col_div
        if m_pad or n_pad:
            row_nnz = np.pad(row_nnz, (0, m_pad))
            col_nnz = np.pad(col_nnz, (0, n_pad))
            W0 = np.pad(np.asarray(W0, np.float32), ((0, 0), (0, m_pad)))
            H0 = np.pad(np.asarray(H0, np.float32), ((0, 0), (0, n_pad)))
    mp, np_ = m + m_pad, n + n_pad

    put = functools.partial(_put, shardings)
    start_oiter = 1
    if resume is not None:
        mask = put(_device_densify(R, mp, np_, rdt,
                                   mdt=cfg.mask_dtype)[1], "rowmat")
        start_oiter = int(resume["oiter"]) + 1
        state = DenseState(
            Rhat=put(resume["Rhat"].astype(rdt), "rowmat"),
            W=put(resume["W"].astype(np.float32), "colshard_k_m"),
            H=put(resume["H"].astype(np.float32), "colshard_k_n"),
            u_pend=put(resume["u_pend"].astype(np.float32), "rowvec"),
            v_pend=put(resume["v_pend"].astype(np.float32), "colvec"),
        )
    else:
        Rd, Md = _device_densify(R, mp, np_, rdt, mdt=cfg.mask_dtype)
        mask = put(Md, "rowmat")            # {0,1} exact in bf16 and int8
        state = DenseState(
            Rhat=put(Rd, "rowmat"),
            W=put(np.asarray(W0, np.float32), "colshard_k_m"),
            H=put(np.zeros_like(np.asarray(H0), dtype=np.float32),
                  "colshard_k_n"),                    # src/CCD.cpp:56-60
            u_pend=put(np.zeros(mp, np.float32), "rowvec"),
            v_pend=put(np.zeros(np_, np.float32), "colvec"),
        )
    row_nnz_d = put(row_nnz, "rowvec")
    col_nnz_d = put(col_nnz, "colvec")
    ti = put(np.asarray(T.row_idx), "rep")
    tj = put(np.asarray(T.col_idx), "rep")
    tv = put(np.asarray(T.val), "rep")

    rmse_fn = jax.jit(functools.partial(
        calrmse_device, entity_major=False,
        chunk=default_eval_chunk(T.nnz, cfg.eval_chunk)))

    box = {"state": state}

    def do_rmse():
        s = box["state"]
        return rmse_fn(ti, tj, tv, s.W, s.H)

    def get_payload():
        s = box["state"]
        return {"W": np.asarray(s.W), "H": np.asarray(s.H),
                "Rhat": np.asarray(s.Rhat),
                "u_pend": np.asarray(s.u_pend),
                "v_pend": np.asarray(s.v_pend)}

    if cfg.phase_timing:
        # phase-split telemetry mode (real rank_time/update_time split):
        # separate fenced dispatches per rank phase, phase_loop.py. Note the
        # resume payloads are interchangeable with the fused path because a
        # fresh resume starts with zero pends and phase mode never sets them.
        if resume is not None and (np.asarray(resume["u_pend"]).any()
                                   or np.asarray(resume["v_pend"]).any()):
            raise ValueError("cannot resume a fused-schedule checkpoint "
                             "(pending outer product) in phase-timing mode")
        ab, sw, sub = make_dense_phase_fns(cfg.lambda_, cfg.maxinneriter,
                                           nmf=cfg.do_nmf,
                                           residual_dtype=rdt)

        def _ab(t):
            box["state"] = ab(box["state"], mask, t)
            return box["state"].Rhat

        def _sw(t):
            box["state"] = sw(box["state"], mask, row_nnz_d, col_nnz_d, t)
            return box["state"].W

        def _sub(t):
            box["state"] = sub(box["state"], mask, t)
            return box["state"].Rhat

        def get_rank_rows(t):
            s = box["state"]
            return np.asarray(s.W[t]), np.asarray(s.H[t])

        from .phase_loop import phased_ccd_loop
        stats = phased_ccd_loop(
            start_oiter=start_oiter, maxiter=cfg.maxiter, k=W0.shape[0],
            addback=_ab, sweeps=_sw, subtract=_sub, do_rmse=do_rmse,
            get_rank_rows=get_rank_rows, ti=np.asarray(T.row_idx),
            tj=np.asarray(T.col_idx), tv=np.asarray(T.val),
            callback=callback, rank_callback=rank_callback,
            ckpt_every=ckpt_every, ckpt_fn=ckpt_fn, get_payload=get_payload,
        early_stop_eps=cfg.eps if cfg.early_stop else 0.0)
        state = box["state"]
        return np.asarray(state.W)[:, :m], np.asarray(state.H)[:, :n], stats

    step_fn = make_outer_step(cfg.lambda_, cfg.maxinneriter,
                              residual_dtype=rdt, nmf=cfg.do_nmf)

    def do_step():
        box["state"] = step_fn(box["state"], mask, row_nnz_d, col_nnz_d)
        return box["state"].W

    stats = pipelined_loop(
        start_oiter=start_oiter, maxiter=cfg.maxiter,
        fuse=cfg.fused_outer_iters, do_step=do_step, do_rmse=do_rmse,
        callback=callback, ckpt_every=ckpt_every, ckpt_fn=ckpt_fn,
        get_payload=get_payload,
        early_stop_eps=cfg.eps if cfg.early_stop else 0.0)
    state = box["state"]
    return np.asarray(state.W)[:, :m], np.asarray(state.H)[:, :n], stats


def _put(shardings: Optional[dict], x, kind: str):
    if shardings is None:
        return jnp.asarray(x)
    return jax.device_put(x, shardings.get(kind, shardings["rep"]))
