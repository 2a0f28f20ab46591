#!/usr/bin/env python3
"""A/B timings on one GPU for the choices chip_smoke.py does not make:

  panel   the hybrid CCD++ outer step at Netflix-100M dims, k=40, in the
          former headline config (bf16 NaN-sentinel residual, 6.5e9-cell
          stair of widths (4096, 2048)), with the Pallas panel kernels
          against the plain XLA panel passes, in turns (xla, kernel,
          kernel, xla); seconds per outer iteration, compile seconds and
          the compiled step's memory_analysis.
  solve   the batched k×k ALS solve, "lax" (Cholesky) against "gj_xla"
          (Gauss-Jordan), k=40, at the slot counts of both ml20M sides and
          both yahoo-r1 sides.
  layout  the ALS augmented gram at ml20M's widest rows bucket, emitted as
          (S, k+1, k+1) against batch-last (k+1, k+1, S) plus the transpose
          a batched solve needs.
  als     ALS at ml20M dims, k=40, 3 iterations per solver.

    python scripts/hopper_ab.py [panel] [solve] [layout] [als]

Prints one JSON line per measurement (and appends it to
chiprun_out/hopper_ab.jsonl). Every time ends in jax.block_until_ready.
"""

from __future__ import annotations

import functools
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

OUT = os.path.join(ROOT, "chiprun_out", "hopper_ab.jsonl")
#: (m, n, nnz) of the geometries measured
NETFLIX = (480_189, 17_770, 100_000_000)
ML20M = (138_493, 26_744, 20_000_263)
#: slot counts of each ALS side
SIDES = (("ml20m_rows", 138_493), ("ml20m_cols", 26_744),
         ("yahoo_r1_rows", 1_948_883), ("yahoo_r1_cols", 98_211))
#: systems per timed solve; larger sides are extrapolated linearly (the
#: ALS path solves a huge side in memory-bounded groups anyway)
SOLVE_CHUNK = 1 << 18
K = 40


def emit(rec: dict) -> None:
    line = json.dumps(rec, default=str)
    print(line, flush=True)
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "a") as f:
        f.write(line + "\n")


def timed(fn, *args, reps: int = 3):
    """(median seconds, samples) of fn(*args), warmed once."""
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)), ts


def ab_panel() -> None:
    import jax
    import jax.numpy as jnp

    from cuda_recommender_tpu.core.config import Config
    from cuda_recommender_tpu.core.init import init_factors_np
    from cuda_recommender_tpu.data.datasets import synthetic_device
    from cuda_recommender_tpu.eval.metrics import calrmse_np
    from cuda_recommender_tpu.solvers.ccd_hybrid import (
        densify_panels, make_hybrid_outer_step, plan_hybrid)

    (m, n, nnz), k = NETFLIX, K
    R, T = synthetic_device(m, n, nnz, seed=1)
    cfg = Config(k=k, backend="hybrid", residual_dtype="bfloat16",
                 mask_dtype="nan", hybrid_dense_cells=6_500_000_000,
                 hybrid_panel_widths=(4096, 2048))
    t0 = time.perf_counter()
    plan = plan_hybrid(R, cfg, materialize_dense=False)
    emit({"ab": "panel_plan", "plan_s": time.perf_counter() - t0,
          "panels": plan.panels, "nnz_light_frac": plan.nnz_light / R.nnz})
    rows, cols = plan.ell.rows_side, plan.ell.cols_side
    idx_r = tuple(jnp.asarray(b.idx) for b in rows.buckets)
    idx_c = tuple(jnp.asarray(b.idx) for b in cols.buckets)
    consts = tuple(jnp.asarray(x) for x in (
        plan.row_nnz, plan.col_nnz, plan.upos_of_slot_safe,
        plan.ipos_of_slot_safe, plan.slot_of_upos, plan.slot_of_ipos))
    W0, _ = init_factors_np(k, m, n, seed=0)

    for variant in ("xla", "kernel", "kernel", "xla"):
        Rds, _ = densify_panels(plan, jnp.bfloat16, mask_dtype="nan")
        s = (Rds, tuple(jnp.asarray(b.val) for b in rows.buckets),
             tuple(jnp.asarray(b.val) for b in cols.buckets),
             jnp.asarray(W0[:, plan.user_order]),
             jnp.zeros((k, n), jnp.float32), jnp.zeros(m, jnp.float32),
             jnp.zeros(n, jnp.float32))
        step = make_hybrid_outer_step(plan, cfg.lambda_, 1,
                                      residual_dtype=jnp.bfloat16,
                                      nan_mask=True,
                                      panel_kernel=variant == "kernel")
        t0 = time.perf_counter()
        compiled = step.lower(idx_r, idx_c, s[0], (), *s[1:],
                              *consts).compile()
        compile_s = time.perf_counter() - t0
        ma = compiled.memory_analysis()
        its = []
        for _ in range(4):                      # 1 warm + 3 timed
            t0 = time.perf_counter()
            s = compiled(idx_r, idx_c, s[0], (), *s[1:], *consts)
            jax.block_until_ready(s)
            its.append(time.perf_counter() - t0)
        W = np.asarray(s[3])[:, plan.user_pos]
        H = np.asarray(s[4])[:, plan.item_pos]
        emit({"ab": "panel", "variant": variant,
              "s_per_iter": float(np.median(its[1:])), "iter_s": its,
              "compile_s": compile_s,
              "temp_bytes": ma.temp_size_in_bytes,
              "argument_bytes": ma.argument_size_in_bytes,
              "rmse_after_4": calrmse_np(T, W, H, entity_major=False)})
        del s, Rds, compiled


def ab_solve() -> None:
    import jax
    import jax.numpy as jnp

    from cuda_recommender_tpu.solvers.als_ell import _solve_kxk

    k = K
    solve = jax.jit(_solve_kxk, static_argnums=2)

    @functools.partial(jax.jit, static_argnums=1)
    def make(key, S):                 # SPD, diagonally dominant
        B = 0.1 * jax.random.normal(key, (S, k, k))
        A = B + jnp.swapaxes(B, 1, 2) + k * jnp.eye(k)
        return A, jax.random.normal(key, (S, k))

    for name, S in SIDES:
        n_sys = min(S, SOLVE_CHUNK)
        A, r = make(jax.random.PRNGKey(0), n_sys)
        for solver in ("lax", "gj_xla", "gj_xla", "lax"):
            t, ts = timed(solve, A, r, solver)
            emit({"ab": "solve", "side": name, "slots": S, "k": k,
                  "solver": solver, "systems_timed": n_sys, "s": t,
                  "s_side_est": t * S / n_sys, "samples": ts})
        del A, r


def ab_layout() -> None:
    import jax
    import jax.numpy as jnp

    from cuda_recommender_tpu.core.config import Config
    from cuda_recommender_tpu.data.datasets import synthetic_device
    from cuda_recommender_tpu.data.ell import build_ell_pair
    from cuda_recommender_tpu.ops.ell_ops import extend_zero

    k = K
    R, _ = synthetic_device(*ML20M, seed=1)
    ell = build_ell_pair(R, min_width=Config(solver="als").als_min_width)
    b = max(ell.rows_side.buckets, key=lambda b: b.idx.size)
    H = extend_zero(jax.random.normal(jax.random.PRNGKey(0),
                                      (ell.cols_side.n_slots, k)))
    idx, val = jnp.asarray(b.idx), jnp.asarray(b.val)
    S = idx.shape[0] * b.p

    def gram(spec, idx, val, H):
        F = H[idx.reshape(S, b.E)]
        Fa = jnp.concatenate([F, val.reshape(S, b.E)[..., None]], -1)
        G = jnp.einsum(spec, Fa, Fa, preferred_element_type=jnp.float32,
                       precision=jax.lax.Precision.HIGHEST)
        return G if spec.endswith("sab") else jnp.transpose(G, (2, 0, 1))

    for spec in ("sea,seb->sab", "sea,seb->abs", "sea,seb->abs",
                 "sea,seb->sab"):
        f = jax.jit(lambda i, v, h, spec=spec: gram(spec, i, v, h))
        t, ts = timed(f, idx, val, H)
        emit({"ab": "layout", "spec": spec, "bucket_width": b.E,
              "slots": S, "s": t, "samples": ts})


def ab_als() -> None:
    from cuda_recommender_tpu.core.config import Config
    from cuda_recommender_tpu.core.init import init_factors_np
    from cuda_recommender_tpu.data.datasets import synthetic_device
    from cuda_recommender_tpu.solvers.als_ell import als_ell_train

    R, T = synthetic_device(*ML20M, seed=1)
    W0, H0 = init_factors_np(K, R.rows, R.cols, seed=0, entity_major=True)
    for solver in ("lax", "gj_xla"):
        cfg = Config(solver="als", k=K, maxiter=3, als_solver=solver)
        t0 = time.perf_counter()
        _, _, stats = als_ell_train(R, W0, H0, T, cfg)
        emit({"ab": "als", "solver": solver,
              "iter_s": [st.rank_time for st in stats],
              "s_per_iter": float(np.median([st.rank_time
                                             for st in stats[1:]])),
              "rmse": [st.rmse for st in stats],
              "wall_s": time.perf_counter() - t0})


def main(argv) -> int:
    import jax

    from cuda_recommender_tpu.utils.cache import enable_compile_cache

    if jax.devices()[0].platform != "gpu":
        print("hopper_ab: needs a GPU", file=sys.stderr)
        return 1
    enable_compile_cache()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    emit({"ab": "card", "card": card,
          "device_kind": jax.devices()[0].device_kind})
    parts = {"panel": ab_panel, "solve": ab_solve, "layout": ab_layout,
             "als": ab_als}
    for name in argv or list(parts):
        parts[name]()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
