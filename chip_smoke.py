#!/usr/bin/env python3
"""Smoke test of the main path on NVIDIA GPUs.

    python chip_smoke.py           # one card: every phase below
    python chip_smoke.py --multi   # four cards: the sharded path alone

One card, one process, phases in order (each prints one JSON line):

  device   JAX must report platform "gpu"; prints nvidia-smi's name and
           power limit and the active XLA_FLAGS.
  kernels  the Pallas panel kernels compiled at a full-width panel, checked
           against the plain XLA path there and against float64 NumPy on a
           slice; the ALS k×k solve against np.linalg.solve on assembled
           grams.
  golden   CCD++ dense, CCD++ hybrid and ALS at ml1m dims through
           ``train(Config(..., golden=True))``: the reference's 10% per-entry
           golden_compare must PASS.
  ccd      ``cli.train`` at Netflix-100M dims, k=40, 3 iterations, with the
           default flags and with the headline panel config.
  als      ``cli.train -ALS`` at ml20M dims, k=40, 2 iterations.
  serve    top-10 retrieval over the trained Netflix item table for 1,024
           users against NumPy float64 exact top-k.

``--multi`` trains CCD++ hybrid (Netflix-100M dims) and ALS (ml20M dims)
sharded over a 1-D mesh of four cards, each against the single-card run from
the same init, and checks through ``addressable_shards`` that each card
holds its own row block.

The last line of standard output is ``{"ok": true, "device": {...}}`` when
every phase passed; otherwise the script exits non-zero and prints no such
line. There is no CPU path: the script exits non-zero when JAX finds no GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

#: full sizes of each phase (the CPU tests pass tiny ones)
GOLDEN = dict(m=6_040, n=3_706, nnz=900_000, k=10, iters=3)
NETFLIX = dict(m=480_189, n=17_770, nnz=100_000_000, k=40, iters=3)
ML20M = dict(m=138_493, n=26_744, nnz=20_000_263, k=40, iters=2)
#: a full-width panel (all 17,770 items) of 2^18 users: the size class of
#: the headline stair's first panel; ``check_rows`` rows of it are compared
#: with float64 NumPy
KERNEL = dict(M=262_144, W=17_770, check_rows=8_192)
SOLVE = dict(m=30_000, n=4_000, nnz=1_500_000, k=40)
SERVE = dict(users=1_024, topk=10)
#: the former headline config of the hybrid backend (bench.py)
HEADLINE_FLAGS = ["--backend", "hybrid",
                  "--residual-dtype", "bfloat16", "--mask-dtype", "nan",
                  "--hybrid-cells", "6500000000", "--panel-widths",
                  "4096,2048", "--panel-kernel"]
MULTI_DEVICES = 4
#: The reference's 10% per-entry bar alone flags near-zero factor entries
#: (|x| ~1e-4 of the row norm) wherever two f32 computations sum in another
#: order: ALS's f32 Cholesky against the golden's f32 LU (10 of 37,060 H
#: entries at ml1m dims on the CPU, 11 on the H100), and sharded against
#: single-card runs, whose panel and tail partitions differ (CCD++ at 1/20
#: of Netflix-100M dims on 4 virtual CPU devices: 3 of 711k H entries, RMSE
#: equal to 6 digits). Entries within this absolute distance pass (the test
#: suite's ALS bar); the exact-bar percentage is reported beside it.
GOLDEN_ATOL = 1e-3
#: the headline config's bf16 residual rounds every stored cell at each of
#: the 2k rank updates per iteration; its final RMSE drifted 0.62% from the
#: f32 default after 3 iterations at Netflix dims on the H100 (0.05% after
#: 1, 0.42% after 2)
CCD_CONFIG_RMSE_GAP = 0.01


class SmokeError(AssertionError):
    """A phase's check failed."""


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeError(msg)


class CompileClock:
    """Sums XLA backend compile seconds (JAX's own monitoring event)."""

    EVENT = "/jax/core/compile/backend_compile_duration"

    def __init__(self):
        import jax

        self.total = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on)

    def _on(self, event, duration, **_):
        if event == self.EVENT:
            self.total += duration


def _peak_bytes(dev=None):
    import jax

    stats = (dev or jax.devices()[0]).memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def _past_bar(A, B) -> float:
    """Largest |A - B| among the entries the reference's bare 10% relative
    bar fails — the distance GOLDEN_ATOL has to cover (0 if none)."""
    d = np.abs(np.asarray(A, np.float64) - np.asarray(B, np.float64))
    past = d > 0.1 * np.abs(np.asarray(B, np.float64))
    return float(d[past].max()) if past.any() else 0.0


def _rel(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# --------------------------------------------------------------- phases

def phase_device(state: dict) -> dict:
    import jax

    d = jax.devices()[0]
    check(d.platform == "gpu", f"JAX reports platform {d.platform!r}, "
                               "this smoke test needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    print(smi[0], flush=True)
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices()), "card": smi[0],
            "xla_flags": os.environ.get("XLA_FLAGS", "")}


def _memory(compiled) -> dict:
    ma = compiled.memory_analysis()
    return {k: getattr(ma, k) for k in
            ("argument_size_in_bytes", "output_size_in_bytes",
             "alias_size_in_bytes", "temp_size_in_bytes")
            if hasattr(ma, k)}


def _dyadic(key, n):
    """Factor values on a 1/64 grid: products and the update delta are
    exact in f32, so the stored residual has one correct value whether or
    not the compiler fuses the delta into an FMA."""
    import jax

    return jax.random.randint(key, (n,), -64, 65).astype("float32") / 64


def check_panel_kernels(M: int, W: int, check_rows: int) -> dict:
    """Fused panel kernels at (M, W) bf16 against the plain XLA path, and
    at (check_rows, W) against float64 NumPy."""
    import jax
    import jax.numpy as jnp

    from cuda_recommender_tpu.ops.panel_pallas import (
        panel_update_vsweep, panel_usweep, panel_vsweep)
    from cuda_recommender_tpu.solvers.ccd_hybrid import (panel_col_sums,
                                                         panel_row_sums)

    ks = jax.random.split(jax.random.PRNGKey(0), 6)

    @jax.jit
    def make_panel(k0, k1):          # 5% observed, NaN elsewhere
        return jnp.where(jax.random.uniform(k0, (M, W)) < 0.05,
                         jax.random.normal(k1, (M, W)), jnp.nan
                         ).astype(jnp.bfloat16)

    R = make_panel(ks[0], ks[1])
    uo, up = _dyadic(ks[2], M), _dyadic(ks[3], M)
    vo, vp = _dyadic(ks[4], W), _dyadic(ks[5], W)
    out: dict = {"shape": [M, W]}
    # the plain XLA sweep must stream the panel, not materialize f32
    # operands (temp_size_in_bytes stays far below the panel's size)
    out["memory"] = {
        "panel_update_vsweep": _memory(
            panel_update_vsweep.lower(R, uo, up, vo, vp).compile()),
        "panel_vsweep": _memory(panel_vsweep.lower(R, uo).compile()),
        "panel_usweep": _memory(panel_usweep.lower(R, vo).compile()),
        "xla_panel_col_sums": _memory(
            jax.jit(panel_col_sums).lower(uo, R, None).compile()),
    }

    @jax.jit
    def xla_update(R, uo, up, vo, vp):
        delta = uo[:, None] * vo[None, :] - up[:, None] * vp[None, :]
        return (R.astype(jnp.float32) + delta).astype(R.dtype)

    @jax.jit
    def mismatches(a, b):
        na, nb = jnp.isnan(a), jnp.isnan(b)
        bits = (jax.lax.bitcast_convert_type(a, jnp.uint16)
                != jax.lax.bitcast_convert_type(b, jnp.uint16))
        return jnp.sum(na != nb) + jnp.sum(bits & ~na & ~nb)

    want = xla_update(R, uo, up, vo, vp)
    Rn, g, h = panel_update_vsweep(R, uo, up, vo, vp)
    bad = int(mismatches(Rn, want))
    out["update_bit_mismatches"] = bad
    check(bad == 0, f"panel_update_vsweep residual differs from "
                    f"bf16(f32(R) + delta) in {bad} cells")
    del R, want
    gx, hx = jax.jit(panel_col_sums)(uo, Rn, None)
    gv, hv = panel_vsweep(Rn, uo)
    gu, hu = panel_usweep(Rn, vo)
    gux, hux = jax.jit(panel_row_sums)(Rn, None, vo)
    vs_xla = {"update_vsweep": max(_rel(g, gx), _rel(h, hx)),
              "vsweep": max(_rel(gv, gx), _rel(hv, hx)),
              "usweep": max(_rel(gu, gux), _rel(hu, hux))}
    out["rel_err_vs_xla"] = vs_xla

    # float64 NumPy on the first check_rows rows
    Rs = Rn[:check_rows]
    Rh = np.asarray(Rs.astype(jnp.float32), np.float64)
    mask = ~np.isnan(Rh)
    Rm = np.where(mask, Rh, 0.0)
    u64 = np.asarray(uo[:check_rows], np.float64)
    v64 = np.asarray(vo, np.float64)
    gv, hv = panel_vsweep(Rs, uo[:check_rows])
    gu, hu = panel_usweep(Rs, vo)
    vs_np = {"vsweep": max(_rel(gv, u64 @ Rm), _rel(hv, (u64 * u64) @ mask)),
             "usweep": max(_rel(gu, Rm @ v64), _rel(hu, mask @ (v64 * v64)))}
    out["rel_err_vs_float64"] = vs_np
    for name, err in {**vs_xla, **vs_np}.items():
        check(err <= 1e-4, f"{name}: normwise relative error {err:.3g}")
    return out


def check_als_solve(m: int, n: int, nnz: int, k: int) -> dict:
    """The ALS k×k solve on grams assembled from a synthetic matrix, against
    np.linalg.solve in float64."""
    import jax
    import jax.numpy as jnp

    from cuda_recommender_tpu.core.config import Config
    from cuda_recommender_tpu.data.datasets import synthetic
    from cuda_recommender_tpu.data.ell import build_ell_pair
    from cuda_recommender_tpu.ops.ell_ops import extend_zero
    from cuda_recommender_tpu.solvers.als_ell import _gram_and_rhs, _solve_kxk

    cfg = Config(solver="als", k=k)
    R, _ = synthetic(m, n, nnz, seed=3)
    ell = build_ell_pair(R, min_width=cfg.als_min_width)
    # the rows side gathers the cols side's slot-space factor table
    H = np.random.default_rng(0).normal(
        0, 1 / np.sqrt(k), (ell.cols_side.n_slots, k)).astype(np.float32)
    b = max(ell.rows_side.buckets, key=lambda b: b.E)   # the head bucket
    G = np.asarray(_gram_and_rhs(jnp.asarray(b.idx), jnp.asarray(b.val),
                                 extend_zero(jnp.asarray(H)), b,
                                 cfg.ell_chunk))
    A = G[:, :k, :k] + cfg.lambda_ * np.eye(k, dtype=np.float32)
    r = G[:, :k, k]
    x = np.asarray(jax.jit(_solve_kxk, static_argnums=2)(
        jnp.asarray(A), jnp.asarray(r), cfg.als_solver), np.float64)
    ref = np.linalg.solve(A.astype(np.float64),
                          r.astype(np.float64)[..., None])[..., 0]
    err = (np.linalg.norm(x - ref, axis=1)
           / np.maximum(np.linalg.norm(ref, axis=1), 1e-30))
    worst = float(err.max())
    check(worst <= 1e-4, f"ALS solve ({cfg.als_solver}) relative error "
                         f"{worst:.3g} at k={k}")
    return {"solver": cfg.als_solver, "k": k, "systems": int(A.shape[0]),
            "width": int(b.E), "max_rel_err": worst}


def phase_kernels(state: dict, *, kernel=KERNEL, solve=SOLVE) -> dict:
    return {"panel": check_panel_kernels(**kernel),
            "als_solve": check_als_solve(**solve)}


def phase_golden(state: dict, *, dims=GOLDEN) -> dict:
    """CCD++ must PASS the reference's bar exactly; ALS within GOLDEN_ATOL
    (the exact-bar percentage is reported too)."""
    from cuda_recommender_tpu.core.config import Config, Solver
    from cuda_recommender_tpu.core.init import init_factors_np
    from cuda_recommender_tpu.core.trainer import train
    from cuda_recommender_tpu.data.datasets import synthetic
    from cuda_recommender_tpu.eval.metrics import golden_compare
    from cuda_recommender_tpu.solvers.reference import als_reference

    m, n = dims["m"], dims["n"]
    R, T = synthetic(m, n, dims["nnz"], seed=1)
    base = dict(k=dims["k"], maxiter=dims["iters"], golden=True)
    runs = {
        "ccd_dense": Config(backend="dense", **base),
        "ccd_hybrid": Config(backend="hybrid", hybrid_dense_cells=m * n // 4,
                             **base),
        "ccd_hybrid_panel_kernel": Config(
            backend="hybrid", hybrid_dense_cells=m * n // 4, mask_dtype="nan",
            hybrid_panel_kernel=True, **base),
        "als_ell": Config(solver="als", **base),
    }
    out = state.setdefault("detail", {})
    for name, cfg in runs.items():
        res = train(cfg, R, T)
        gW, gH = res.golden_W, res.golden_H
        rec = out[name] = {"W_err_pct": gW.error_percentage,
                           "H_err_pct": gH.error_percentage,
                           "rmse": res.final_rmse,
                           "ref_rmse": res.ref_final_rmse}
        if cfg.solver == Solver.ALS:
            W0, H0 = init_factors_np(cfg.k, m, n, seed=cfg.seed,
                                     entity_major=True)
            als_reference(R, W0, H0, T, lambda_=cfg.lambda_,
                          maxiter=cfg.maxiter)
            gW = golden_compare(res.W, W0, atol=GOLDEN_ATOL)
            gH = golden_compare(res.H, H0, atol=GOLDEN_ATOL)
            rec.update(atol=GOLDEN_ATOL, max_abs_diff_past_bar=max(
                _past_bar(res.W, W0), _past_bar(res.H, H0)))
        check(gW.passed and gH.passed,
              f"{name}: golden_compare failed "
              f"(W {gW.error_percentage:.4f}%, H {gH.error_percentage:.4f}%)")
    return out


def _train_cli(argv: list, data: tuple, clock: CompileClock, *,
               monotone: bool) -> tuple:
    """One ``cli.train`` run on ``data``; returns (TrainResult, metrics
    dict). ``monotone``: test RMSE must not rise from one iteration to the
    next (held for ALS; see phase_ccd for CCD++)."""
    from cuda_recommender_tpu.cli.train import run

    c0, t0 = clock.total, time.perf_counter()
    res = run(argv, data=data)
    wall = time.perf_counter() - t0
    rmse = [st.rmse for st in res.stats]
    iters = [st.rank_time for st in res.stats]
    loop = sum(st.rank_time + (st.rmse_time or 0.0) for st in res.stats)
    met = {"backend": res.backend, "rmse": rmse,
           "final_rmse": res.final_rmse,
           # iteration 1 carries the step's compilation
           "s_per_iter": float(np.median(iters[1:] or iters)),
           "iter_s": iters,
           "compile_s": clock.total - c0,
           # host planning, layouts and transfers: train time outside the
           # iteration loop
           "setup_s": res.train_time - loop,
           # the CLI's whole run: training and the host-side test RMSE
           "cli_wall_s": wall,
           "peak_bytes_in_use": _peak_bytes()}
    check(all(np.isfinite(rmse)) and np.isfinite(res.final_rmse),
          f"non-finite RMSE {rmse}")
    if monotone:
        check(all(b <= a for a, b in zip(rmse, rmse[1:])),
              f"RMSE increased: {rmse}")
    return res, met


def _data(d: dict, out: dict) -> tuple:
    """The synthetic matrix of ``d``'s dims, generated on the device
    (data/datasets.synthetic_device): the host-side NumPy generator took
    more than ten minutes at 100M ratings on the card's host."""
    from cuda_recommender_tpu.data.datasets import synthetic_device

    t0 = time.perf_counter()
    data = synthetic_device(d["m"], d["n"], d["nnz"], seed=1)
    out["data_s"] = time.perf_counter() - t0
    return data


def phase_ccd(state: dict, *, dims=NETFLIX) -> dict:
    """CCD++'s test RMSE need not fall every iteration: on these synthetic
    matrices it rises at iteration 2 at every scale tried, in the NumPy
    golden solver too (the held-out error of a greedy rank-one fit). So
    each iteration's RMSE must be finite and below the untrained model's
    (H starts at zero, so that model predicts 0), and the two configs must
    agree."""
    out = state.setdefault("detail", {})
    data = _data(dims, out)
    out["untrained_rmse"] = untrained = float(
        np.sqrt(np.mean(data[1].val.astype(np.float64) ** 2)))
    base = ["-k", str(dims["k"]), "-t", str(dims["iters"])]
    res, out["default"] = _train_cli(base, data, state["clock"],
                                     monotone=False)
    state["ccd_factors"] = (res.W, res.H)
    out["headline_flags"] = " ".join(HEADLINE_FLAGS)
    _, out["headline"] = _train_cli(base + HEADLINE_FLAGS, data,
                                    state["clock"], monotone=False)
    default, headline = out["default"], out["headline"]
    for name, met in (("default", default), ("headline", headline)):
        check(max(met["rmse"]) < untrained,
              f"{name}: RMSE {met['rmse']} not below the untrained "
              f"model's {untrained:.4f}")
    gap = out["final_rmse_rel_gap"] = abs(
        headline["final_rmse"] - default["final_rmse"]) / default["final_rmse"]
    check(gap <= CCD_CONFIG_RMSE_GAP,
          f"default and headline configs' final RMSE differ by "
          f"{100 * gap:.3f}%")
    return out


def phase_als(state: dict, *, dims=ML20M) -> dict:
    out = state.setdefault("detail", {})
    data = _data(dims, out)
    _, met = _train_cli(["-ALS", "-k", str(dims["k"]),
                         "-t", str(dims["iters"])], data, state["clock"],
                        monotone=True)
    out.update(met)
    return out


def phase_serve(state: dict, *, users=SERVE["users"],
                topk=SERVE["topk"]) -> dict:
    from cuda_recommender_tpu.serve.retrieval import topk_mips

    check("ccd_factors" in state, "needs the factors trained by phase ccd")
    W, H = state["ccd_factors"]                   # rank-major (k, m), (k, n)
    uid = np.random.default_rng(0).choice(W.shape[1], users, replace=False)
    t0 = time.perf_counter()
    _, items = topk_mips(W, H, uid, topk=topk, entity_major=False)
    seconds = time.perf_counter() - t0
    S = W[:, uid].T.astype(np.float64) @ H.astype(np.float64)
    ref = np.argsort(-S, axis=1, kind="stable")[:, :topk]
    differ = tie_exempt = 0
    for b in range(users):
        extra = set(items[b].tolist()) ^ set(ref[b].tolist())
        if not extra:
            continue
        differ += 1
        edge = S[b, ref[b, -1]]
        if all(abs(S[b, j] - edge) <= 1e-6 * abs(edge) for j in extra):
            tie_exempt += 1
    check(differ == tie_exempt,
          f"{differ - tie_exempt} of {users} users' top-{topk} sets differ "
          "from float64 exact top-k beyond score ties")
    return {"users": users, "topk": topk, "items": int(H.shape[1]),
            "sets_differing": differ, "tie_exempt": tie_exempt,
            "seconds_incl_compile": seconds}


def _row_blocks_ok(n_dev: int) -> dict:
    """Every live array sharded over the mesh must have one distinct row
    block on each card (addressable_shards), not all on the first."""
    import jax

    arrays = 0
    for a in jax.live_arrays():
        sh = a.sharding
        if (a.ndim != 2 or len(sh.device_set) != n_dev
                or sh.is_fully_replicated):
            continue
        shards = a.addressable_shards
        devs = {s.device for s in shards}
        starts = sorted(s.index[0].start or 0 for s in shards)
        rows = a.shape[0] // n_dev
        check(len(devs) == n_dev and starts == [d * rows
                                                for d in range(n_dev)],
              f"array {a.shape} is not split into {n_dev} row blocks on "
              f"{n_dev} cards")
        check(all(s.data.devices() == {s.device} for s in shards),
              "a shard's data lives on another card than its own")
        arrays += 1
    check(arrays > 0, "no row-sharded training state found")
    return {"row_sharded_arrays": arrays}


def _multi_one(name, cfg, R, T, mesh) -> dict:
    """Sharded run against the single-card run from the same init:
    golden_compare PASS within GOLDEN_ATOL and final RMSE within 1e-4
    relative; the training state must be split across the cards."""
    from cuda_recommender_tpu.core.metrics_log import MetricsLog
    from cuda_recommender_tpu.core.trainer import train
    from cuda_recommender_tpu.eval.metrics import golden_compare

    class ShardCheckLog(MetricsLog):
        """Checks the live training state's placement at the first
        iteration line, while the sharded arrays are alive."""

        seen: dict = {}

        def iteration(self, *a, **kw):
            if not self.seen:
                self.seen = _row_blocks_ok(mesh.devices.size)
            super().iteration(*a, **kw)

    t0 = time.perf_counter()
    single = train(cfg, R, T)
    t_single = time.perf_counter() - t0
    log = ShardCheckLog()
    t0 = time.perf_counter()
    sharded = train(cfg, R, T, mesh=mesh, log=log)
    t_sharded = time.perf_counter() - t0
    gW = golden_compare(sharded.W, single.W, atol=GOLDEN_ATOL)
    gH = golden_compare(sharded.H, single.H, atol=GOLDEN_ATOL)
    gap = abs(sharded.final_rmse - single.final_rmse) / single.final_rmse
    out = {"atol": GOLDEN_ATOL,
           "exact_bar_err_pct": [golden_compare(sharded.W, single.W)
                                 .error_percentage,
                                 golden_compare(sharded.H, single.H)
                                 .error_percentage],
           "max_abs_diff": float(max(np.abs(sharded.W - single.W).max(),
                                     np.abs(sharded.H - single.H).max())),
           "max_abs_diff_past_bar": max(_past_bar(sharded.W, single.W),
                                        _past_bar(sharded.H, single.H)),
           "single_rmse": single.final_rmse,
           "sharded_rmse": sharded.final_rmse, "rmse_rel_gap": gap,
           "W_err_pct": gW.error_percentage,
           "H_err_pct": gH.error_percentage,
           "single_train_s": t_single, "sharded_train_s": t_sharded,
           "sharded_s_per_iter": [st.rank_time for st in sharded.stats],
           "peak_bytes_in_use": [_peak_bytes(d) for d in mesh.devices.flat],
           **log.seen}
    check(gW.passed and gH.passed,
          f"{name}: sharded vs single golden_compare failed "
          f"(W {gW.error_percentage:.4f}%, H {gH.error_percentage:.4f}%)")
    check(gap <= 1e-4, f"{name}: final RMSE differs by {gap:.3g} relative")
    return out


def phase_multi(state: dict, *, ccd=NETFLIX, als=ML20M,
                n_dev=MULTI_DEVICES) -> dict:
    import jax

    from cuda_recommender_tpu.core.config import Config
    from cuda_recommender_tpu.parallel.mesh import make_mesh

    check(len(jax.devices()) >= n_dev,
          f"needs {n_dev} cards, JAX sees {len(jax.devices())}")
    mesh = make_mesh(jax.devices()[:n_dev])
    out = state.setdefault("detail", {})
    R, T = _data(ccd, out)
    out["ccd_hybrid"] = _multi_one(
        "ccd_hybrid", Config(k=ccd["k"], maxiter=2, backend="hybrid",
                             hybrid_panel_widths=(4096, 2048)),
        R, T, mesh)
    del R, T
    R, T = _data(als, {})
    out["als_ell"] = _multi_one(
        "als_ell", Config(solver="als", k=als["k"], maxiter=2), R, T, mesh)
    return out


# ----------------------------------------------------------------- main

def run_phases(phases, state: dict) -> bool:
    ok_all = True
    for name, fn in phases:
        t0 = time.perf_counter()
        state["detail"] = {}            # phases may fill it as they go
        try:
            detail = fn(state)
            ok = True
        except Exception as e:  # report, run the next phase, fail at exit
            traceback.print_exc()
            detail = {**state["detail"], "error": f"{type(e).__name__}: {e}"}
            ok = False
        ok_all &= ok
        print(json.dumps({"phase": name, "ok": ok,
                          "seconds": time.perf_counter() - t0,
                          **detail}, default=str), flush=True)
        if name == "device" and not ok:
            break                       # nothing else can run without a GPU
    return ok_all


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--multi", action="store_true",
                   help=f"run the {MULTI_DEVICES}-card sharded path alone")
    args = p.parse_args(argv)

    import jax

    from cuda_recommender_tpu.utils.cache import enable_compile_cache

    if jax.devices()[0].platform != "gpu":
        print(f"chip_smoke: JAX finds no GPU (platform "
              f"{jax.devices()[0].platform!r})", file=sys.stderr)
        return 1
    enable_compile_cache()
    state = {"clock": CompileClock()}
    phases = [("device", phase_device)]
    if args.multi:
        phases.append(("multi", phase_multi))
    else:
        phases += [("kernels", phase_kernels), ("golden", phase_golden),
                   ("ccd", phase_ccd), ("als", phase_als),
                   ("serve", phase_serve)]
    if not run_phases(phases, state):
        return 1
    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
