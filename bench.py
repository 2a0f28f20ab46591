"""Headline benchmark: prints ONE JSON line.

CCD++ on the panel-hybrid backend at Netflix-100M dims (480,189 users x
17,770 items, 100M ratings, k=40), in the headline panel config: bf16
NaN-sentinel residual, a 6.5e9-cell stair of widths (4096, 2048), and the
Pallas panel kernels. The value is rating-updates per second (nnz · k per
outer iteration); the seconds per outer iteration are the median over the
iterations after the first, each ending in ``jax.block_until_ready`` (the
training loop's own timing, solvers/pipeline.py). The first iteration
carries the step's compilation.

    python bench.py              # needs a GPU
    python bench.py --cpu-smoke  # tiny run, any device

The record names the device it ran on. Without ``--cpu-smoke`` the script
refuses to run on a CPU.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402

#: (m, n, nnz, k, hybrid_dense_cells, panel widths)
HEADLINE = (480_189, 17_770, 100_000_000, 40, 6_500_000_000, (4096, 2048))
CPU_SMOKE = (1_000, 600, 30_000, 8, 400 * 600, (256, 128))
#: outer iterations: the first carries compilation, the rest are timed
ITERS = 5


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="CCD++ hybrid headline bench")
    p.add_argument("--cpu-smoke", action="store_true",
                   help="tiny run, allowed on any device")
    args = p.parse_args(argv)

    import jax

    from cuda_recommender_tpu.core.config import Config
    from cuda_recommender_tpu.core.init import init_factors_np
    from cuda_recommender_tpu.data.datasets import synthetic_device
    from cuda_recommender_tpu.solvers.ccd_hybrid import (ccd_hybrid_train,
                                                         plan_hybrid)
    from cuda_recommender_tpu.utils.cache import enable_compile_cache

    dev = jax.devices()[0]
    if dev.platform == "cpu" and not args.cpu_smoke:
        print("bench.py: no GPU found; pass --cpu-smoke for a tiny CPU run",
              file=sys.stderr)
        return 2
    enable_compile_cache()
    m, n, nnz, k, budget, widths = CPU_SMOKE if args.cpu_smoke else HEADLINE

    t0 = time.perf_counter()
    R, T = synthetic_device(m, n, nnz, seed=1, test_fraction=0.02)
    data_s = time.perf_counter() - t0
    cfg = Config(k=k, maxiter=ITERS, lambda_=0.05, backend="hybrid",
                 residual_dtype="bfloat16", mask_dtype="nan",
                 hybrid_dense_cells=budget, hybrid_panel_widths=widths,
                 hybrid_panel_kernel=True)
    t0 = time.perf_counter()
    plan = plan_hybrid(R, cfg, materialize_dense=False)
    plan_s = time.perf_counter() - t0
    W0, H0 = init_factors_np(k, m, n, seed=0)
    t0 = time.perf_counter()
    _, _, stats = ccd_hybrid_train(R, W0, H0, T, cfg, plan=plan)
    train_s = time.perf_counter() - t0
    iters = [st.rank_time for st in stats]
    dt = float(np.median(iters[1:] or iters))
    mem = dev.memory_stats() or {}
    print(json.dumps({
        "metric": "ccd_netflix_scale_throughput",
        "value": R.nnz * k / dt / 1e6,
        "unit": "M rating-updates/s/device",
        "detail": {
            "device": {"platform": dev.platform, "kind": dev.device_kind,
                       "count": len(jax.devices())},
            "dataset": f"synthetic zipf {m}x{n}, nnz={R.nnz}",
            "config": {"k": k, "residual_dtype": "bfloat16",
                       "mask_dtype": "nan", "hybrid_dense_cells": budget,
                       "panel_widths": list(widths), "panel_kernel": True},
            "outer_iter_s": dt, "iter_s": iters,
            "first_iter_s_incl_compile": iters[0],
            "data_s": data_s, "plan_s": plan_s, "train_s": train_s,
            "panels": [list(p) for p in plan.panels],
            "nnz_light_frac": plan.nnz_light / R.nnz,
            "rmse": [st.rmse for st in stats],
            "peak_bytes_in_use": mem.get("peak_bytes_in_use"),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
