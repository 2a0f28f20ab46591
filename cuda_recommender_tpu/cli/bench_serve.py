"""Serving benchmark: MIPS top-k retrieval QPS + recall@k.

The serving harness: train (or load) factors, then measure streaming top-k retrieval throughput over the item
table and recall@k against held-out interactions. Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="cuda_recommender_tpu.cli.bench_serve")
    p.add_argument("--model", default=None,
                   help="saved model file; default trains ALS on synthetic")
    p.add_argument("--dataset", default="synthetic:m=69878,n=10677,nnz=5000000")
    p.add_argument("--topk", type=int, default=10)
    p.add_argument("--batch", type=int, default=1024)
    p.add_argument("--chunk", type=int, default=2048)
    p.add_argument("--queries", type=int, default=8192)
    p.add_argument("--int8", action="store_true",
                   help="int8-quantized item table (4x smaller device "
                        "footprint; per-item scales, dequantized in-register)")
    p.add_argument("--rel-threshold", type=float, default=4.0,
                   help="held-out items with rating >= this count as "
                        "relevant (rating-MF retrieves by predicted rating, "
                        "so 'was rated at all' would measure popularity, "
                        "which rating factors do not encode)")
    p.add_argument("--rank", type=int, default=16,
                   help="factor rank when training / generating factors")
    p.add_argument("--random-factors", action="store_true",
                   help="skip training and recall: seeded Gaussian factors, "
                        "pure-QPS mode for large-catalog scaling runs "
                        "(retrieval cost is independent of factor values)")
    p.add_argument("--latency", action="store_true",
                   help="per-query latency mode: serve --queries SEQUENTIAL "
                        "single-user queries through the device-resident "
                        "RetrievalEngine (serve/engine.py) with a full fence "
                        "per query; reports p50/p99 ms instead of batch QPS")
    args = p.parse_args(argv)

    import jax
    import jax.numpy as jnp

    from ..utils.cache import enable_compile_cache

    enable_compile_cache()

    from ..core.config import Config
    from ..core.init import init_factors_np
    from ..data import datasets
    from ..eval.ranking import recall_at_k
    from ..serve.retrieval import topk_mips, topk_mips_device
    from ..solvers.als_ell import als_ell_train

    R, T = datasets.synthetic_from_spec(args.dataset)

    if args.model:
        from ..data.binfmt import load_model
        W, H = load_model(args.model, entity_major=True)
        if W.shape[0] != R.rows or H.shape[0] != R.cols:
            raise SystemExit(
                f"model dims ({W.shape[0]} users x {H.shape[0]} items) do "
                f"not match --dataset ({R.rows} x {R.cols}); recall@k would "
                f"be meaningless — pass the matching --dataset spec/dir")
    elif args.random_factors:
        rng = np.random.default_rng(0)
        W = rng.standard_normal((R.rows, args.rank)).astype(np.float32)
        H = rng.standard_normal((R.cols, args.rank)).astype(np.float32)
    else:
        W0, H0 = init_factors_np(args.rank, R.rows, R.cols, seed=0,
                                 entity_major=True)
        cfg = Config(solver="als", k=args.rank, maxiter=4, lambda_=0.05,
                     fused_outer_iters=4)
        W, H, _ = als_ell_train(R, W0, H0, T, cfg)

    n, k = H.shape

    if args.latency:
        from ..serve.engine import RetrievalEngine
        eng = RetrievalEngine(W, H, int8=args.int8)
        eng.warmup(topk=args.topk)
        rng = np.random.default_rng(0)
        users = rng.integers(0, W.shape[0], args.queries)
        lat = np.empty(args.queries)
        t_all = time.perf_counter()
        for q, uid in enumerate(users):
            t0 = time.perf_counter()
            eng.query(user=int(uid), topk=args.topk)   # np readback = fence
            lat[q] = time.perf_counter() - t0
        wall = time.perf_counter() - t_all
        p50, p99 = np.percentile(lat, [50, 99])
        print(json.dumps({
            "metric": f"mips_top{args.topk}_p50_latency",
            "value": round(float(p50) * 1e3, 3),
            "unit": "ms/query",
            "vs_baseline": 0.0,
            "detail": {"p99_ms": round(float(p99) * 1e3, 3),
                       "mean_ms": round(float(lat.mean()) * 1e3, 3),
                       "sequential_qps": round(args.queries / wall, 1),
                       "queries": args.queries, "items": n, "rank": k,
                       "int8": bool(args.int8),
                       "device": _device(jax),
                       "note": "sequential single queries, each ending in "
                               "a host readback"},
        }))
        return 0

    pad = (-n) % args.chunk
    Hp = np.pad(H.astype(np.float32), ((0, pad), (0, 0)))
    if args.int8:
        from ..serve.retrieval import quantize_item_table, topk_mips_device_int8
        Hq, scale = quantize_item_table(Hp)
        Hqd, scd = jnp.asarray(Hq), jnp.asarray(scale)

        def run_batch(U):
            return topk_mips_device_int8(U, Hqd, scd, topk=args.topk,
                                         chunk=args.chunk)
    else:
        Hd = jnp.asarray(Hp)

        def run_batch(U):
            return topk_mips_device(U, Hd, topk=args.topk, chunk=args.chunk)
    rng = np.random.default_rng(0)
    users = rng.integers(0, W.shape[0], args.queries).astype(np.int64)

    # one warmup batch compiles the streaming kernel
    U0 = jnp.asarray(W[users[:args.batch]].astype(np.float32))
    jax.block_until_ready(run_batch(U0))

    t0 = time.perf_counter()
    done = 0
    while done < args.queries:
        b = users[done:done + args.batch]
        if len(b) < args.batch:
            b = np.pad(b, (0, args.batch - len(b)))
        U = jnp.asarray(W[b].astype(np.float32))
        out = run_batch(U)
        done += args.batch
    jax.block_until_ready(out)
    dt = time.perf_counter() - t0
    qps = args.queries / dt

    if args.random_factors:
        rec = None          # untrained factors — recall would be noise
    else:
        # recall@k on a sample of users, relevance = high-rated held-out items
        hi = T.val >= args.rel_threshold
        sample = np.unique(T.row_idx[hi])[:512]
        relevant = [T.col_idx[hi][T.row_idx[hi] == u] for u in sample]
        exclude = {int(u): R.csr_idx[R.csr_ptr[u]:R.csr_ptr[u + 1]]
                   for u in sample}
        _, items = topk_mips(W, H, sample, topk=args.topk, chunk=args.chunk,
                             exclude=exclude, int8=args.int8)
        rec = recall_at_k(items, relevant)

    print(json.dumps({
        "metric": f"mips_top{args.topk}_qps",
        "value": round(qps, 1),
        "unit": "queries/s/chip",
        "vs_baseline": 0.0 if rec is None else round(rec, 4),
        "detail": {"recall_at_k": None if rec is None else round(rec, 4),
                   "topk": args.topk,
                   "items": n, "rank": k, "batch": args.batch,
                   "int8": bool(args.int8),
                   "device": _device(jax),
                   "note": "vs_baseline field carries recall@k (reference "
                           "has no serving benchmark)"},
    }))
    return 0


def _device(jax) -> dict:
    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


if __name__ == "__main__":
    sys.exit(main())
