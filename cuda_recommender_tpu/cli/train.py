"""Train CLI — reference flag semantics on the JAX runtime.

Mirrors the reference CLI (/root/reference/src/extras.cpp:46-141):
``-k -n -l -t -T -e -p -q -N -ALS`` plus positional ``data_dir``; the CUDA
launch-geometry flags (-nBlocks/-nThreadsPerBlock) are accepted and ignored,
and the backend toggles (-CUDA/-OMP) map to: ``--backend`` picks the compiled path
(the CUDA role), ``-OMP``/``--golden`` additionally runs the NumPy golden
solver and cross-validates (the reference's dual-run discipline,
src/main.cpp:109-144).

Data sources: a data_dir containing ``meta_modified_all`` (reference packed
binary, tools.cpp:3-85) or ``meta`` (legacy text, extras.cpp:24-44), or
``--dataset synthetic:m=...,n=...,nnz=...``.
"""

from __future__ import annotations

import argparse
import sys

from ..core.config import Backend, Config, Solver
from ..core.metrics_log import MetricsLog
from ..core.trainer import train
from ..data import datasets


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="cuda_recommender_tpu.cli.train",
        description="CCD++/ALS matrix-factorization trainer (JAX)")
    # reference knobs (src/pmf.h:26-42 defaults)
    p.add_argument("-k", type=int, default=10, help="rank (default 10)")
    p.add_argument("-n", type=int, default=4, dest="threads",
                   help="threads (reference parity; no-op)")
    p.add_argument("-l", type=float, default=0.1, dest="lambda_",
                   help="regularization lambda (default 0.1)")
    p.add_argument("-t", type=int, default=5, dest="maxiter",
                   help="outer iterations (default 5)")
    p.add_argument("-T", type=int, default=1, dest="maxinneriter",
                   help="inner iterations (default 1)")
    p.add_argument("-e", type=float, default=1e-3, dest="eps",
                   help="epsilon; inert like the reference unless "
                        "--early-stop is given")
    p.add_argument("--early-stop", action="store_true", dest="early_stop",
                   help="stop once an outer iteration improves test RMSE by "
                        "less than -e relative (the reference parses -e but "
                        "never uses it; this makes it mean something)")
    p.add_argument("-p", type=int, default=0, dest="do_predict",
                   help="save model + write predictions after training")
    p.add_argument("-q", type=int, default=0, dest="verbose")
    p.add_argument("-N", type=int, default=0, dest="do_nmf",
                   help="nonnegative MF: clamp CCD++ rank-one updates at 0 "
                        "(libpmf semantics; the reference parses -N but "
                        "never uses it)")
    p.add_argument("-ALS", action="store_true", dest="als",
                   help="use ALS instead of CCD++")
    p.add_argument("-OMP", action="store_true", dest="golden",
                   help="also run the golden NumPy backend and cross-validate")
    p.add_argument("-CUDA", action="store_true",
                   help="accepted for reference-script compat (compiled "
                        "backend runs by default)")
    p.add_argument("-nBlocks", type=int, default=32,
                   help="accepted for reference-script compat (XLA and "
                        "the kernels choose their own launch geometry)")
    p.add_argument("-nThreadsPerBlock", type=int, default=256,
                   help="accepted for reference-script compat")
    # runtime
    p.add_argument("--backend", default="auto",
                   choices=[b.value for b in Backend])
    p.add_argument("--golden", action="store_true", dest="golden")
    p.add_argument("--mesh", type=int, default=0, metavar="N",
                   help="shard over an N-device mesh (0 = single device)")
    p.add_argument("--mesh2d", default=None, metavar="AxB",
                   help="2-D (users x items) mesh for the dense CCD backend")
    p.add_argument("--fused-iters", type=int, default=1, dest="fused_iters",
                   help="outer iterations fused per device dispatch")
    p.add_argument("--phase-timing", action="store_true", dest="phase_timing",
                   help="dispatch rank phases separately with fences so the "
                        "iteration line's rank_time/update_time split is a "
                        "real measurement (reference per-phase timers); with "
                        "-q 1 also prints per-rank residual RMSE")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--residual-dtype", default="float32",
                   choices=["float32", "bfloat16", "float8_e4m3fn"])
    p.add_argument("--mask-dtype", default="bfloat16",
                   choices=["bfloat16", "int8", "nan"],
                   help="panel/dense mask storage ({0,1} exact in both; "
                        "int8 halves its HBM footprint; 'nan' stores no "
                        "mask — unobserved cells are NaN in the residual)")
    p.add_argument("--hybrid-cells", type=int, default=None, metavar="N",
                   help="hybrid panel-stair cell budget "
                        "(default Config.hybrid_dense_cells)")
    p.add_argument("--panel-widths", default=None, metavar="W1,W2|auto",
                   help="hybrid panel-stair widths: comma list (e.g. "
                        "'4096,2048') or 'auto' for the data-driven "
                        "Lagrangian stair chosen from the degree "
                        "distribution under --hybrid-cells")
    p.add_argument("--panel-kernel", action="store_true", dest="panel_kernel",
                   help="run the hybrid backend's dense panels through the "
                        "fused Pallas (Triton) kernels (requires --mask-dtype "
                        "nan; single-device or sharded)")
    p.add_argument("--transpose-stair", default=None, metavar="0|1|auto",
                   dest="transpose_stair",
                   help="hybrid stair orientation: 1 plans panels over top-"
                        "ITEMS x user prefixes (the transposed matrix), "
                        "'auto' geometry-plans both and keeps the smaller "
                        "uncovered tail (single-device hybrid only)")
    p.add_argument("--als-min-width", default=None, metavar="W|auto",
                   dest="als_min_width",
                   help="ALS ELL bucket width floor: integer or 'auto' for "
                        "the degree-adaptive floor (default "
                        "Config.als_min_width)")
    p.add_argument("--als-group-mb", type=int, default=None, metavar="MB",
                   dest="als_group_mb",
                   help="per-group HBM temp budget for the grouped ALS "
                        "gram assembly (counts tile-padded temp bytes)")
    p.add_argument("--als-gather-tile-mb", type=float, default=None,
                   metavar="MB", dest="als_gather_tile_mb",
                   help="gather-cliff tiling threshold: an ALS side whose "
                        "other side's factor table exceeds this gathers "
                        "per table tile (0 disables; default "
                        "Config.als_gather_tile_mb)")
    p.add_argument("--defer-group", type=int, default=None, metavar="G",
                   help="hybrid ELL-tail rank-deferral group (0 disables; "
                        "default Config.hybrid_defer_group; single-device "
                        "hybrid only — rejected with --mesh/--mesh2d)")
    # io
    p.add_argument("data_dir", nargs="?", default=None)
    p.add_argument("--dataset", default=None,
                   help="synthetic:m=...,n=...,nnz=...[,seed=...] generator")
    p.add_argument("--save-model", default=None, metavar="PATH",
                   help="write trained factors (reference save_mat_t format)")
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--checkpoint-every", type=int, default=0)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--metrics-file", default=None, help="JSONL metrics sink")
    return p


def load_data(args):
    import os
    if args.dataset:
        return datasets.synthetic_from_spec(args.dataset)
    if not args.data_dir:
        raise SystemExit("need a data_dir or --dataset spec")
    from ..data import binfmt
    if os.path.exists(os.path.join(args.data_dir, "meta_modified_all")):
        return binfmt.load_binary_dataset(args.data_dir)
    if os.path.exists(os.path.join(args.data_dir, "meta")):
        return binfmt.load_meta_text_dataset(args.data_dir)
    raise SystemExit(f"no meta_modified_all or meta manifest in {args.data_dir}")


def run(argv=None, *, data=None):
    """Parse ``argv``, train, write the requested outputs, and return the
    ``TrainResult`` (``main`` is the process entry point). ``data``: an
    already loaded ``(RatingMatrix, TestCOO)`` to train on in place of
    ``--dataset`` / ``data_dir``."""
    from ..utils.cache import enable_compile_cache

    args = build_parser().parse_args(argv)
    enable_compile_cache()
    cfg = Config(
        solver=Solver.ALS if args.als else Solver.CCD,
        k=args.k, maxiter=args.maxiter, maxinneriter=args.maxinneriter,
        lambda_=args.lambda_, eps=args.eps, do_predict=bool(args.do_predict),
        verbose=bool(args.verbose), do_nmf=bool(args.do_nmf),
        threads=args.threads, backend=Backend(args.backend),
        golden=args.golden, seed=args.seed, early_stop=args.early_stop,
        residual_dtype=args.residual_dtype, data_dir=args.data_dir,
        mask_dtype=args.mask_dtype,
        fused_outer_iters=args.fused_iters,
        phase_timing=args.phase_timing,
        hybrid_panel_kernel=args.panel_kernel,
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every,
        metrics_file=args.metrics_file,
    )
    if args.hybrid_cells is not None:
        cfg.hybrid_dense_cells = int(args.hybrid_cells)
    if args.defer_group is not None:
        cfg.hybrid_defer_group = int(args.defer_group)
    if args.transpose_stair is not None:
        cfg.hybrid_transpose = ("auto" if args.transpose_stair == "auto"
                                else bool(int(args.transpose_stair)))
    if args.als_min_width is not None:
        cfg.als_min_width = ("auto" if args.als_min_width == "auto"
                             else int(args.als_min_width))
    if args.als_group_mb is not None:
        cfg.als_group_mb = int(args.als_group_mb)
    if args.als_gather_tile_mb is not None:
        cfg.als_gather_tile_mb = float(args.als_gather_tile_mb)
    if args.panel_widths is not None:
        cfg.hybrid_panel_widths = (
            "auto" if args.panel_widths == "auto" else
            tuple(int(w) for w in args.panel_widths.split(",") if w))
    R, T = data if data is not None else load_data(args)
    print(f"[info] loaded {R.rows} x {R.cols}, nnz={R.nnz}, "
          f"test nnz={T.nnz}", flush=True)

    mesh = None
    if args.mesh2d:
        from ..parallel.mesh import make_mesh_2d
        a, b = (int(x) for x in args.mesh2d.lower().split("x"))
        mesh = make_mesh_2d((a, b))
    elif args.mesh:
        import jax
        from ..parallel.mesh import make_mesh
        mesh = make_mesh(jax.devices()[:args.mesh])
    if mesh is not None and cfg.hybrid_defer_group > 0:
        # ccd_hybrid_train_sharded never reads hybrid_defer_group — only the
        # single-device path passes it to make_hybrid_outer_step. Fail loud
        # instead of silently running the undeferred schedule.
        raise SystemExit("--defer-group is single-device-only: the sharded "
                         "hybrid path does not implement rank deferral "
                         "(pass --defer-group 0 or drop --mesh/--mesh2d)")

    log = MetricsLog(cfg.metrics_file)
    result = train(cfg, R, T, mesh=mesh, log=log,
                   resume_from_checkpoint=args.resume)

    if args.save_model or cfg.do_predict:
        from ..data.binfmt import save_model
        path = args.save_model or "model"
        save_model(path, result.W, result.H,
                   entity_major=result.entity_major)
        print(f"[info] model saved to {path}", flush=True)
        if cfg.do_predict:
            from ..serve.scoring import predict_pairs
            pred = predict_pairs(result.W, result.H, T.row_idx, T.col_idx,
                                 entity_major=result.entity_major)
            with open("output", "w") as f:
                for v in pred:
                    f.write("%f\n" % v)
            print("[info] predictions written to ./output", flush=True)
    log.close()
    return result


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
