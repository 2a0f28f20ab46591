"""Shared async-pipelined training loop.

All compiled backends drive the same host loop: enqueue ``fuse`` (step, rmse)
dispatch pairs back-to-back (device work overlaps host dispatch), then block
once per group on the tiny RMSE readbacks. Timing: the blocking readback happens BEFORE the group's
wall-clock is split across its iterations, so rank_time reflects real device
execution, not just dispatch.

Telemetry split: ``do_step`` may return a fence-able
device value (every backend returns its new W). The flush first blocks on
the LAST step's token — transitively all enqueued solver work plus all but
the final RMSE eval — then on the RMSE readbacks, so the iteration line
carries a MEASURED rank_time (solver work) and rmse_time (the final eval +
readback) instead of folding the eval into rank_time. With ``fuse`` > 1
only the group's final eval lands in rmse_time (the interior evals overlap
solver work by design); update_time stays 0 in this loop — the fused rank
body cannot split sweep vs residual phases without per-phase fences, which
is exactly what ``--phase-timing`` (phase_loop.py) exists for."""

from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np

from .reference import IterStats, early_stopped  # noqa: F401  (re-export)


def pipelined_loop(*, start_oiter: int, maxiter: int, fuse: int,
                   do_step: Callable[[], object],
                   do_rmse: Callable[[], object],
                   callback: Optional[Callable[[IterStats], None]] = None,
                   ckpt_every: int = 0, ckpt_fn=None,
                   get_payload: Optional[Callable[[], dict]] = None,
                   early_stop_eps: float = 0.0,
                   ) -> list[IterStats]:
    """``early_stop_eps`` > 0 ends the loop once the relative RMSE
    improvement drops below it — checked at flush boundaries, so with
    ``fuse`` > 1 up to fuse-1 extra iterations may run before the stop."""
    import jax

    fuse = max(1, fuse)
    stats: list[IterStats] = []
    pending: list[tuple[int, object]] = []
    last_tok: list = [None]

    def flush(t0: float) -> float:
        if not pending:
            return t0
        # fence the solver work first (see module docstring), then the
        # RMSE readbacks, so rank_time / rmse_time are separately measured
        if last_tok[0] is not None:
            jax.block_until_ready(last_tok[0])
        t_solver = time.perf_counter()
        vals = [(o, float(np.asarray(r))) for o, r in pending]
        t_end = time.perf_counter()
        n = len(pending)
        dt_rank = (t_solver - t0) / n
        dt_rmse = (t_end - t_solver) / n
        for o, v in vals:
            st = IterStats(oiter=o, rmse=v, rank_time=dt_rank,
                           rmse_time=dt_rmse)
            stats.append(st)
            if callback:
                callback(st)
        pending.clear()
        return time.perf_counter()

    t0 = time.perf_counter()
    for oiter in range(start_oiter, maxiter + 1):
        last_tok[0] = do_step()
        pending.append((oiter, do_rmse()))
        at_ckpt = bool(ckpt_every) and oiter % ckpt_every == 0
        if len(pending) >= fuse or at_ckpt or oiter == maxiter:
            t0 = flush(t0)
            if early_stopped(stats, early_stop_eps):
                break
        if at_ckpt and ckpt_fn and get_payload is not None:
            ckpt_fn(oiter, get_payload())
    return stats
