"""Device timing + phase spans.

Plays the reference's GpuTimer/omp_get_wtime telemetry role
(/root/reference/cuda_src/CUDA_AUX.h:26-56, src/CCD.cpp:76-139). JAX
dispatches asynchronously, so every measurement here waits for its result
with ``jax.block_until_ready`` before reading the clock.
"""

from __future__ import annotations

import contextlib
import time

import jax
import numpy as np


def sync(x) -> None:
    """Wait until every array in ``x`` has been computed."""
    jax.block_until_ready(x)


def timeit(fn, *args, iters: int = 3, warmup: int = 1) -> float:
    """Median wall seconds per call, each call waited for."""
    for _ in range(warmup):
        sync(fn(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        sync(fn(*args))
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


class Phases:
    """Named accumulating phase timers (rank_time / update_time style,
    src/CCD.cpp:76-139)."""

    def __init__(self):
        self.acc: dict[str, float] = {}
        self.last: dict[str, float] = {}

    @contextlib.contextmanager
    def span(self, name: str, result=None):
        t0 = time.perf_counter()
        yield
        if result is not None:
            sync(result)
        dt = time.perf_counter() - t0
        self.last[name] = dt
        self.acc[name] = self.acc.get(name, 0.0) + dt

    def line(self) -> str:
        return " ".join(f"{k} {self.last.get(k, 0.0):.4f}|{v:.4f}s"
                        for k, v in self.acc.items())


def profile_trace(logdir: str):
    """jax.profiler trace context (NSight-equivalent hook; SURVEY.md §5)."""
    return jax.profiler.trace(logdir)
