"""cuda_recommender_tpu — matrix-factorization recommender on JAX.

A from-scratch JAX/XLA re-design of the capabilities of
Zialus/CUDA-Recommender (CCD++ and ALS rating-matrix factorization with
dual-backend golden validation, per-iteration RMSE telemetry, reference
binary dataset/model formats, benchmark sweeps, and a serving path), run on
NVIDIA GPUs: dense-residual / panel-hybrid / padded-ELL sweeps, Pallas
(Triton) panel kernels, batched gram assembly and solves, shard_map
execution over device meshes, and streaming MIPS top-k retrieval.

Quick start::

    from cuda_recommender_tpu import Config, train
    from cuda_recommender_tpu.data.datasets import synthetic

    R, T = synthetic(m=6040, n=3706, nnz=900_000, seed=1)
    result = train(Config(k=10, maxiter=5, lambda_=0.05, golden=True), R, T)
"""

from .core.config import Backend, Config, Solver          # noqa: F401
from .core.trainer import TrainResult, train              # noqa: F401
from .models.mf import MFModel, get_train_fn              # noqa: F401

__version__ = "0.1.0"
