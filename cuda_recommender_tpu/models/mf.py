"""Matrix-factorization model artifact + solver/backend registry.

The reference has no model abstraction — factors are bare MatData vectors
threaded through main() (/root/reference/src/main.cpp:60-66). Here the trained
factorization is a first-class pytree artifact carrying its layout metadata,
usable directly by the serving stack and (de)serializable in the reference's
save_mat_t byte format (src/tools.cpp:90-153).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

from ..core.config import Backend, Solver
from ..data.binfmt import load_model, save_model


@dataclasses.dataclass
class MFModel:
    """Trained factorization R ≈ W Hᵀ (entity-major factors)."""

    W: np.ndarray          # (m, k) user factors
    H: np.ndarray          # (n, k) item factors
    solver: str = "ccd"

    @property
    def k(self) -> int:
        return int(self.W.shape[1])

    @property
    def num_users(self) -> int:
        return int(self.W.shape[0])

    @property
    def num_items(self) -> int:
        return int(self.H.shape[0])

    @classmethod
    def from_factors(cls, W, H, *, entity_major: bool,
                     solver: str = "ccd") -> "MFModel":
        if not entity_major:       # CCD rank-major (k, n) -> entity-major
            W, H = np.ascontiguousarray(np.asarray(W).T), \
                np.ascontiguousarray(np.asarray(H).T)
        return cls(W=np.asarray(W, np.float32), H=np.asarray(H, np.float32),
                   solver=solver)

    def predict(self, user_ids, item_ids) -> np.ndarray:
        from ..serve.scoring import predict_pairs
        return predict_pairs(self.W, self.H, user_ids, item_ids,
                             entity_major=True)

    def recommend(self, user_ids, *, topk: int = 10, exclude=None, mesh=None):
        """Top-k MIPS retrieval; pass a mesh to shard the item table."""
        if mesh is not None:
            from ..serve.retrieval_sharded import topk_mips_sharded
            return topk_mips_sharded(self.W, self.H, user_ids, mesh,
                                     topk=topk, exclude=exclude)
        from ..serve.retrieval import topk_mips
        return topk_mips(self.W, self.H, user_ids, topk=topk, exclude=exclude)

    def save(self, path: str) -> None:
        save_model(path, self.W, self.H, entity_major=True)

    @classmethod
    def load(cls, path: str, solver: str = "ccd") -> "MFModel":
        W, H = load_model(path, entity_major=True)
        return cls(W=W, H=H, solver=solver)


def get_train_fn(solver: Solver, backend: Backend, *,
                 sharded: bool = False) -> Callable:
    """Registry lookup: (solver, backend, sharded) -> train callable with the
    common signature (R, W0, H0, T, cfg, ...) -> (W, H, stats)."""
    solver, backend = Solver(solver), Backend(backend)
    if solver == Solver.ALS:
        if sharded:
            from ..parallel.als_ell_sharded import als_ell_train_sharded
            return als_ell_train_sharded
        from ..solvers.als_ell import als_ell_train
        return als_ell_train
    if backend == Backend.REF:
        from ..solvers.reference import ccd_reference
        return ccd_reference
    if backend == Backend.DENSE:
        from ..solvers.ccd_dense import ccd_dense_train
        return ccd_dense_train
    if backend == Backend.HYBRID:
        if sharded:
            from ..parallel.ccd_hybrid_sharded import ccd_hybrid_train_sharded
            return ccd_hybrid_train_sharded
        from ..solvers.ccd_hybrid import ccd_hybrid_train
        return ccd_hybrid_train
    if sharded:
        from ..parallel.ccd_ell_sharded import ccd_ell_train_sharded
        return ccd_ell_train_sharded
    from ..solvers.ccd_ell import ccd_ell_train
    return ccd_ell_train
