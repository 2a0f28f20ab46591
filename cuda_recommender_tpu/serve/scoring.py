"""Batch scoring + prediction-file serving.

Expands the reference's (disabled) predict path — save_mat_t model reload +
per-line test scoring + output file + final RMSE (calculate_rmse_from_file,
/root/reference/src/extras.cpp:143-180, call sites commented at
src/main.cpp:146-149) — into a real on-device batch scorer. Score batches are
(B, k) x (k, n) matmuls; pair scoring gathers factor rows and reduces.
"""

from __future__ import annotations

import time

import jax
import jax.numpy as jnp
import numpy as np

from ..data.binfmt import load_model
from ..data.datasets import load_text_ratings

#: Scores are true f32 products: at the GPU's default matmul precision
#: (TF32) trained factors' top-10 sets differed from float64 exact top-k for
#: every user of a 1,024-user batch (their scores sit ~1e-3 apart).
SCORE_PRECISION = jax.lax.Precision.HIGHEST


def as_entity_major(W: np.ndarray, H: np.ndarray, entity_major: bool):
    """Normalize either reference layout to entity-major (m,k)/(n,k)."""
    if entity_major:
        return np.asarray(W, np.float32), np.asarray(H, np.float32)
    return (np.ascontiguousarray(np.asarray(W, np.float32).T),
            np.ascontiguousarray(np.asarray(H, np.float32).T))


@jax.jit
def predict_pairs_device(W_em: jnp.ndarray, H_em: jnp.ndarray,
                         ui: jnp.ndarray, ij: jnp.ndarray) -> jnp.ndarray:
    """Scores for (user, item) id pairs; entity-major factors."""
    return jnp.einsum("ek,ek->e", jnp.take(W_em, ui, axis=0),
                      jnp.take(H_em, ij, axis=0),
                      preferred_element_type=jnp.float32,
                      precision=SCORE_PRECISION)


def predict_pairs(W, H, ui, ij, *, entity_major: bool,
                  chunk: int = 1 << 20) -> np.ndarray:
    """Host API: chunked pair scoring (arbitrary nnz, fixed device shapes)."""
    W_em, H_em = as_entity_major(W, H, entity_major)
    Wd, Hd = jnp.asarray(W_em), jnp.asarray(H_em)
    ui = np.asarray(ui, np.int32)
    ij = np.asarray(ij, np.int32)
    out = np.empty(ui.shape[0], np.float32)
    for lo in range(0, ui.shape[0], chunk):
        hi = min(lo + chunk, ui.shape[0])
        n = hi - lo
        pad = (-n) % 1024 if n < chunk else 0
        u = np.pad(ui[lo:hi], (0, pad))
        j = np.pad(ij[lo:hi], (0, pad))
        out[lo:hi] = np.asarray(
            predict_pairs_device(Wd, Hd, jnp.asarray(u), jnp.asarray(j)))[:n]
    return out


def score_users(W, H, user_ids, *, entity_major: bool) -> np.ndarray:
    """Full score rows for a user batch: (B, n) = U_batch @ H^T."""
    W_em, H_em = as_entity_major(W, H, entity_major)
    U = jnp.take(jnp.asarray(W_em), jnp.asarray(np.asarray(user_ids, np.int32)),
                 axis=0)
    S = jnp.einsum("bk,nk->bn", U, jnp.asarray(H_em),
                   preferred_element_type=jnp.float32,
                   precision=SCORE_PRECISION)
    return np.asarray(S)


def predict_to_file(model_path: str, test_path: str, output_path: str, *,
                    entity_major_model: bool = True) -> float:
    """Reference predict-path parity (calculate_rmse_from_file,
    src/extras.cpp:143-180): load a save_mat_t model file, score a 1-based
    text test file, write one '%lf'-style prediction per line, print and
    return the final RMSE."""
    start = time.perf_counter()
    W, H = load_model(model_path, entity_major=entity_major_model)
    r, c, v = load_text_ratings(test_path, one_based=True)   # src/extras.cpp:166
    if r.shape[0] == 0:
        raise ValueError("empty test file")
    pred = predict_pairs(W, H, r, c, entity_major=True)
    with open(output_path, "w") as f:
        for p in pred:
            f.write("%f\n" % p)
    rmse = float(np.sqrt(np.mean((pred.astype(np.float64) - v) ** 2)))
    print("[FINAL INFO] Test RMSE = %f. Calculated in %fs"
          % (rmse, time.perf_counter() - start), flush=True)
    return rmse
