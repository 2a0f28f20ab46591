"""Evaluation: test RMSE, training loss, golden comparison.

Parity targets in the reference:
  * calrmse        /root/reference/src/tools.cpp:235-248  (fp64 accumulation)
  * calrmse_r1     /root/reference/src/tools.cpp:250-270  (residual-RMSE trick;
    the reference mutates the test values in place — here it returns them)
  * calloss        /root/reference/src/tools.cpp:223-233
  * calculate_rmse_directly  /root/reference/src/extras.cpp:182-216
  * golden_compare /root/reference/src/extras.cpp:218-238 (10% relative/entry)
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..data.sparse import RatingMatrix, TestCOO

GOLDEN_RTOL = 0.1   # src/extras.cpp:223


def default_eval_chunk(nnz: int, cap: int = 1 << 20) -> int:
    """Chunk size for calrmse_device: the smallest power of two >= nnz
    (floor 1024) capped at ``cap`` — bounds padding waste for small test sets
    and device-memory pressure for large ones."""
    return min(cap, 1 << max(10, (max(1, int(nnz)) - 1).bit_length()))


def _dots_np(W, H, ti, tj, entity_major: bool) -> np.ndarray:
    if entity_major:        # ALS layout (n, k): pred = W[i]·H[j]
        return np.einsum("ek,ek->e", W[ti].astype(np.float64),
                         H[tj].astype(np.float64))
    # CCD layout (k, n): pred = Σ_t W[t,i] H[t,j]
    return np.einsum("ke,ke->e", W[:, ti].astype(np.float64),
                     H[:, tj].astype(np.float64))


def calrmse_np(T: TestCOO, W: np.ndarray, H: np.ndarray, *,
               entity_major: bool) -> float:
    """Test RMSE with fp64 accumulation (reference calrmse / fp64 rmse sums at
    src/extras.cpp:185-209)."""
    pred = _dots_np(W, H, T.row_idx, T.col_idx, entity_major)
    err = pred - T.val.astype(np.float64)
    return float(np.sqrt(np.mean(err * err)))


def calrmse_r1_np(T: TestCOO, test_vals: np.ndarray, Wt: np.ndarray,
                  Ht: np.ndarray) -> tuple[float, np.ndarray]:
    """Rank-one incremental residual RMSE (calrmse_r1, src/tools.cpp:250-259).
    Functional version: returns (rmse, updated residual test values)."""
    resid = test_vals - Wt[T.row_idx] * Ht[T.col_idx]
    return float(np.sqrt(np.mean(resid.astype(np.float64) ** 2))), resid


def calloss_np(R: RatingMatrix, W: np.ndarray, H: np.ndarray, *,
               entity_major: bool) -> float:
    """Squared training loss over observed entries (calloss)."""
    r, c, v = R.to_coo()
    pred = _dots_np(W, H, r, c, entity_major)
    d = pred - v.astype(np.float64)
    return float(np.sum(d * d))


def calrmse_device(test_i: jnp.ndarray, test_j: jnp.ndarray, test_v: jnp.ndarray,
                   W: jnp.ndarray, H: jnp.ndarray, *, entity_major: bool,
                   chunk: int = 1 << 20) -> jnp.ndarray:
    """On-device chunked test RMSE (plays GPU_rmse, cuda_src/CUDA_AUX.cu:3-27).

    Gathers factor *rows*, so factors are taken entity-major internally;
    accumulates per-chunk partial sums in f32 and
    combines across chunks, which keeps error well below test tolerances.
    """
    if not entity_major:
        W, H = W.T, H.T
    nnz = test_v.shape[0]
    pad = (-nnz) % chunk
    if pad:
        test_i = jnp.concatenate([test_i, jnp.zeros(pad, test_i.dtype)])
        test_j = jnp.concatenate([test_j, jnp.zeros(pad, test_j.dtype)])
        test_v = jnp.concatenate([test_v, jnp.zeros(pad, test_v.dtype)])
    wts = jnp.concatenate([jnp.ones(nnz, jnp.float32), jnp.zeros(pad, jnp.float32)])
    ti = test_i.reshape(-1, chunk)
    tj = test_j.reshape(-1, chunk)
    tv = test_v.reshape(-1, chunk)
    tw = wts.reshape(-1, chunk)

    def body(acc, args):
        i, j, v, w = args
        pred = jnp.einsum("ek,ek->e", jnp.take(W, i, axis=0),
                          jnp.take(H, j, axis=0), preferred_element_type=jnp.float32)
        err = (pred - v) * w
        return acc + jnp.sum(err * err), None

    sq, _ = jax.lax.scan(body, jnp.float32(0.0), (ti, tj, tv, tw))
    return jnp.sqrt(sq / nnz)


@dataclasses.dataclass(frozen=True)
class GoldenResult:
    passed: bool
    error_count: int
    total: int

    @property
    def error_percentage(self) -> float:
        return 100.0 * self.error_count / max(1, self.total)

    def message(self) -> str:
        # reference output format, src/extras.cpp:231-237
        if self.passed:
            return "Check... PASS!"
        return ("Check... NO PASS! [%.4f%%] #Error = %d out of %d entries."
                % (self.error_percentage, self.error_count, self.total))


def golden_compare(A, A_ref, *, rtol: float = GOLDEN_RTOL,
                   atol: float = 0.0) -> GoldenResult:
    """Entry-wise |a - a_ref| > rtol*|a_ref| count (golden_compare,
    src/extras.cpp:218-238). ``atol`` (not in the reference, default 0 for
    exact parity) absorbs near-zero entries where a pure relative bar flags
    sub-1e-4 rounding differences between equivalent solvers (e.g. Cholesky
    vs LU)."""
    A = np.asarray(A, dtype=np.float64)
    A_ref = np.asarray(A_ref, dtype=np.float64)
    if A.shape != A_ref.shape:
        raise ValueError(f"shape mismatch {A.shape} vs {A_ref.shape}")
    bad = np.abs(A - A_ref) > rtol * np.abs(A_ref) + atol
    return GoldenResult(passed=not bad.any(), error_count=int(bad.sum()),
                        total=int(A.size))
