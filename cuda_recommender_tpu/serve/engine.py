"""Per-query low-latency retrieval engine (device-resident item index).

The batch path (retrieval.topk_mips) is built for throughput: it streams the
item table in chunks through a lax.scan so a (B, n) score matrix never
materializes. For a SINGLE query that structure is pure overhead — a scan
carry per chunk, host-side padding per call, and a fresh device upload of the
factor tables every time. This engine is the latency path the reference has
no equivalent of (its predict path, src/extras.cpp:143-180, is offline
file scoring only):

  * factor tables are uploaded ONCE at construction and stay device-resident
    (optionally int8-quantized, retrieval.quantize_item_table);
  * a query is ONE dispatch: gather the user row (or take a provided
    vector), one (n, k) x (k,) matvec, one lax.top_k over the full score
    vector — at B=1 the (n,) scores are a few MB, so the
    chunked-merge machinery buys nothing and costs a scan;
  * per-user exclusions (seen-item filtering) run host-side on an
    over-fetched candidate set, keeping the device program branch-free and
    its shapes static (one compiled program per distinct fetch size, cached).

Numerics match the exact batch path bit-for-bit in f32 mode (same einsum,
same top-k ordering on distinct scores); int8 mode matches the int8 batch
kernel's quantization exactly.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .retrieval import quantize_item_table
from .scoring import SCORE_PRECISION, as_entity_major


@functools.partial(jax.jit, static_argnames=("fetch",))
def _query_f32(u: jnp.ndarray, H_em: jnp.ndarray, *,
               fetch: int) -> tuple[jnp.ndarray, jnp.ndarray]:
    """(scores, ids) of the top-``fetch`` items for one query vector u (k,)."""
    s = jnp.einsum("nk,k->n", H_em, u, preferred_element_type=jnp.float32,
                   precision=SCORE_PRECISION)
    return jax.lax.top_k(s, fetch)


@functools.partial(jax.jit, static_argnames=("fetch",))
def _query_int8(u: jnp.ndarray, Hq: jnp.ndarray, scale: jnp.ndarray, *,
                fetch: int) -> tuple[jnp.ndarray, jnp.ndarray]:
    """int8 table variant: dequantize in-register (fuses into the matvec —
    the pass reads 1/4 the bytes of f32)."""
    s = jnp.einsum("nk,k->n", Hq.astype(jnp.float32), u,
                   preferred_element_type=jnp.float32,
                   precision=SCORE_PRECISION) * scale
    return jax.lax.top_k(s, fetch)


@jax.jit
def _user_row(W_em: jnp.ndarray, uid: jnp.ndarray) -> jnp.ndarray:
    return jnp.take(W_em, uid, axis=0)


class RetrievalEngine:
    """Device-resident MIPS index over trained factors.

    Parameters
    ----------
    W, H : factor matrices in either reference layout (``entity_major``
        as in serve.scoring.as_entity_major). W may be ``None`` for a
        vector-only engine (queries must then pass ``u_vec``).
    int8 : quantize the item table per-item (4x smaller device footprint;
        identical quantization to the batch int8 kernel).
    """

    def __init__(self, W, H, *, entity_major: bool = True,
                 int8: bool = False):
        if W is None:
            H_em = np.asarray(H, np.float32)
            H_em = H_em if entity_major else np.ascontiguousarray(H_em.T)
            self._W = None
        else:
            W_em, H_em = as_entity_major(W, H, entity_major)
            self._W = jax.device_put(W_em)
        self.n_items, self.k = H_em.shape
        self.int8 = bool(int8)
        if int8:
            Hq, scale = quantize_item_table(H_em)
            self._Hq = jax.device_put(Hq)
            self._scale = jax.device_put(scale)
        else:
            self._H = jax.device_put(H_em)

    # -- internal ---------------------------------------------------------
    def _dispatch(self, u: jnp.ndarray, fetch: int):
        if self.int8:
            return _query_int8(u, self._Hq, self._scale, fetch=fetch)
        return _query_f32(u, self._H, fetch=fetch)

    def _uvec(self, user, u_vec):
        if (user is None) == (u_vec is None):
            raise ValueError("pass exactly one of user=, u_vec=")
        if u_vec is not None:
            u_vec = jnp.asarray(np.asarray(u_vec, np.float32))
            if u_vec.shape != (self.k,):
                raise ValueError(f"u_vec must be ({self.k},), "
                                 f"got {u_vec.shape}")
            return u_vec
        if self._W is None:
            raise ValueError("engine was built without W; pass u_vec=")
        return _user_row(self._W, jnp.int32(user))

    # -- public -----------------------------------------------------------
    def query(self, *, user: int | None = None, u_vec=None, topk: int = 10,
              exclude=None) -> tuple[np.ndarray, np.ndarray]:
        """Top-``topk`` (scores, item_ids) for one query.

        ``exclude`` is an optional array of item ids to filter out (e.g. the
        user's train interactions); the device fetch is over-sized by
        ``len(exclude)`` so ``topk`` real candidates survive the host filter.
        """
        u = self._uvec(user, u_vec)
        extra = 0 if exclude is None else len(np.asarray(exclude).ravel())
        fetch = min(self.n_items, topk + extra)
        s, i = self._dispatch(u, fetch)
        s, i = np.asarray(s), np.asarray(i)
        if exclude is not None and extra:
            keep = ~np.isin(i, np.asarray(exclude))
            s, i = s[keep], i[keep]
        take = min(topk, i.shape[0])
        out_s = np.full(topk, -np.inf, np.float32)
        out_i = np.full(topk, -1, np.int32)
        out_s[:take], out_i[:take] = s[:take], i[:take]
        return out_s, out_i

    def warmup(self, topk: int = 10, exclude_sizes=()) -> None:
        """Pre-compile the query program(s) so first-query latency is not a
        compile (one program per distinct fetch size)."""
        zeros = np.zeros(self.k, np.float32)
        self.query(u_vec=zeros, topk=topk)
        for e in exclude_sizes:
            fetch = min(self.n_items, topk + int(e))
            jax.block_until_ready(self._dispatch(jnp.asarray(zeros), fetch))
