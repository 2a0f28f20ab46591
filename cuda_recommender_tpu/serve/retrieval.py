"""MIPS top-k candidate retrieval over the item factor table.

The north-star serving path: given trained factors, retrieve the top-k
maximum-inner-product items per query user. Design: stream the item table in
chunks ((B, k) x (k, C) scores per chunk) and maintain a running top-k via
merge-and-select inside one jitted lax.scan — the full (B, n) score matrix
never materializes in device memory, so catalogs scale past it. Sharded serving splits the item table across devices
(shard_map), runs the same streaming kernel per shard, then merges the
per-shard top-k — an all_gather of (B, topk) candidates, not scores.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .scoring import SCORE_PRECISION, as_entity_major

NEG = jnp.float32(-3.4e38)


def _merge_topk(best_s, best_i, s, ids, topk: int):
    """Merge one chunk's scores into the running (B, topk) state: exact
    lax.top_k over the (B, topk + chunk) candidate set."""
    cand_s = jnp.concatenate([best_s, s], axis=1)
    cand_i = jnp.concatenate([best_i, ids], axis=1)
    top_s, pos = jax.lax.top_k(cand_s, topk)
    top_i = jnp.take_along_axis(cand_i, pos, axis=1)
    return top_s, top_i


@functools.partial(jax.jit, static_argnames=("topk", "chunk"))
def topk_mips_device(U: jnp.ndarray, H_em: jnp.ndarray, *, topk: int,
                     chunk: int) -> tuple[jnp.ndarray, jnp.ndarray]:
    """(scores, item_ids) of the top-``topk`` inner products per query row.

    U (B, k) query factors; H_em (n, k) item table with n a multiple of
    ``chunk`` (caller pads with NEG-scored rows). Running top-k state is
    (B, topk); each scan step scores one chunk and merges.
    """
    n = H_em.shape[0]
    Hc = H_em.reshape(n // chunk, chunk, H_em.shape[1])
    B = U.shape[0]

    def body(carry, xs):
        best_s, best_i = carry
        Hb, base = xs
        s = jnp.einsum("bk,ck->bc", U, Hb, preferred_element_type=jnp.float32,
                       precision=SCORE_PRECISION)
        ids = base + jax.lax.broadcasted_iota(jnp.int32, (B, chunk), 1)
        return _merge_topk(best_s, best_i, s, ids, topk), None

    init = (jnp.full((B, topk), NEG), jnp.full((B, topk), -1, jnp.int32))
    bases = (jnp.arange(n // chunk, dtype=jnp.int32) * chunk)
    (best_s, best_i), _ = jax.lax.scan(body, init, (Hc, bases))
    return best_s, best_i


def quantize_item_table(H_em: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Symmetric per-item int8 quantization of the item factor table
    (4x smaller device footprint for large catalogs; retrieval reads int8
    rows and dequantizes in-register).

    Returns (Hq int8 (n, k), scale f32 (n,)) with
    H[j] ≈ Hq[j] * scale[j]."""
    H_em = np.asarray(H_em, np.float32)
    amax = np.abs(H_em).max(axis=1)
    scale = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
    Hq = np.clip(np.rint(H_em / scale[:, None]), -127, 127).astype(np.int8)
    return Hq, scale


@functools.partial(jax.jit, static_argnames=("topk", "chunk"))
def topk_mips_device_int8(U: jnp.ndarray, Hq: jnp.ndarray,
                          scale: jnp.ndarray, *, topk: int, chunk: int
                          ) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Streaming top-k over an int8-quantized item table: identical merge
    structure to topk_mips_device, but each chunk streams int8 rows (1/4
    the bytes of f32) and dequantizes in-register."""
    n = Hq.shape[0]
    Hc = Hq.reshape(n // chunk, chunk, Hq.shape[1])
    Sc = scale.reshape(n // chunk, chunk)
    B = U.shape[0]

    def body(carry, xs):
        best_s, best_i = carry
        Hb, sc, base = xs
        s = jnp.einsum("bk,ck->bc", U, Hb.astype(jnp.float32),
                       preferred_element_type=jnp.float32,
                       precision=SCORE_PRECISION) * sc[None, :]
        ids = base + jax.lax.broadcasted_iota(jnp.int32, (B, chunk), 1)
        return _merge_topk(best_s, best_i, s, ids, topk), None

    init = (jnp.full((B, topk), NEG), jnp.full((B, topk), -1, jnp.int32))
    bases = (jnp.arange(n // chunk, dtype=jnp.int32) * chunk)
    (best_s, best_i), _ = jax.lax.scan(body, init, (Hc, Sc, bases))
    return best_s, best_i


def _postprocess(s, i, n, topk, user_ids, exclude):
    """Drop padding rows + apply per-user exclusions on the over-fetched
    candidate set (host-side, keeping the device kernel dense)."""
    s, i = np.asarray(s), np.asarray(i)
    valid = i < n
    out_s = np.full((len(user_ids), topk), -np.inf, np.float32)
    out_i = np.full((len(user_ids), topk), -1, np.int32)
    for b, uid in enumerate(np.asarray(user_ids)):
        cand = i[b][valid[b]]
        cs = s[b][valid[b]]
        if exclude and int(uid) in exclude:
            keep = ~np.isin(cand, exclude[int(uid)])
            cand, cs = cand[keep], cs[keep]
        take = min(topk, cand.shape[0])
        out_i[b, :take] = cand[:take]
        out_s[b, :take] = cs[:take]
    return out_s, out_i


def topk_mips(W, H, user_ids, *, topk: int = 10, chunk: int = 2048,
              entity_major: bool = True,
              exclude: dict[int, np.ndarray] | None = None,
              int8: bool = False) -> tuple[np.ndarray, np.ndarray]:
    """Host API: top-k item retrieval for a batch of users.

    ``exclude`` optionally maps user id -> item ids to mask out (e.g. train
    interactions when evaluating recall on held-out items). Masking happens
    host-side on an over-fetched candidate set (topk + max excluded), keeping
    the device kernel dense and branch-free. ``int8=True`` quantizes the
    item table per-item (quantize_item_table) and runs the int8 streaming
    kernel — production callers should quantize once and call
    topk_mips_device_int8 directly.
    """
    W_em, H_em = as_entity_major(W, H, entity_major)
    n, k = H_em.shape
    extra = max((len(v) for v in exclude.values()), default=0) if exclude else 0
    fetch = min(n, topk + extra)
    pad = (-n) % chunk
    Hp = np.pad(H_em, ((0, pad), (0, 0)))
    # Pad rows are zero vectors and score 0, which CAN outrank real items
    # when all true scores are negative. Correctness relies on over-fetching
    # (`fetch + pad` below) so at least `fetch` REAL items survive, then
    # dropping pad ids via the `valid = i < n` filter. Do not shrink the
    # over-fetch without replacing this mechanism.
    U = W_em[np.asarray(user_ids, np.int64)]
    if int8:
        Hq, scale = quantize_item_table(Hp)
        s, i = topk_mips_device_int8(jnp.asarray(U), jnp.asarray(Hq),
                                     jnp.asarray(scale),
                                     topk=min(fetch + pad, n + pad),
                                     chunk=chunk)
    else:
        s, i = topk_mips_device(jnp.asarray(U), jnp.asarray(Hp),
                                topk=min(fetch + pad, n + pad), chunk=chunk)
    return _postprocess(s, i, n, topk, user_ids, exclude)
