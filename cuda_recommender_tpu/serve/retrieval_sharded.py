"""MIPS top-k retrieval over an item table sharded across a device mesh.

The sharded serving configuration (top-k over an item table sharded across
devices): the item factors are row-sharded over the
mesh, each device runs the streaming matmul+merge kernel
(serve/retrieval.py) against its local block, and only the per-device
(B, topk) candidates — not scores over the catalog — are gathered and merged.
Communication is O(devices * B * topk), independent of catalog size.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..parallel.mesh import AXIS
from .retrieval import topk_mips_device
from .scoring import as_entity_major


def make_sharded_topk(mesh: Mesh, *, topk: int, chunk: int, axis: str = AXIS):
    """Build the jitted sharded top-k function: (U (B,k) replicated,
    Hp (n_pad, k) row-sharded) -> global (scores, item_ids) (B, topk)."""

    def local(U, H_loc):
        s, i = topk_mips_device(U, H_loc, topk=topk, chunk=chunk)
        off = jax.lax.axis_index(axis) * H_loc.shape[0]
        return s, i + off

    fn = jax.shard_map(local, mesh=mesh,
                       in_specs=(P(), P(axis, None)),
                       out_specs=(P(None, axis), P(None, axis)),
                       check_vma=False)

    # Return ALL per-shard candidates (B, n_dev*topk): a device-side top_k
    # here would rank pad rows (score 0) above real items with negative
    # scores; the host filters pad/excluded ids first, then sorts.
    return jax.jit(fn)


def topk_mips_sharded(W, H, user_ids, mesh: Mesh, *, topk: int = 10,
                      chunk: int = 1024, entity_major: bool = True,
                      exclude: dict[int, np.ndarray] | None = None,
                      axis: str = AXIS) -> tuple[np.ndarray, np.ndarray]:
    """Host API mirroring serve.retrieval.topk_mips on a sharded item table."""
    W_em, H_em = as_entity_major(W, H, entity_major)
    n, k = H_em.shape
    n_dev = mesh.devices.size
    extra = max((len(v) for v in exclude.values()), default=0) if exclude else 0
    fetch = min(n, topk + extra)
    pad = (-n) % (n_dev * chunk)
    Hp = jax.device_put(np.pad(H_em, ((0, pad), (0, 0))),
                        NamedSharding(mesh, P(axis, None)))
    U = jax.device_put(W_em[np.asarray(user_ids, np.int64)],
                       NamedSharding(mesh, P()))
    # over-fetch so pad rows (zero vectors, score 0) cannot crowd out real
    # items, and so host-side exclusion still leaves topk candidates: a
    # single shard holds at most min(pad, local_n) pad rows (pad fills the
    # tail shard-major)
    local_n = (n + pad) // n_dev
    per_dev_fetch = min(local_n, fetch + min(pad, local_n))
    run = make_sharded_topk(mesh, topk=per_dev_fetch, chunk=chunk, axis=axis)
    s, i = run(U, Hp)
    s, i = np.asarray(s), np.asarray(i)

    valid = i < n
    out_s = np.full((len(user_ids), topk), -np.inf, np.float32)
    out_i = np.full((len(user_ids), topk), -1, np.int32)
    for b, uid in enumerate(np.asarray(user_ids)):
        cand, cs = i[b][valid[b]], s[b][valid[b]]
        if exclude and int(uid) in exclude:
            keep = ~np.isin(cand, exclude[int(uid)])
            cand, cs = cand[keep], cs[keep]
        order = np.argsort(-cs, kind="stable")[:topk]   # merge shard streams
        out_i[b, :len(order)] = cand[order]
        out_s[b, :len(order)] = cs[order]
    return out_s, out_i
