"""Chunked COO -> dense residual+mask scatter (trace-time building block).

A scatter's (nnz, 2) index operand is materialized as a temp, which a
backend may pad (a tiled layout can pad the minor dim 2 far beyond its
payload); at Netflix-panel sizes one unchunked scatter's index copy can
exceed device memory. Chunking the scatter under ``lax.fori_loop`` bounds
the live index temp to one chunk while the zeros-init and every per-chunk
update stay in-place via the loop-carry aliasing.

This replaces the reference's host-side CSR assembly role
(/root/reference/src/tools.cpp:3-85) for the dense/hybrid residual layouts;
the reference never densifies (its solvers walk CSC pointer chains).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

#: nnz per scatter chunk. The padded index temp is chunk * 128 lanes * 4 B
#: ≈ 512 MB at 1M — small enough to coexist with multi-GB panel outputs
#: during compile planning, large enough that even Netflix-100M densifies
#: in ~100 chunks inside one program.
DENSIFY_CHUNK = 1 << 20


def densify_coo(lr, lc, lv, rows: int, width: int, residual_dtype,
                mask_dtype, *, chunk: int = DENSIFY_CHUNK):
    """Scatter COO (lr, lc, lv) into a (rows, width) residual of
    ``residual_dtype`` plus a {0,1} mask of ``mask_dtype``.

    With ``mask_dtype="nan"`` there is NO mask array: the residual is
    initialized to NaN and observed cells overwrite it, so membership lives
    in the sentinel (``Md`` returns None). Otherwise the residual is
    zero-initialized and a separate mask is scattered.

    Traceable (call under jit). COO pairs must be unique — the scatters
    pass ``unique_indices=True``, which lets the backend skip duplicate
    handling (a serialized scatter is far slower at 10M+ elements). Chunk-padding entries get DISTINCT out-of-range rows so
    uniqueness holds; ``mode="drop"`` discards them.
    """
    rdt = jnp.dtype(residual_dtype)
    nan_mode = mask_dtype == "nan"
    if nan_mode:
        Rd = jnp.full((rows, width), jnp.nan, rdt)
        Md = None
    else:
        mdt = jnp.dtype(mask_dtype)
        Rd = jnp.zeros((rows, width), rdt)
        Md = jnp.zeros((rows, width), mdt)
    n = lr.shape[0]
    if n == 0:
        return Rd, Md
    chunk = min(chunk, n)
    nch = -(-n // chunk)
    pad = nch * chunk - n
    lr = lr.astype(jnp.int32)
    lc = lc.astype(jnp.int32)
    if pad:
        lr = jnp.concatenate(
            [lr, rows + jnp.arange(pad, dtype=jnp.int32)])
        lc = jnp.concatenate([lc, jnp.zeros(pad, jnp.int32)])
        lv = jnp.concatenate([lv, jnp.zeros(pad, lv.dtype)])

    def slices(i):
        s = i * chunk
        return (jax.lax.dynamic_slice(lr, (s,), (chunk,)),
                jax.lax.dynamic_slice(lc, (s,), (chunk,)),
                jax.lax.dynamic_slice(lv, (s,), (chunk,)))

    if nan_mode:
        def body(i, Rd):
            li, ci, vi = slices(i)
            return Rd.at[li, ci].set(vi.astype(rdt), unique_indices=True,
                                     mode="drop")
        return jax.lax.fori_loop(0, nch, body, Rd), None

    def body(i, RM):
        Rd, Md = RM
        li, ci, vi = slices(i)
        Rd = Rd.at[li, ci].set(vi.astype(rdt), unique_indices=True,
                               mode="drop")
        Md = Md.at[li, ci].set(jnp.ones((), mdt), unique_indices=True,
                               mode="drop")
        return Rd, Md

    return jax.lax.fori_loop(0, nch, body, (Rd, Md))
