"""Pallas kernels (Triton route): fused CCD++ panel passes over NaN-sentinel
residuals.

The XLA hybrid step touches each dense panel several times per rank
(residual update read+write, v-sweep read, u-sweep read) and, in
NaN-sentinel mode, may read the residual once per g/h reduction. These
kernels fuse each pass group so every byte is read once:

  * ``panel_update_vsweep`` — ONE read-modify-write pass: applies the
    deferred-subtract + add-back delta (outer(u_old, v_old) −
    outer(u_pend, v_pend)), writes the new residual, and emits BOTH
    v-sweep partials (g = uᵀ·R_masked, h = (u²)ᵀ·mask) from the freshly
    updated tile while it is in registers.
  * ``panel_vsweep`` — the same v-sweep partials without the update
    (inner iterations after the first).
  * ``panel_usweep`` — ONE read pass: emits the u-sweep partials
    (g = R_masked·v, h = mask·v²).

Together: 2 reads + 1 write = 6 B/cell/rank at bf16. The mask is derived
in-register from the NaN sentinel (mask_dtype="nan", ops/densify.py), so
no mask array exists at all.

GPU blocks run concurrently and in no order, so nothing accumulates across
programs:

  * ``panel_usweep``: each program owns ``bm`` rows and loops over every
    column block, so its row sums are complete when it stores them.
  * ``panel_update_vsweep`` / ``panel_vsweep``: the grid is (column blocks
    × row chunks). Each program loops over the row blocks of its chunk and
    writes one row of ``(n_chunks, W)`` column partials; one ``jnp.sum``
    over the chunk axis finishes the reduction. No atomics, so results are
    deterministic.

Ragged edges use masked loads with NaN as the fill value (a NaN cell is an
unobserved cell), so panels keep their natural shape.

Replaces the reference's per-rank CUDA kernel sequence
UpdateRating_DUAL + RankOneUpdate_v/_u (/root/reference/cuda_src/
CCD_CUDA.cu:60-104,24-58) for the panel-covered cells; the decomposition
itself has no reference counterpart.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

#: tile shape (rows x cols) of one loop step. Powers of two (Triton's
#: rule); a (32, 128) f32 tile is 32 values per thread at 4 warps, which
#: leaves registers for the two (bm, bw) accumulators.
BM = 32
BW = 128
NUM_WARPS = 4
#: programs the v-sweep grid aims for: a few per SM on a 132-SM card, so
#: memory latency is hidden without shrinking each program's row loop.
TARGET_PROGRAMS = 1024


def _round_to_storage(x, dtype):
    """Round f32 ``x`` to the storage dtype's grid, returning f32. A plain
    astype(dt).astype(f32) round-trip can be elided by XLA's
    excess-precision rule (which the interpreter runs under), so bf16 uses
    the integer round-to-nearest-even on the raw bits. NaN (the unobserved
    sentinel) passes through unchanged: the bias add would carry a NaN
    whose mantissa is all ones — the GPU's canonical NaN, 0x7FFFFFFF — into
    the sign bit and turn it into -0. Other dtypes keep the astype
    round-trip."""
    dt = jnp.dtype(dtype)
    if dt == jnp.dtype(jnp.float32):
        return x
    if dt == jnp.dtype(jnp.bfloat16):
        bits = jax.lax.bitcast_convert_type(x, jnp.uint32)
        lsb = (bits >> 16) & jnp.uint32(1)
        rounded = (bits + jnp.uint32(0x7FFF) + lsb) & jnp.uint32(0xFFFF0000)
        return jnp.where(jnp.isnan(x), x,
                         jax.lax.bitcast_convert_type(rounded, jnp.float32))
    return x.astype(dt).astype(jnp.float32)


def _split(R):
    """(residual with NaN -> 0, mask) as f32 from a loaded tile."""
    isn = jnp.isnan(R)
    return jnp.where(isn, 0.0, R), jnp.where(isn, 0.0, 1.0)


def _tile(ref, rows, cols, M, W):
    """Masked (bm, bw) tile load; out-of-range cells read as NaN
    (unobserved)."""
    ri = rows.start + jnp.arange(rows.size)
    ci = cols.start + jnp.arange(cols.size)
    mask = (ri < M)[:, None] & (ci < W)[None, :]
    return plgpu.load(ref.at[rows, cols], mask=mask, other=jnp.nan), mask


def _vec(ref, sl, n):
    """Masked vector load; out-of-range entries read as 0."""
    mask = sl.start + jnp.arange(sl.size) < n
    return plgpu.load(ref.at[sl], mask=mask, other=0.0)


def _vsweep_kernel(Rd_ref, uo_ref, up_ref, vo_ref, vp_ref, *refs,
                   bm, bw, steps, update):
    if update:
        Rout_ref, g_ref, h_ref = refs
    else:
        g_ref, h_ref = refs
    M, W = Rd_ref.shape
    jw, c = pl.program_id(0), pl.program_id(1)
    cols = pl.ds(jw * bw, bw)
    if update:
        vo = _vec(vo_ref, cols, W)
        vp = _vec(vp_ref, cols, W)

    def body(i, carry):
        acc_g, acc_h = carry
        rows = pl.ds((c * steps + i) * bm, bm)
        uo = _vec(uo_ref, rows, M)
        R, mask = _tile(Rd_ref, rows, cols, M, W)
        R = R.astype(jnp.float32)
        if update:
            up = _vec(up_ref, rows, M)
            delta = uo[:, None] * vo[None, :] - up[:, None] * vp[None, :]
            # f32 add + ONE rounding to the storage dtype: the sweep sees
            # exactly the value that persists. NaN + delta stays NaN.
            R = _round_to_storage(R + delta, Rd_ref.dtype)
            plgpu.store(Rout_ref.at[rows, cols], R.astype(Rout_ref.dtype),
                        mask=mask)
        Rf, Mf = _split(R)
        return (acc_g + uo[:, None] * Rf,
                acc_h + (uo * uo)[:, None] * Mf)

    zeros = jnp.zeros((bm, bw), jnp.float32)
    acc_g, acc_h = jax.lax.fori_loop(0, steps, body, (zeros, zeros))
    out = pl.ds(jw * bw, bw)
    omask = jw * bw + jnp.arange(bw) < W
    plgpu.store(g_ref.at[c, out], acc_g.sum(axis=0), mask=omask)
    plgpu.store(h_ref.at[c, out], acc_h.sum(axis=0), mask=omask)


def _usweep_kernel(Rd_ref, v_ref, g_ref, h_ref, *, bm, bw):
    M, W = Rd_ref.shape
    rows = pl.ds(pl.program_id(0) * bm, bm)

    def body(j, carry):
        acc_g, acc_h = carry
        cols = pl.ds(j * bw, bw)
        v = _vec(v_ref, cols, W)
        R, _ = _tile(Rd_ref, rows, cols, M, W)
        Rf, Mf = _split(R.astype(jnp.float32))
        return acc_g + Rf * v[None, :], acc_h + Mf * (v * v)[None, :]

    zeros = jnp.zeros((bm, bw), jnp.float32)
    acc_g, acc_h = jax.lax.fori_loop(0, pl.cdiv(W, bw), body,
                                     (zeros, zeros))
    omask = rows.start + jnp.arange(bm) < M
    plgpu.store(g_ref.at[rows], acc_g.sum(axis=1), mask=omask)
    plgpu.store(h_ref.at[rows], acc_h.sum(axis=1), mask=omask)


def vsweep_chunks(M: int, W: int, bm: int = BM, bw: int = BW
                  ) -> tuple[int, int]:
    """(row blocks per program, number of row chunks) for the v-sweep grid:
    enough chunks that (column blocks × chunks) reaches TARGET_PROGRAMS,
    never more chunks than row blocks."""
    row_blocks = pl.cdiv(M, bm)
    want = max(1, pl.cdiv(TARGET_PROGRAMS, pl.cdiv(W, bw)))
    steps = pl.cdiv(row_blocks, min(row_blocks, want))
    return steps, pl.cdiv(row_blocks, steps)


def _interpret(flag):
    """Pallas interprets the kernels on the CPU (tests) and compiles them
    for the GPU everywhere else, unless the caller says otherwise."""
    return jax.default_backend() == "cpu" if flag is None else flag


def _vsweep_call(Rd, u_old, u_pend, v_old, v_pend, *, update, interpret,
                 bm, bw):
    M, W = Rd.shape
    f32 = jnp.float32
    steps, n_chunks = vsweep_chunks(M, W, bm, bw)
    part = jax.ShapeDtypeStruct((n_chunks, W), f32)
    out_shape = ([jax.ShapeDtypeStruct(Rd.shape, Rd.dtype)] if update
                 else []) + [part, part]
    outs = pl.pallas_call(
        functools.partial(_vsweep_kernel, bm=bm, bw=bw, steps=steps,
                          update=update),
        grid=(pl.cdiv(W, bw), n_chunks),
        out_shape=out_shape,
        input_output_aliases={0: 0} if update else {},
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS),
        interpret=_interpret(interpret),
        name="panel_update_vsweep" if update else "panel_vsweep",
    )(Rd, u_old.astype(f32), u_pend.astype(f32), v_old.astype(f32),
      v_pend.astype(f32))
    *Rn, g, h = outs
    return (*Rn, g.sum(axis=0), h.sum(axis=0))


@functools.partial(jax.jit, static_argnames=("interpret", "bm", "bw"))
def panel_update_vsweep(Rd, u_old, u_pend, v_old, v_pend, *,
                        interpret: bool | None = None, bm: int = BM,
                        bw: int = BW):
    """Fused residual update + v-sweep partials for one NaN-sentinel panel.

    Rd (M, W) storage dtype; u_* (M,) f32; v_* (W,) f32. Returns
    (Rd_new, g, h): g[j] = Σ_i u_old[i]·R_new[i,j]·mask, h[j] = Σ_i
    u_old[i]²·mask — the XLA path's math with a blocked f32 summation
    order. The residual is updated in place when the caller donates it.
    """
    return _vsweep_call(Rd, u_old, u_pend, v_old, v_pend, update=True,
                        interpret=interpret, bm=bm, bw=bw)


@functools.partial(jax.jit, static_argnames=("interpret", "bm", "bw"))
def panel_vsweep(Rd, u, *, interpret: bool | None = None, bm: int = BM,
                 bw: int = BW):
    """v-sweep partials only (inner iterations i > 0, where no residual
    update precedes the sweep): g[j] = Σ_i u[i]·R_masked[i,j], h[j] =
    Σ_i u[i]²·mask[i,j]. One read pass."""
    zw = jnp.zeros(Rd.shape[1], jnp.float32)
    return _vsweep_call(Rd, u, u, zw, zw, update=False,
                        interpret=interpret, bm=bm, bw=bw)


@functools.partial(jax.jit, static_argnames=("interpret", "bm", "bw"))
def panel_usweep(Rd, v, *, interpret: bool | None = None, bm: int = BM,
                 bw: int = BW):
    """u-sweep partials for one NaN-sentinel panel: g[i] = Σ_j
    R_masked[i,j]·v[j], h[i] = Σ_j mask[i,j]·v[j]². One read pass."""
    M, _ = Rd.shape
    f32 = jnp.float32
    vec = jax.ShapeDtypeStruct((M,), f32)
    return pl.pallas_call(
        functools.partial(_usweep_kernel, bm=bm, bw=bw),
        grid=(pl.cdiv(M, bm),),
        out_shape=[vec, vec],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS),
        interpret=_interpret(interpret),
        name="panel_usweep",
    )(Rd, v.astype(f32))
