"""ALS — compiled padded-ELL backend (XLA).

Counterpart of the reference's ALS paths (/root/reference/src/ALS.cpp:81-233,
cuda_src/ALS_CUDA.cu:65-180). The reference gives each user/item one CUDA
thread that builds a k×k gram from CSR-gathered factor rows and inverts it
with an in-thread Cholesky; here each degree bucket gathers other-side factor
ROWS and assembles every slot's gram and right-hand side with one batched
einsum, then solves all k×k systems with a batched solve (Cholesky + two
triangular solves by default) — a solve, not the reference's explicit
inverse (src/ALS.cpp:41-64): same math, better numerics.

Semantics preserved (SURVEY.md §7): λ added UNscaled to the gram diagonal
(src/ALS.cpp:121); empty entities get zero factors (src/ALS.cpp:151-157);
the H update within an iteration uses the NEW W (Gauss-Seidel across sides,
Jacobi within a side — src/ALS.cpp:98-219); entity-major (n, k) layout
(src/main.cpp:87-91).
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..core.config import Config
from ..data.ell import EllPair, EllSide, build_ell_pair
from ..data.sparse import RatingMatrix, TestCOO
from ..eval.metrics import calrmse_device, default_eval_chunk
from ..ops.ell_ops import extend_zero
from .pipeline import pipelined_loop
from .reference import IterStats


def _gram_and_rhs(idx, val, other_ext, b, chunk: int,
                  precision=jax.lax.Precision.HIGHEST):
    """Per-slot augmented gram for one bucket: (S, k+1, k+1) holding the gram
    in [:, :k, :k] and the right-hand side in [:, :k, k].

    Gram and rhs come from ONE self-contraction of Faug = [F | val]: with two
    einsums XLA re-runs the row gather once per consumer. Same sums,
    (k+1)²/k² extra multiply work.

    Padded lanes gather the zero row, contributing exactly 0. Buckets with
    p == 1 (width E > ``chunk``) stream the lane axis in ``chunk``-wide slabs
    under lax.scan, so the gathered tile stays bounded for power-law head
    entities.
    """
    k = other_ext.shape[1]
    rows, L = idx.shape
    S = rows * b.p

    def accumulate(idx2, val2):
        F = other_ext[idx2]                       # (S, E', k) row gather
        # HIGHEST precision: a reduced-precision matmul (TF32 on NVIDIA
        # cards) drifts enough per solve to fail the reference's 10% golden
        # bar after a few Gauss-Seidel iterations on near-zero factor
        # entries. Gram assembly must be true f32.
        Faug = jnp.concatenate([F, val2[..., None]], axis=-1)
        return jnp.einsum("sea,seb->sab", Faug, Faug,
                          preferred_element_type=jnp.float32,
                          precision=precision)

    if L <= chunk or b.p > 1:
        return accumulate(idx.reshape(S, b.E), val.reshape(S, b.E))

    # data-driven ladder widths (data/ell.py) need not divide the chunk:
    # scan the full slabs, accumulate the remainder columns directly (they
    # gather real data — padding them to a whole slab would re-add the
    # gathers the ladder just removed)
    nC, rem = divmod(L, chunk)
    idx_s = idx[:, :nC * chunk].reshape(rows, nC, chunk).transpose(1, 0, 2)
    val_s = val[:, :nC * chunk].reshape(rows, nC, chunk).transpose(1, 0, 2)

    def body(carry, sl):
        return carry + accumulate(sl[0], sl[1]), None

    acc, _ = jax.lax.scan(
        body, jnp.zeros((S, k + 1, k + 1), jnp.float32), (idx_s, val_s))
    if rem:
        acc = acc + accumulate(idx[:, nC * chunk:], val[:, nC * chunk:])
    return acc


def gauss_jordan_solve(A: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Batched SPD solve via pivot-free Gauss-Jordan on the augmented system:
    k steps of full-batch broadcast FMAs over the (S, k, k+1) tensor.
    Pivot-free is numerically fine here: A = F_Ω^T F_Ω + λI is SPD with its
    dominant mass on the diagonal. ~k·S·k·(k+1) FLOPs total, same as a
    direct solve.
    """
    S, k = b.shape
    M = jnp.concatenate([A, b[..., None]], axis=2)          # (S, k, k+1)

    def body(i, M):
        row = jax.lax.dynamic_slice_in_dim(M, i, 1, axis=1)[:, 0, :]  # (S,k+1)
        d = jax.lax.dynamic_slice_in_dim(row, i, 1, axis=1)           # (S,1)
        prow = row / d
        col = jax.lax.dynamic_slice_in_dim(M, i, 1, axis=2)           # (S,k,1)
        M = M - col * prow[:, None, :]
        return jax.lax.dynamic_update_slice_in_dim(M, prow[:, None, :], i,
                                                   axis=1)

    M = jax.lax.fori_loop(0, k, body, M)
    return M[:, :, k]


def _solve_kxk(A, r, solver: str):
    """Batched (S, k, k) SPD solves: "lax" = Cholesky + two triangular
    solves (cuSOLVER / cuBLAS batched kernels on the GPU), "gj_xla" =
    gauss_jordan_solve."""
    if solver == "gj_xla":
        return gauss_jordan_solve(A, r)
    C = jnp.linalg.cholesky(A)
    y = jax.scipy.linalg.solve_triangular(C, r[..., None], lower=True)
    return jax.scipy.linalg.solve_triangular(
        jnp.swapaxes(C, -1, -2), y, lower=False)[..., 0]


#: per-group temp budget for the assembly+solve: bounds BOTH the
#: materialized augmented gather ``Faug`` (rows·L·(k+1)·4 B) and the
#: augmented gram ((k+1)²·slots·4 B). One group at ml20M dims; yahoo-r1-scale
#: sides (1.9M slots, 250M padded lanes — Faug alone would be 119 GB) split
#: into row-contiguous groups, each assembled and solved independently
#: (slots are row-major, so outputs concat).
GROUP_TEMP_BYTES = 2 << 30


def _row_groups(rows: int, L: int, p: int, k: int,
                group_bytes: int = GROUP_TEMP_BYTES) -> list[tuple[int, int]]:
    """Row-contiguous groups whose temp footprint fits the budget. Bytes are
    counted with the k+1 dims padded to (8, 128) tiles, a conservative
    bound (ROADMAP: re-derive for the GPU's layouts)."""
    kp1_l = -(-(k + 1) // 128) * 128          # k+1 padded to 128
    kp1_s = -(-(k + 1) // 8) * 8              # k+1 padded to 8
    per_row = max(L * kp1_l * 4, p * kp1_s * kp1_l * 4)
    g = max(1, min(rows, group_bytes // max(1, per_row)))
    return [(r0, min(rows, r0 + g)) for r0 in range(0, rows, g)]


class _TileShim:
    """Bucket-geometry shim for per-tile gather arrays (always p == 1)."""

    __slots__ = ("E", "p", "L")

    def __init__(self, W: int):
        self.E, self.p, self.L = W, 1, W


def tile_bucket_np(idx: np.ndarray, val: np.ndarray, n_other_slots: int,
                   tile_rows: int):
    """Partition one p==1 bucket's lanes by other-side slot TILE, so a side
    whose OTHER side's factor table is large gathers per <= tile_rows slice
    instead of from the whole table. Lanes pack left per tile (W_t = max
    in-tile count over rows); original ELL pad lanes (idx == n_other_slots)
    fall outside every tile and are DROPPED — the tiled layout carries true
    nnz only. Returns a list of (lo, hi, idx_local, val) with the local
    sentinel hi-lo pointing at the zero row appended to the table slice."""
    tiles = []
    for lo in range(0, n_other_slots, tile_rows):
        hi = min(n_other_slots, lo + tile_rows)
        m = (idx >= lo) & (idx < hi)
        W = int(m.sum(axis=1).max(initial=0))
        if W == 0:
            continue
        order = np.argsort(~m, axis=1, kind="stable")   # in-tile lanes first
        idx_s = np.take_along_axis(idx, order, 1)[:, :W]
        val_s = np.take_along_axis(val, order, 1)[:, :W]
        m_s = np.take_along_axis(m, order, 1)[:, :W]
        tiles.append((lo, hi,
                      np.where(m_s, idx_s - lo, hi - lo).astype(np.int32),
                      np.where(m_s, val_s, 0.0).astype(np.float32)))
    return tiles


def _solve_side(idx_tiles, val_tiles, side: EllSide, other_ext, lam,
                slot_nnz, chunk: int,
                precision=jax.lax.Precision.HIGHEST, solver: str = "lax",
                group_bytes: int = GROUP_TEMP_BYTES,
                tile_bounds: dict | None = None):
    """One ALS half-iteration over a side: x_j = (F_Ω^T F_Ω + λI)^{-1} F_Ω^T r
    for every slot, returning (n_slots, k) new factors.

    Each bucket is assembled and solved in memory-bounded row groups
    (_row_groups). ``tile_bounds``: {bucket_index: [(lo, hi), ...]} for
    buckets whose ``idx_tiles[i]``/``val_tiles[i]`` are PER-TILE tuples from
    tile_bucket_np — the gram/rhs accumulate over table slices; everything
    else is identical. Same sums as the untiled path up to f32 accumulation
    order."""
    k = other_ext.shape[1]
    eye = jnp.eye(k, dtype=jnp.float32)
    outs = []
    for i, b in enumerate(side.buckets):
        tiled = tile_bounds is not None and i in tile_bounds
        if tiled:
            bounds = tile_bounds[i]
            rows = idx_tiles[i][0].shape[0]
            L_eff = sum(ix.shape[1] for ix in idx_tiles[i])
            groups = _row_groups(rows, max(b.L, L_eff), 1, k, group_bytes)
        else:
            rows = idx_tiles[i].shape[0]
            groups = _row_groups(rows, b.L, b.p, k, group_bytes)

        def gram_group(idxg, valg, b=b, tiled=tiled):
            if not tiled:
                return _gram_and_rhs(idxg, valg, other_ext, b, chunk,
                                     precision)
            G = None
            for (lo, hi), ixt, vlt in zip(bounds, idxg, valg):
                tabt = jnp.concatenate([other_ext[lo:hi], other_ext[-1:]],
                                       axis=0)
                Gt = _gram_and_rhs(ixt, vlt, tabt, _TileShim(ixt.shape[1]),
                                   chunk, precision)
                G = Gt if G is None else G + Gt
            return G

        def solve_group(idxg, valg, gram_group=gram_group):
            G = gram_group(idxg, valg)
            A = G[:, :k, :k] + lam * eye           # λ unscaled, ALS.cpp:121
            return _solve_kxk(A, G[:, :k, k], solver)

        if len(groups) == 1:
            outs.append(solve_group(idx_tiles[i], val_tiles[i]))
            continue
        # many groups (huge sides, e.g. yahoo-r1's 2.5M-slot rows side): a
        # Python loop of groups under ONE jit lets XLA schedule every
        # group's gram temp concurrently. lax.map over the equal-size group
        # prefix serializes by construction (one group's temps live at a
        # time); the ragged last group runs separately.
        g = groups[0][1]
        nfull = rows // g

        def _stack(x):      # (rows, W) -> (nfull, g, W) group prefix
            return x[:nfull * g].reshape(nfull, g, x.shape[1])

        def _tail(x):
            return x[nfull * g:]

        if tiled:
            idxg = tuple(_stack(ix) for ix in idx_tiles[i])
            valg = tuple(_stack(vl) for vl in val_tiles[i])
            tail_args = (tuple(_tail(ix) for ix in idx_tiles[i]),
                         tuple(_tail(vl) for vl in val_tiles[i]))
        else:
            idxg, valg = _stack(idx_tiles[i]), _stack(val_tiles[i])
            tail_args = (_tail(idx_tiles[i]), _tail(val_tiles[i]))
        xs = jax.lax.map(lambda a, f=solve_group: f(a[0], a[1]), (idxg, valg))
        outs.append(xs.reshape(nfull * g * b.p, k))
        if rows > nfull * g:
            outs.append(solve_group(*tail_args))
    if not side.buckets:
        return jnp.zeros((side.n_slots, k), jnp.float32)
    used = side.bucket_offsets[-1] + side.buckets[-1].slots_per_shard
    tail = side.n_slots - used
    new = jnp.concatenate(
        outs + ([jnp.zeros((tail, k), jnp.float32)] if tail else []))
    # empty/padding slots -> exact zeros (src/ALS.cpp:151-157), also guards
    # the λ=0 singular-gram case from NaN-poisoning the factor table.
    return jnp.where((slot_nnz > 0)[:, None], new, 0.0)


def make_als_outer_step(ell: EllPair, lam: float, chunk: int,
                        jit_compile: bool = True,
                        precision_name: str = "highest",
                        solver: str = "lax",
                        group_bytes: int = GROUP_TEMP_BYTES,
                        tile_bounds_r: dict | None = None,
                        tile_bounds_c: dict | None = None):
    rows, cols = ell.rows_side, ell.cols_side
    lam_ = jnp.float32(lam)
    prec = {"highest": jax.lax.Precision.HIGHEST,
            "high": jax.lax.Precision.HIGH,
            "default": jax.lax.Precision.DEFAULT}[precision_name]

    def step(idx_r, idx_c, vals_r, vals_c, W, H, nnz_r, nnz_c):
        W = _solve_side(idx_r, vals_r, rows, extend_zero(H), lam_, nnz_r,
                        chunk, prec, solver, group_bytes, tile_bounds_r)
        H = _solve_side(idx_c, vals_c, cols, extend_zero(W), lam_, nnz_c,
                        chunk, prec, solver, group_bytes, tile_bounds_c)
        return W, H

    if not jit_compile:
        return step
    return jax.jit(step, donate_argnums=(4, 5))


def build_side_gather_tiles(side: EllSide, other_n_slots: int, k: int,
                            tile_mb: int):
    """Gather tiling decision + construction for one side (the side
    SOLVED FOR gathers the OTHER side's table). Returns
    (tile_bounds or None, per-bucket arg transform): buckets with p == 1
    whose other-side table exceeds ``tile_mb`` get per-tile index/value
    tuples from tile_bucket_np; p > 1 (lane-packed narrow) buckets keep
    the classic path — at the geometries where the cliff bites, they hold
    a negligible nnz share."""
    tile_bytes = int(tile_mb * (1 << 20))
    if not tile_bytes or other_n_slots * k * 4 <= tile_bytes:
        return None, None
    tile_rows = max(1, tile_bytes // (k * 4))
    bounds, args = {}, {}
    for i, b in enumerate(side.buckets):
        if b.p != 1:
            continue
        tiles = tile_bucket_np(b.idx, b.val, other_n_slots, tile_rows)
        if not tiles:
            continue
        bounds[i] = [(lo, hi) for lo, hi, _, _ in tiles]
        args[i] = (tuple(ix for _, _, ix, _ in tiles),
                   tuple(vl for _, _, _, vl in tiles))
    return (bounds or None), (args or None)


def als_ell_train(R: RatingMatrix, W0: np.ndarray, H0: np.ndarray,
                  T: TestCOO, cfg: Config, *,
                  callback: Optional[Callable[[IterStats], None]] = None,
                  ell: Optional[EllPair] = None,
                  ckpt_every: int = 0, ckpt_fn=None, resume=None,
                  ) -> tuple[np.ndarray, np.ndarray, list[IterStats]]:
    """Train ALS on the ELL backend (single device). W0 (m, k), H0 (n, k)
    entity-major; returns factors in the same layout/order."""
    if ell is None:
        ell = build_ell_pair(R, min_width=cfg.als_min_width, num_shards=1)
    rows, cols = ell.rows_side, ell.cols_side
    k = W0.shape[1]

    # gather tiling: a side whose OTHER side's factor table exceeds
    # cfg.als_gather_tile_mb gathers per table tile
    tb_r, ta_r = build_side_gather_tiles(rows, cols.n_slots, k,
                                         cfg.als_gather_tile_mb)
    tb_c, ta_c = build_side_gather_tiles(cols, rows.n_slots, k,
                                         cfg.als_gather_tile_mb)

    def side_args(side, targs):
        idx, vals = [], []
        for i, b in enumerate(side.buckets):
            if targs and i in targs:
                idx.append(tuple(jnp.asarray(x) for x in targs[i][0]))
                vals.append(tuple(jnp.asarray(x) for x in targs[i][1]))
            else:
                idx.append(jnp.asarray(b.idx))
                vals.append(jnp.asarray(b.val))
        return tuple(idx), tuple(vals)

    idx_r, vals_r = side_args(rows, ta_r)
    idx_c, vals_c = side_args(cols, ta_c)

    W_s = np.zeros((rows.n_slots, k), np.float32)
    W_s[rows.slot_of_entity] = np.asarray(W0, np.float32)
    H_s = np.zeros((cols.n_slots, k), np.float32)
    H_s[cols.slot_of_entity] = np.asarray(H0, np.float32)
    start_oiter = 1
    if resume is not None:
        start_oiter = int(resume["oiter"]) + 1
        W_s, H_s = resume["W"], resume["H"]
    W, H = jnp.asarray(W_s), jnp.asarray(H_s)
    nnz_r = jnp.asarray(rows.slot_nnz)
    nnz_c = jnp.asarray(cols.slot_nnz)

    ti = jnp.asarray(rows.slot_of_entity[T.row_idx])
    tj = jnp.asarray(cols.slot_of_entity[T.col_idx])
    tv = jnp.asarray(T.val)

    step_fn = make_als_outer_step(ell, cfg.lambda_, cfg.ell_chunk,
                                  precision_name=cfg.als_precision,
                                  solver=cfg.als_solver,
                                  group_bytes=cfg.als_group_mb << 20,
                                  tile_bounds_r=tb_r, tile_bounds_c=tb_c)
    rmse_fn = jax.jit(functools.partial(
        calrmse_device, entity_major=True,
        chunk=default_eval_chunk(T.nnz, cfg.eval_chunk)))

    box = {"WH": (W, H)}

    def do_step():
        W, H = box["WH"]
        box["WH"] = step_fn(idx_r, idx_c, vals_r, vals_c, W, H, nnz_r, nnz_c)
        return box["WH"][0]

    def do_rmse():
        W, H = box["WH"]
        return rmse_fn(ti, tj, tv, W, H)

    def get_payload():
        W, H = box["WH"]
        return {"W": np.asarray(W), "H": np.asarray(H)}

    stats = pipelined_loop(
        start_oiter=start_oiter, maxiter=cfg.maxiter,
        fuse=cfg.fused_outer_iters, do_step=do_step, do_rmse=do_rmse,
        callback=callback, ckpt_every=ckpt_every, ckpt_fn=ckpt_fn,
        get_payload=get_payload,
        early_stop_eps=cfg.eps if cfg.early_stop else 0.0)

    W, H = box["WH"]
    return (np.asarray(W)[rows.slot_of_entity],
            np.asarray(H)[cols.slot_of_entity], stats)
