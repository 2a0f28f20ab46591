"""CCD++ — compiled panel-hybrid backend (the large-matrix flagship).

For matrices whose full dense residual is too large to keep, or wasteful to
stream (Netflix-100M: 480k x 17.7k cells, 1.2% observed). The pure
padded-ELL path must move every rating's factor value through a gather per
rank. The hybrid stops gathering for the cells that carry the mass:

  * sort users AND items by degree. Real rating matrices are doubly
    power-law, so the nnz mass concentrates in the top-left corner of the
    sorted matrix;
  * cover that corner with a small stair of **dense panels** — panel 1 =
    top users x ALL items, panel 2 = next users x top-w2 items, ... — each a
    dense residual block + mask driven by the dense backend's
    deferred-subtract schedule (solvers/ccd_dense.py), bandwidth-bound;
  * the sparse remainder (typically 10-20% of nnz under the panel budget)
    keeps the degree-bucketed ELL layout (data/ell.py) with the 2-wide
    PAIRED row gathers of the pure ELL solver's schedule;
    ops/ell_ops.paired_gather chunks the rows under lax.map to bound the
    gathered temp.

Factors live in degree-sorted entity order — W (k, m), H (k, n) — so every
panel touches a contiguous static slice and the ELL bucket ``idx`` arrays
reference entity positions directly (data/ell.py ``index_space="entity"``).
Per entity the sweep sums combine across parts before the division
(RankOneUpdate, /root/reference/src/CCD.cpp:6-16):

    new_j = (sum_p g_panel_p + g_ell) / (lambda*nnz_j + sum_p h_p + h_ell)

with nnz_j the entity's TOTAL degree (lambda*nnz scaling,
src/CCD.cpp:112,120) — bit-for-bit the same algorithm as the other
backends, just with the Omega_j reduction partitioned.

The reference role being replaced is the CUDA CCD++ kernel set
(/root/reference/cuda_src/CCD_CUDA.cu:24-104); the reference has no
counterpart for the decomposition.

Semantics preserved (SURVEY.md §7): H zeroed at entry (src/CCD.cpp:56-60);
lambda*nnz regularization with total degrees; v-sweep before u-sweep per
inner iteration (src/CCD.cpp:110-121); empty entity -> 0 factor
(src/CCD.cpp:8, via the full-denominator guard); rank-major factor layout.
Schedules: EVERY part — dense panels, cols-ELL and rows-ELL — defers the
subtract of a rank's new outer product to the next rank via the shared
(u_pend, v_pend) state, so each ELL side needs exactly ONE fused
gather+update+sweep pass per rank (ops/ell_ops.fused_update_sweep; feeding
a chunked gather tile to >1 consumer op re-runs the gather per consumer).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..core.config import Config
from ..data.ell import EllPair, build_ell_pair
from ..data.sparse import RatingMatrix, TestCOO, from_coo, make_test
from ..eval.metrics import calrmse_device, default_eval_chunk
from ..native.groupsort import key_count, perm_gather, stable_perm
from ..ops.densify import densify_coo
from ..ops.ell_ops import (deferred_flush, deferred_sweep, extend_zero,
                           fused_remap_combine, fused_sweep,
                           fused_update_sweep, paired_gather,
                           residual_update, stacked_remap, sweep_partials)
from .pipeline import pipelined_loop
from .reference import IterStats


@dataclasses.dataclass(frozen=True)
class HybridPlan:
    """Host-side panel plan over the degree-sorted matrix."""

    user_order: np.ndarray     # (m,) original user ids, degree-sorted
    item_order: np.ndarray     # (n,) original item ids, degree-sorted
    user_pos: np.ndarray       # (m,) original id -> sorted position
    item_pos: np.ndarray       # (n,)
    #: dense panels as (r0, r1, width): sorted-user rows [r0, r1) x sorted
    #: items [0, width). r ranges are contiguous from 0, widths decreasing.
    panels: tuple[tuple[int, int, int], ...]
    ell: EllPair               # sparse remainder (m x n, sorted coords,
    #                            entity-indexed buckets)
    nnz_light: int
    Rd: tuple                  # per panel (rows, w) f32 residual init
    Md: tuple                  # per panel (rows, w) f32 {0,1} mask
    row_nnz: np.ndarray        # (m,) TOTAL user degrees, sorted order
    col_nnz: np.ndarray        # (n,) TOTAL item degrees, sorted order
    # ELL slot <-> entity maps (entities = sorted positions)
    slot_of_upos: np.ndarray   # (m,)
    slot_of_ipos: np.ndarray   # (n,)
    upos_of_slot_safe: np.ndarray  # (n_row_slots,) padding -> m
    ipos_of_slot_safe: np.ndarray  # (n_col_slots,) padding -> n
    #: with ``materialize_dense=False``: per panel (local_row, col, val) COO
    #: for device-side scatter (a host-built Netflix panel is GBs of RAM and
    #: a multi-GB host->device ship; the COO is ~nnz-sized)
    panel_coo: Optional[tuple] = None


def _candidate_boundaries(m: int, align: int = 8, npts: int = 129,
                          include_full: bool = False) -> np.ndarray:
    cand = np.unique((np.linspace(0, m, npts) / align).round()
                     .astype(np.int64) * align)
    cand = np.minimum(cand, (m // align) * align)
    if include_full:
        # the exact row count as a candidate (alignment is only a sharding
        # constraint): a budget >= m*n then
        # yields ONE full panel and no ELL tail at all — the dense case as
        # a degenerate hybrid plan.
        cand = np.unique(np.append(cand, m))
    return cand


def _search_boundaries(prefixes, widths, cand, budget: int,
                       passes: int = 6) -> list[int]:
    """Maximize covered nnz over non-decreasing boundaries r_1 <= ... <= r_W
    (panel p spans users [r_{p-1}, r_p) at width w_p) under the cell budget
    Σ (r_p - r_{p-1})·w_p, by coordinate ascent: optimize one boundary at a
    time (vectorized over candidates) holding the others fixed, alternating
    sweep direction. O(passes · W · |cand|) — a joint grid would be
    |cand|^W, which hangs for more than ~3 panel widths."""
    W = len(widths)
    r = [0] * W

    def cells(rr):
        tot, prev = 0, 0
        for b, w in zip(rr, widths):
            tot += (b - prev) * w
            prev = b
        return tot

    for p in range(passes):
        order = range(W - 1, -1, -1) if p % 2 == 0 else range(W)
        changed = False
        for i in order:
            lo = r[i - 1] if i > 0 else 0
            hi = r[i + 1] if i < W - 1 else int(cand[-1])
            opts = cand[(cand >= lo) & (cand <= hi)]
            if opts.size == 0:
                continue
            base_cells = cells(r)
            w_next = widths[i + 1] if i < W - 1 else 0
            d_cells = (opts - r[i]) * (widths[i] - w_next)
            feasible = base_cells + d_cells <= budget
            if not feasible.any():
                continue
            # coverage as a function of r_i alone: terms i and i+1 depend on
            # it: ... + (P_i[r_i] - P_i[r_{i-1}]) + (P_{i+1}[r_{i+1}] -
            # P_{i+1}[r_i]) + ... -> gain(b) = P_i[b] - P_{i+1}[b] + const
            Pi = prefixes[i]
            Pn = prefixes[i + 1] if i < W - 1 else None
            gain = Pi[opts].astype(np.int64)
            cur_gain = int(Pi[r[i]])
            if Pn is not None:
                gain = gain - Pn[opts]
                cur_gain -= int(Pn[r[i]])
            gain = np.where(feasible, gain, np.iinfo(np.int64).min)
            j = int(gain.argmax())
            if int(gain[j]) > cur_gain:
                r[i] = int(opts[j])
                changed = True
        if not changed and p > 0:
            break
    return r


def _stair_ladder(n: int, min_width: int = 128, step: float = 2 ** 0.25,
                  ) -> np.ndarray:
    """Geometric candidate-width ladder, 128-lane aligned, ascending, ending
    at exactly n. ~4 candidates per octave is fine enough that snapping to
    the grid costs <1% coverage while keeping the per-nnz classification to
    ~30 compare-add passes."""
    w = float(n)
    out = [n]
    while w > min_width:
        w /= step
        cand = max(min_width, int(round(w / 128.0)) * 128)
        if cand != out[-1] and cand < n:
            out.append(cand)
    return np.unique(np.asarray(out, np.int64))


def _auto_stair(rp: np.ndarray, cp: np.ndarray, m: int, n: int,
                budget: int, align: int, *, min_width: int = 128,
                max_panels: int = 8) -> list[tuple[int, int, int]]:
    """Data-driven panel stair: choose panel WIDTHS and BOUNDARIES jointly
    from the degree distribution under the cell budget (the tuple form fixes
    the widths from config and searches boundaries only).

    Formulation: with users and items degree-sorted, assign every block of
    ``align``-aligned user rows a width w(b) from a geometric candidate
    ladder, maximizing covered nnz  Σ_b cov_b(w(b))  subject to
    Σ_b rows_b · w(b) <= budget and w non-increasing (a stair). Solved by
    Lagrangian relaxation: for a price λ per cell each block independently
    picks argmax_w cov_b(w) − λ·rows_b·w (vectorized over the whole
    (blocks × ladder) table), the choice is projected to non-increasing by a
    reverse running max, and λ is bisected to the budget. The relaxation is
    exact up to one block's rounding because cov_b(w) is near-concave in w
    for degree-sorted power-law data. A final merge pass caps the number of
    distinct widths at ``max_panels`` (each panel is an extra scatter
    program + kernel call set per rank).
    """
    ladder = _stair_ladder(n, min_width=min_width)          # ascending
    K = ladder.size
    # per-nnz ladder class: cls = #{ladder[j] <= cp, j < K-1} via compare-add
    # passes (np.searchsorted over 100M elems measured ~16x slower)
    cls = np.zeros(cp.size, np.int32)
    for t in ladder[:-1]:
        cls += (cp >= np.int32(t))
    # block granularity: align-multiple, <= ~4096 blocks for the search
    B = align * max(1, -(-m // (align * 4096)))
    nblk = -(-m // B)
    key = (rp // np.int32(B)) * np.int32(K) + cls
    counts = key_count(key, nblk * K).reshape(nblk, K)
    covB = np.cumsum(counts, axis=1)       # covB[b, j]: block-b nnz in
    #                                        items [0, ladder[j])
    rows_b = np.full(nblk, B, np.int64)
    rows_b[-1] = m - B * (nblk - 1)
    cost = rows_b[:, None] * ladder[None, :]                # (nblk, K)

    def eval_lam(lam: float):
        score = covB - lam * cost
        j = score.argmax(axis=1)
        w_j = np.where(score[np.arange(nblk), j] > 0, j, -1)  # -1 = no panel
        # stair projection: widths non-increasing down the degree order
        w_j = np.maximum.accumulate(w_j[::-1])[::-1]
        cells = int(np.where(w_j >= 0, rows_b * ladder[np.maximum(w_j, 0)],
                             0).sum())
        return cells, w_j

    cells0, w0 = eval_lam(0.0)
    if cells0 <= budget:
        w_best = w0                        # budget covers the full matrix
    else:
        lo, hi = 0.0, 1.0
        while eval_lam(hi)[0] > budget:
            hi *= 4.0
        w_best = None
        for _ in range(64):
            mid = 0.5 * (lo + hi)
            cells, w_j = eval_lam(mid)
            if cells <= budget:
                hi, w_best = mid, w_j
            else:
                lo = mid
        if w_best is None:
            w_best = eval_lam(hi)[1]

    def total_cells(w_j):
        return int(np.where(w_j >= 0, rows_b * ladder[np.maximum(w_j, 0)],
                            0).sum())

    # merge to <= max_panels distinct width levels: raise the lower level to
    # the upper when the budget allows (coverage can only grow), otherwise
    # lower the upper level (cheapest coverage loss first)
    def levels(w_j):
        lv, prev = [], None
        for b in range(nblk):
            if w_j[b] < 0:
                break
            if w_j[b] != prev:
                lv.append([b, b + 1, int(w_j[b])])
                prev = w_j[b]
            else:
                lv[-1][1] = b + 1
        return lv

    w_j = w_best.copy()
    while True:
        lv = levels(w_j)
        if len(lv) <= max_panels:
            break
        best = None                          # (tier, penalty, i, mode)
        for i in range(len(lv) - 1):
            (a0, a1, ja), (b0, b1, jb) = lv[i], lv[i + 1]
            d_cells = int((rows_b[b0:b1]
                           * (ladder[ja] - ladder[jb])).sum())
            if total_cells(w_j) + d_cells <= budget:
                cand = (0, d_cells, i, "raise")   # coverage only grows
            else:
                loss = int((covB[a0:a1, ja] - covB[a0:a1, jb]).sum())
                cand = (1, loss, i, "lower")
            if best is None or cand < best:
                best = cand
        _, _, i, mode = best
        (a0, a1, ja), (b0, b1, jb) = levels(w_j)[i], levels(w_j)[i + 1]
        if mode == "raise":
            w_j[b0:b1] = ja
        else:
            w_j[a0:a1] = jb

    panels: list[tuple[int, int, int]] = []
    for b0, b1, j in levels(w_j):
        r0, r1 = int(b0) * B, min(int(b1) * B, m)
        if r1 > r0:
            panels.append((int(r0), int(r1), int(ladder[j])))
    return panels


def resolve_hybrid_transpose(R: RatingMatrix, cfg: Config) -> bool:
    """Resolve cfg.hybrid_transpose to a concrete orientation. "auto"
    geometry-plans BOTH orientations (no dense materialization, no device
    work) and picks the smaller uncovered tail — a tail lane costs a gather
    where a panel cell costs a streamed byte, so min nnz_light is the
    objective at equal budget."""
    if not cfg.hybrid_transpose:
        return False
    if cfg.hybrid_transpose is True:
        return True
    cfg_nt = dataclasses.replace(cfg, hybrid_transpose=False)
    plan_n = plan_hybrid(R, cfg_nt, materialize_dense=False)
    plan_t = plan_hybrid(R.transpose(), cfg_nt, materialize_dense=False)
    return plan_t.nnz_light < plan_n.nnz_light


def plan_hybrid(R: RatingMatrix, cfg: Config, *,
                materialize_dense: bool = True,
                num_shards: int = 1) -> HybridPlan:
    """Choose panel boundaries maximizing covered nnz under the cell budget
    (``cfg.hybrid_dense_cells``) by grid search over degree-sorted user
    boundaries, one per panel width (full n plus
    ``cfg.hybrid_panel_widths``). With ``num_shards = N`` every panel's row
    count is N-aligned (device row blocks are equal) and the ELL remainder
    is built shard-uniform (data/ell.py)."""
    m, n = R.rows, R.cols
    deg_u = R.row_nnz.astype(np.int64)
    deg_i = R.col_nnz.astype(np.int64)
    user_order = np.argsort(-deg_u, kind="stable").astype(np.int64)
    item_order = np.argsort(-deg_i, kind="stable").astype(np.int64)
    user_pos = np.empty(m, np.int64)
    user_pos[user_order] = np.arange(m)
    item_pos = np.empty(n, np.int64)
    item_pos[item_order] = np.arange(n)

    r, c, v = R.to_coo()
    rp = user_pos.astype(np.int32)[r]
    cp = item_pos.astype(np.int32)[c]

    align = 8 * num_shards // np.gcd(8, num_shards)     # lcm(8, N)
    budget = int(cfg.hybrid_dense_cells)
    if cfg.hybrid_panel_widths == "auto":
        # data-driven stair: widths AND boundaries chosen from the degree
        # distribution under the budget (Lagrangian + stair projection)
        panels = _auto_stair(rp, cp, m, n, budget, align,
                             max_panels=cfg.hybrid_max_panels)
        return _finish_plan(R, cfg, materialize_dense, num_shards, panels,
                            user_order, item_order, user_pos, item_pos,
                            deg_u, deg_i, rp, cp, v)

    widths = [n] + sorted({min(int(w), n) for w in cfg.hybrid_panel_widths
                           if 0 < int(w) < n}, reverse=True)
    # coverage prefix per width: P_w[x] = nnz of the x top users inside the
    # top-w items. One fused histogram over (user position x width class)
    # replaces a boolean-select + bincount pass per width (native OpenMP
    # counting path when available, np.bincount otherwise — identical).
    sub = np.asarray(widths[:0:-1], dtype=np.int64)        # ascending, < n
    ncls = sub.size + 1
    # class id by comparison chain: np.searchsorted over a 100M-element
    # int32 array against an int64 needle list measured ~16 s (dtype
    # promotion + generic binary search); |sub| compare-add passes are ~1 s
    key = rp * np.int32(ncls)
    for t in sub:
        key += cp >= np.int32(t)
    counts2d = key_count(key, m * ncls).reshape(m, ncls)
    csum = np.cumsum(counts2d, axis=1)     # csum[:, i]: nnz with cp < sub[i]
    prefixes = []
    for w in widths:                       # descending, n first
        cov = (csum[:, ncls - 1] if w >= n
               else csum[:, int(np.searchsorted(sub, w))])
        prefixes.append(np.concatenate([[0], np.cumsum(cov)]))

    cand = _candidate_boundaries(m, align, include_full=(num_shards == 1))
    best_r = _search_boundaries(prefixes, widths, cand, budget)

    panels = []
    r_prev = 0
    for rb, w in zip(best_r, widths):
        if rb > r_prev:
            panels.append((r_prev, rb, w))
            r_prev = rb

    return _finish_plan(R, cfg, materialize_dense, num_shards, panels,
                        user_order, item_order, user_pos, item_pos,
                        deg_u, deg_i, rp, cp, v)


def _finish_plan(R, cfg, materialize_dense, num_shards, panels,
                 user_order, item_order, user_pos, item_pos,
                 deg_u, deg_i, rp, cp, v) -> HybridPlan:
    """Split the degree-sorted COO into panel cells vs the sparse remainder
    for a given panel stair and assemble the HybridPlan."""
    m, n = R.rows, R.cols
    # split COO: panel cells vs sparse remainder — ONE stable partition by
    # panel id (remainder last) instead of a boolean-mask cascade per panel;
    # within each group the COO (CSR) order is preserved, byte-identical to
    # the mask formulation.
    P = len(panels)
    wband = np.asarray([w for _, _, w in panels] + [0], dtype=np.int32)
    band = np.zeros(rp.size, np.int32)
    for _, r1, _ in panels:                # <= a few compare-add passes
        band += rp >= np.int32(r1)
    pkey = np.where(cp < wband[band], band, np.int32(P))
    gptr, perm = stable_perm(pkey, P + 1)
    rp_s = rp[perm]
    cp_s, v_s = perm_gather(perm, cp, np.ascontiguousarray(v, np.float32))

    Rd, Md, panel_coo = [], [], []
    for p, (r0, r1, w) in enumerate(panels):
        seg = slice(gptr[p], gptr[p + 1])
        lr = (rp_s[seg] - r0).astype(np.int32)
        lc = cp_s[seg]
        lv = v_s[seg]
        if materialize_dense:
            A = np.zeros((r1 - r0, w), np.float32)
            M = np.zeros((r1 - r0, w), np.float32)
            A[lr, lc] = lv
            M[lr, lc] = 1.0
            Rd.append(A)
            Md.append(M)
        else:
            panel_coo.append((lr, lc, lv))

    lseg = slice(gptr[P], gptr[P + 1])
    R_light = from_coo(m, n, rp_s[lseg], cp_s[lseg], v_s[lseg])
    ell = build_ell_pair(R_light, min_width=cfg.ell_min_width,
                         num_shards=num_shards, index_space="entity")
    rows, cols = ell.rows_side, ell.cols_side

    return HybridPlan(
        user_order=user_order, item_order=item_order,
        user_pos=user_pos, item_pos=item_pos,
        panels=tuple(panels), ell=ell, nnz_light=int(gptr[P + 1] - gptr[P]),
        Rd=tuple(Rd), Md=tuple(Md),
        row_nnz=deg_u[user_order].astype(np.float32),
        col_nnz=deg_i[item_order].astype(np.float32),
        slot_of_upos=rows.slot_of_entity.astype(np.int32),
        slot_of_ipos=cols.slot_of_entity.astype(np.int32),
        upos_of_slot_safe=np.where(rows.entity_of_slot < 0, m,
                                   rows.entity_of_slot).astype(np.int32),
        ipos_of_slot_safe=np.where(cols.entity_of_slot < 0, n,
                                   cols.entity_of_slot).astype(np.int32),
        panel_coo=tuple(panel_coo) if panel_coo else None,
    )


def densify_panels(plan: HybridPlan, residual_dtype, *, sharding=None,
                   mask_dtype=jnp.bfloat16):
    """Device-side scatter of each panel's COO into its (rows, w) residual
    block + mask — ONE jitted scatter per panel (a fused all-panel
    scatter holds every output AND its zeros-init live at once). This is how the production train paths build
    panels: a host-materialized Netflix panel set is ~16 GB of RAM plus a
    multi-GB host->device ship, while the COO is ~nnz-sized.

    ``mask_dtype`` int8 halves the mask's footprint/read traffic with
    identical numerics ({0,1} exact; the sweeps convert at the operand
    load, cfg.mask_dtype). ``mask_dtype="nan"`` stores no mask at all —
    unobserved cells hold a NaN sentinel in the residual and ``masks`` is
    returned as an EMPTY tuple (the step derives the mask in-register)."""
    rdt = jnp.dtype(residual_dtype)

    @functools.partial(jax.jit, static_argnums=(3, 4))
    def _one(lr, lc, lv, rows_, w_):
        # chunked scatter: bounds the lane-padded (nnz, 2) index temp that
        # OOMs a fresh compile at Netflix-panel nnz (ops/densify.py)
        return densify_coo(lr, lc, lv, rows_, w_, rdt, mask_dtype)

    Rds, masks = [], []
    for (lr, lc, lv), (r0, r1, w) in zip(plan.panel_coo or (), plan.panels):
        Rd, Md = _one(jnp.asarray(lr), jnp.asarray(lc), jnp.asarray(lv),
                      r1 - r0, w)
        jax.block_until_ready(Rd)          # finish before the next scatter
        if sharding is not None:
            Rd = jax.device_put(Rd, sharding)
            if Md is not None:
                Md = jax.device_put(Md, sharding)
        Rds.append(Rd)
        if Md is not None:
            masks.append(Md)
    return tuple(Rds), tuple(masks)


def panel_operands(Rd, mask):
    """f32 (residual, mask) operands for the panel sweeps; ``mask`` None =
    NaN-sentinel panel (mask = ~isnan in-register)."""
    f32 = jnp.float32
    if mask is None:
        isn = jnp.isnan(Rd)
        return jnp.where(isn, f32(0), Rd.astype(f32)), (~isn).astype(f32)
    return Rd.astype(f32), mask.astype(f32)


def panel_col_sums(u, Rd, mask):
    """v-sweep partials over one panel: g[j] = Σ_i u_i·R_ij, h[j] = Σ_i
    u_i²·M_ij. Written as products + reductions, which XLA fuses with the
    operand conversion into one pass over the stored residual; a
    matrix-vector dot may instead be handed to a library call that needs
    the f32 operands materialized (a panel-sized temp each)."""
    Rf, Mf = panel_operands(Rd, mask)
    uc = u.astype(jnp.float32)[:, None]
    return (uc * Rf).sum(axis=0), (uc * uc * Mf).sum(axis=0)


def panel_row_sums(Rd, mask, v):
    """u-sweep partials over one panel: g[i] = Σ_j R_ij·v_j, h[i] = Σ_j
    M_ij·v_j² (same fused form as panel_col_sums)."""
    Rf, Mf = panel_operands(Rd, mask)
    vr = v.astype(jnp.float32)[None, :]
    return (Rf * vr).sum(axis=1), (Mf * (vr * vr)).sum(axis=1)


def make_hybrid_outer_step(plan: HybridPlan, lam: float, maxinneriter: int,
                           residual_dtype=jnp.float32, jit_compile=True,
                           nan_mask: bool = False,
                           panel_kernel: bool = False, nmf: bool = False,
                           defer_group: int = 0):
    """One outer iteration over all k ranks (lax.fori_loop), all parts.

    Sweep matvec operands are always f32 (storage dtypes upcast at the
    operand load). Negative result, measured at Netflix-100M fp8+int8:
    bf16 operands gave NO speedup (6.23 vs 6.03 s/iter — the convert pass
    count is unchanged) and the ~2^-9 operand rounding amplified through
    the rank recursion to >10% on weakly-determined factors.

    ``nan_mask``: panels carry no mask arrays (callers pass ``masks=()``) —
    unobserved cells are NaN in the residual; the update leaves them NaN
    (NaN + delta = NaN) and the sweeps derive mask = ~isnan in-register.

    ``panel_kernel`` (implies nan_mask): panel passes run through the fused
    Pallas kernels (ops/panel_pallas.py) — update + v-sweep partials in one
    read-modify-write pass and u-sweep partials in one read pass.
    Accumulation is blocked f32, so factors may differ from the XLA path at
    FMA/sum-order ULP level (golden tolerance unaffected).

    ``defer_group`` G > 0: the round-4 rank-deferred ELL tail. The residual
    lanes stay FROZEN for G consecutive ranks; every rank's two rank-1
    residual deltas (the deferred subtract of rank t-1's new outer product
    and rank t's add-back, src/CCD.cpp:100-134) are recorded in (·, 2G)
    side tables, the sweeps run as WIDE single-fusion gather-reduces
    against the frozen lanes plus algebraic cross-term corrections
    (ops/ell_ops.deferred_sweep), and the lanes are updated once per group
    in one 2G-wide flush pass (ops/ell_ops.deferred_flush): 2 per-rank
    update passes become corrections riding the sweep fusion plus 1/G
    amortized flushes. Numerically this changes only FMA/accumulation order (golden-tolerance
    equivalence tested); requires have_light and is ignored otherwise."""
    if panel_kernel and not nan_mask:
        raise ValueError("panel_kernel requires nan_mask")
    rows, cols = plan.ell.rows_side, plan.ell.cols_side
    panels = plan.panels
    lam_ = jnp.float32(lam)
    have_light = plan.nnz_light > 0
    rdt = residual_dtype
    m = plan.row_nnz.shape[0]
    n = plan.col_nnz.shape[0]
    f32 = jnp.float32

    G = int(defer_group) if have_light else 0
    dsigns = tuple((-1.0 if c % 2 == 0 else 1.0) for c in range(2 * G))

    def step(idx_r, idx_c, Rds, masks, vals_r, vals_c, W, H,
             u_pend, v_pend, row_nnz, col_nnz,
             upos_safe, ipos_safe, slot_of_upos, slot_of_ipos):
        if nan_mask:
            masks = (None,) * len(panels)

        def rank_body(t, carry):
            if G:
                (Rds, vals_r, vals_c, W, H, u_pend, v_pend,
                 U_def, V_def) = carry
            else:
                Rds, vals_r, vals_c, W, H, u_pend, v_pend = carry
            u_old = jax.lax.dynamic_slice_in_dim(W, t, 1, 0)[0]
            v_old = jax.lax.dynamic_slice_in_dim(H, t, 1, 0)[0]
            if G:
                # record this rank's two deferred rank-1 residual deltas
                # (subtract of rank t-1's new product via the pends, rank
                # t's add-back) in the group tables at columns (2j, 2j+1).
                # NO slot-space own tables: corrections combine in ENTITY
                # space inside fused_remap_combine, and the flush remaps
                # the group's own vectors once (amortized /G).
                jj = 2 * jnp.mod(t, G)
                U_def = jax.lax.dynamic_update_slice(
                    U_def, jnp.stack([u_pend, u_old], -1), (0, jj))
                V_def = jax.lax.dynamic_update_slice(
                    V_def, jnp.stack([v_pend, v_old], -1), (0, jj))

            # ---- dense panels: fused deferred-subtract + add-back, ONE
            # residual pass each (ccd_dense.py schedule; in oiter 1 H[t]==0
            # so the add-back vanishes — one compiled step covers all).
            # In panel_kernel mode the update is fused INTO the first
            # v-sweep kernel pass instead (same order: update, then sweep
            # with u_old). ----
            if not panel_kernel:
                new_Rds = []
                for (r0, r1, w), Rd, mask in zip(panels, Rds, masks):
                    delta = (jnp.outer(u_old[r0:r1], v_old[:w])
                             - jnp.outer(u_pend[r0:r1], v_pend[:w]))
                    if mask is None:     # NaN sentinel absorbs the delta
                        new_Rds.append(Rd + delta.astype(rdt))
                    else:
                        new_Rds.append(
                            Rd + (delta
                                  * mask.astype(delta.dtype)).astype(rdt))
                Rds = tuple(new_Rds)

            u, v = u_old, v_old
            for i in range(maxinneriter):
                # ---- v-sweep (items): panel matvecs + ELL partials ----
                g = jnp.zeros(n, f32)
                h = jnp.zeros(n, f32)
                if panel_kernel:
                    from ..ops.panel_pallas import (panel_update_vsweep,
                                                    panel_vsweep)
                    new_Rds = list(Rds)
                    for pi, (r0, r1, w) in enumerate(panels):
                        if i == 0:
                            new_Rds[pi], gp, hp = panel_update_vsweep(
                                new_Rds[pi], u_old[r0:r1], u_pend[r0:r1],
                                v_old[:w], v_pend[:w])
                        else:
                            gp, hp = panel_vsweep(new_Rds[pi], u[r0:r1],
                                                  )
                        g = g.at[:w].add(gp)
                        h = h.at[:w].add(hp)
                    Rds = tuple(new_Rds)
                else:
                    for (r0, r1, w), Rd, mask in zip(panels, Rds, masks):
                        gp, hp = panel_col_sums(u[r0:r1], Rd, mask)
                        g = g.at[:w].add(gp)
                        h = h.at[:w].add(hp)
                if have_light:
                    if G:
                        # wide single-fusion gather-reduce vs the FROZEN
                        # lanes + algebraic corrections for the group's
                        # recorded rank-1 deltas (deferred_sweep docstring);
                        # slot->entity remap fused with the entity-space
                        # correction combination (fused_remap_combine)
                        tab_c = extend_zero(
                            jnp.concatenate([u[:, None], U_def], 1))
                        S0, Sc, h_l = deferred_sweep(idx_c, vals_c, cols,
                                                     tab_c)
                        g_e, h_e = fused_remap_combine(
                            [S0] + Sc, h_l, slot_of_ipos, V_def.T, dsigns)
                    elif i == 0:
                        # ONE fused pass: the [u_pend, u_old] row-gather,
                        # the deferred subtract of rank t-1, the add-back
                        # AND the sweep partials all live in one lax.map
                        # chunk body — a tile fed to >1 consumer op re-runs
                        # the whole chunked gather per consumer
                        ovp, ovo = stacked_remap((v_pend, v_old), ipos_safe)
                        vals_c, g_l, h_l = fused_update_sweep(
                            idx_c, vals_c, cols,
                            extend_zero(jnp.stack([u_pend, u_old], -1)),
                            owns=(ovp, ovo), signs=(-1.0, 1.0), sweep_col=1)
                    else:
                        g_l, h_l = fused_sweep(
                            idx_c, vals_c, cols,
                            extend_zero(jnp.stack([u, u], -1)), sweep_col=0)
                    if not G:
                        g_e, h_e = stacked_remap((g_l, h_l), slot_of_ipos)
                    g = g + g_e
                    h = h + h_e
                # full-denominator guard (like ccd_dense._half_sweep):
                # covers empty entities (src/CCD.cpp:8) AND the degenerate
                # lambda=0 fully-explained-residual case
                den = lam_ * col_nnz + h
                v = jnp.where(den > 0, g / den, 0.0)
                if nmf:                  # libpmf -N semantics (dead in ref)
                    v = jnp.maximum(v, 0.0)

                # ---- u-sweep (users) ----
                gu = jnp.zeros(m, f32)
                hu = jnp.zeros(m, f32)
                if panel_kernel:
                    from ..ops.panel_pallas import panel_usweep
                    for (r0, r1, w), Rd in zip(panels, Rds):
                        gp, hp = panel_usweep(Rd, v[:w])
                        gu = gu.at[r0:r1].add(gp)
                        hu = hu.at[r0:r1].add(hp)
                else:
                    for (r0, r1, w), Rd, mask in zip(panels, Rds, masks):
                        gp, hp = panel_row_sums(Rd, mask, v[:w])
                        gu = gu.at[r0:r1].add(gp)
                        hu = hu.at[r0:r1].add(hp)
                if have_light:
                    if G:
                        tab_r = extend_zero(
                            jnp.concatenate([v[:, None], V_def], 1))
                        S0r, Scr, h_lr = deferred_sweep(idx_r, vals_r, rows,
                                                        tab_r)
                        gu_e, hu_e = fused_remap_combine(
                            [S0r] + Scr, h_lr, slot_of_upos, U_def.T,
                            dsigns)
                    elif i == 0:
                        # ONE fused pass with a 3-wide [v_pend, v_old, v]
                        # row-gather (same row-mode price as a pair): the
                        # deferred subtract of rank t-1, the add-back, and
                        # the sweep with the NEW v. The rank-t subtract is
                        # itself deferred through (u_pend, v_pend) — no
                        # second rows-side pass exists at all.
                        oup, ouo = stacked_remap((u_pend, u_old), upos_safe)
                        vals_r, g_lr, h_lr = fused_update_sweep(
                            idx_r, vals_r, rows,
                            extend_zero(jnp.stack([v_pend, v_old, v], -1)),
                            owns=(oup, ouo), signs=(-1.0, 1.0), sweep_col=2)
                    else:
                        g_lr, h_lr = fused_sweep(
                            idx_r, vals_r, rows,
                            extend_zero(jnp.stack([v, v], -1)), sweep_col=0)
                    if not G:
                        gu_e, hu_e = stacked_remap((g_lr, h_lr),
                                                   slot_of_upos)
                    gu = gu + gu_e
                    hu = hu + hu_e
                den_u = lam_ * row_nnz + hu
                u = jnp.where(den_u > 0, gu / den_u, 0.0)
                if nmf:
                    u = jnp.maximum(u, 0.0)

            # ---- write back (src/CCD.cpp:128-134); EVERY part's subtract
            # of rank t's new outer product is deferred to rank t+1 via the
            # SHARED (u_pend, v_pend) state — panels, cols-ELL and rows-ELL
            # uniformly (one fused pass per side per rank) ----
            W = jax.lax.dynamic_update_slice_in_dim(W, u[None], t, 0)
            H = jax.lax.dynamic_update_slice_in_dim(H, v[None], t, 0)
            if not G:
                return (Rds, vals_r, vals_c, W, H, u, v)

            # ---- group flush: apply the recorded 2G rank-1 deltas to the
            # frozen lanes in ONE 2G-wide pass per side, then clear the
            # tables. The LAST rank always flushes so the step returns
            # up-to-date lanes (checkpoint/resume parity); rank t's own new
            # outer product stays pending via (u, v) like every path ----
            def do_flush(args):
                vals_r, vals_c, U_def, V_def = args
                # the flush needs slot-space own vectors: remap the group's
                # 2G deferred columns ONCE here (amortized /G) instead of
                # keeping per-rank own tables
                OV = jnp.stack(stacked_remap(
                    [V_def[:, c] for c in range(2 * G)], ipos_safe))
                OU = jnp.stack(stacked_remap(
                    [U_def[:, c] for c in range(2 * G)], upos_safe))
                vals_c = deferred_flush(idx_c, vals_c, cols,
                                        extend_zero(U_def), OV, dsigns)
                vals_r = deferred_flush(idx_r, vals_r, rows,
                                        extend_zero(V_def), OU, dsigns)
                return (vals_r, vals_c, jnp.zeros_like(U_def),
                        jnp.zeros_like(V_def))

            pred = jnp.logical_or(jnp.mod(t, G) == G - 1,
                                  t == W.shape[0] - 1)
            (vals_r, vals_c, U_def, V_def) = jax.lax.cond(
                pred, do_flush, lambda a: a,
                (vals_r, vals_c, U_def, V_def))
            return (Rds, vals_r, vals_c, W, H, u, v, U_def, V_def)

        k = W.shape[0]
        if G:
            init = (Rds, vals_r, vals_c, W, H, u_pend, v_pend,
                    jnp.zeros((m, 2 * G), f32), jnp.zeros((n, 2 * G), f32))
            return jax.lax.fori_loop(0, k, rank_body, init)[:7]
        return jax.lax.fori_loop(
            0, k, rank_body, (Rds, vals_r, vals_c, W, H, u_pend, v_pend))

    if not jit_compile:
        return step
    return jax.jit(step, donate_argnums=(2, 4, 5, 6, 7, 8, 9))


def make_hybrid_phase_fns(plan: HybridPlan, lam: float, maxinneriter: int,
                          nan_mask: bool = False,
                          panel_kernel: bool = False, nmf: bool = False):
    """Phase-split step functions for the phase-timing mode (phase_loop.py)
    on the HYBRID backend, so the flagship produces the reference's
    rank/update split (GpuTimer-per-phase,
    /root/reference/cuda_src/CCD_CUDA.cu:336-381, printed at
    src/CCD.cpp:158). Plain reference schedule (add-back / sweeps /
    immediate subtract, src/CCD.cpp:74-139), each phase one fence-able
    dispatch covering ALL parts (panels + both ELL tail sides). Sweeps use
    the fused Pallas panel kernels when ``panel_kernel`` (the production
    read passes); the update phases use the XLA outer-product schedule — an
    update-only kernel would make the same one read-modify-write pass.

    State: (Rds, vals_r, vals_c, W, H); no pend state (the deferred
    subtract is a fusion trick — separable phases need the plain order)."""
    rows, cols = plan.ell.rows_side, plan.ell.cols_side
    panels = plan.panels
    lam_ = jnp.float32(lam)
    have_light = plan.nnz_light > 0
    f32 = jnp.float32
    m = plan.row_nnz.shape[0]
    n = plan.col_nnz.shape[0]

    def _panel_update(Rds, masks, u, v, sign):
        if nan_mask:
            masks = (None,) * len(panels)
        new = []
        for (r0, r1, w), Rd, mask in zip(panels, Rds, masks):
            delta = sign * jnp.outer(u[r0:r1], v[:w])
            if mask is None:               # NaN sentinel absorbs the delta
                new.append(Rd + delta.astype(Rd.dtype))
            else:
                new.append(Rd + (delta
                                 * mask.astype(delta.dtype)).astype(Rd.dtype))
        return tuple(new)

    def _ell_update(idx_r, idx_c, vals_r, vals_c, u, v, sign,
                    upos_safe, ipos_safe):
        def uslots(x):
            return jnp.concatenate([x, jnp.zeros(1, x.dtype)])[upos_safe]

        def islots(x):
            return jnp.concatenate([x, jnp.zeros(1, x.dtype)])[ipos_safe]

        pc = paired_gather(extend_zero(jnp.stack([u, u], -1)), idx_c)
        vals_c = residual_update(idx_c, vals_c, cols, None, islots(v), sign,
                                 gathered=[p[0] for p in pc])
        pr = paired_gather(extend_zero(jnp.stack([v, v], -1)), idx_r)
        vals_r = residual_update(idx_r, vals_r, rows, None, uslots(u), sign,
                                 gathered=[p[0] for p in pr])
        return vals_r, vals_c

    def _both(idx_r, idx_c, Rds, masks, vals_r, vals_c, W, H, t, sign,
              upos_safe, ipos_safe):
        u = jax.lax.dynamic_slice_in_dim(W, t, 1, 0)[0]
        v = jax.lax.dynamic_slice_in_dim(H, t, 1, 0)[0]
        Rds = _panel_update(Rds, masks, u, v, sign)
        if have_light:
            vals_r, vals_c = _ell_update(idx_r, idx_c, vals_r, vals_c, u, v,
                                         sign, upos_safe, ipos_safe)
        return Rds, vals_r, vals_c

    @functools.partial(jax.jit, donate_argnums=(2, 4, 5), static_argnums=())
    def addback(idx_r, idx_c, Rds, masks, vals_r, vals_c, W, H, t,
                upos_safe, ipos_safe):
        return _both(idx_r, idx_c, Rds, masks, vals_r, vals_c, W, H, t,
                     1.0, upos_safe, ipos_safe)

    @functools.partial(jax.jit, donate_argnums=(2, 4, 5))
    def subtract(idx_r, idx_c, Rds, masks, vals_r, vals_c, W, H, t,
                 upos_safe, ipos_safe):
        return _both(idx_r, idx_c, Rds, masks, vals_r, vals_c, W, H, t,
                     -1.0, upos_safe, ipos_safe)

    @functools.partial(jax.jit, donate_argnums=(6, 7))
    def sweeps(idx_r, idx_c, Rds, masks, vals_r, vals_c, W, H, t,
               row_nnz, col_nnz, slot_of_upos, slot_of_ipos):
        if nan_mask:
            masks_ = (None,) * len(panels)
        else:
            masks_ = masks
        u = jax.lax.dynamic_slice_in_dim(W, t, 1, 0)[0]
        v = jax.lax.dynamic_slice_in_dim(H, t, 1, 0)[0]

        for _ in range(maxinneriter):      # src/CCD.cpp:107-123
            g = jnp.zeros(n, f32)
            h = jnp.zeros(n, f32)
            if panel_kernel:
                from ..ops.panel_pallas import panel_vsweep
                for (r0, r1, w), Rd in zip(panels, Rds):
                    gp, hp = panel_vsweep(Rd, u[r0:r1])
                    g = g.at[:w].add(gp)
                    h = h.at[:w].add(hp)
            else:
                for (r0, r1, w), Rd, mask in zip(panels, Rds, masks_):
                    gp, hp = panel_col_sums(u[r0:r1], Rd, mask)
                    g = g.at[:w].add(gp)
                    h = h.at[:w].add(hp)
            if have_light:
                pc = paired_gather(extend_zero(jnp.stack([u, u], -1)), idx_c)
                g_l, h_l, _ = sweep_partials(idx_c, vals_c, cols, None,
                                             gathered=[p[0] for p in pc])
                g = g + g_l[slot_of_ipos]
                h = h + h_l[slot_of_ipos]
            den = lam_ * col_nnz + h
            v = jnp.where(den > 0, g / den, 0.0)
            if nmf:
                v = jnp.maximum(v, 0.0)

            gu = jnp.zeros(m, f32)
            hu = jnp.zeros(m, f32)
            if panel_kernel:
                from ..ops.panel_pallas import panel_usweep
                for (r0, r1, w), Rd in zip(panels, Rds):
                    gp, hp = panel_usweep(Rd, v[:w])
                    gu = gu.at[r0:r1].add(gp)
                    hu = hu.at[r0:r1].add(hp)
            else:
                for (r0, r1, w), Rd, mask in zip(panels, Rds, masks_):
                    gp, hp = panel_row_sums(Rd, mask, v[:w])
                    gu = gu.at[r0:r1].add(gp)
                    hu = hu.at[r0:r1].add(hp)
            if have_light:
                pr = paired_gather(extend_zero(jnp.stack([v, v], -1)), idx_r)
                g_lr, h_lr, _ = sweep_partials(idx_r, vals_r, rows, None,
                                               gathered=[p[0] for p in pr])
                gu = gu + g_lr[slot_of_upos]
                hu = hu + h_lr[slot_of_upos]
            den_u = lam_ * row_nnz + hu
            u = jnp.where(den_u > 0, gu / den_u, 0.0)
            if nmf:
                u = jnp.maximum(u, 0.0)

        W = jax.lax.dynamic_update_slice_in_dim(W, u[None], t, 0)
        H = jax.lax.dynamic_update_slice_in_dim(H, v[None], t, 0)
        return W, H

    return addback, sweeps, subtract


def ccd_hybrid_train(R: RatingMatrix, W0: np.ndarray, H0: np.ndarray,
                     T: TestCOO, cfg: Config, *,
                     callback: Optional[Callable[[IterStats], None]] = None,
                     plan: Optional[HybridPlan] = None,
                     ckpt_every: int = 0, ckpt_fn=None, resume=None,
                     rank_callback=None,
                     ) -> tuple[np.ndarray, np.ndarray, list[IterStats]]:
    """Train CCD++ on the panel-hybrid backend (single device). Returns
    (W, H, stats) in the reference's rank-major ORIGINAL entity order.
    Checkpoint payloads carry every panel residual, both ELL residual value
    sets, the factors (sorted order) and the pending outer product — all of
    it training state (src/CCD.cpp:100-134).

    ``cfg.hybrid_transpose``: True runs the SAME
    solver on R^T — the stair covers top-items x user prefixes, the item
    side carries the seeded factors and users are swept first; factors
    swap back on return, so the caller contract is unchanged. "auto"
    geometry-plans both orientations and keeps the smaller tail. The
    transposed trajectory equals the reference run on the transposed
    problem (tested), not the untransposed one."""
    if plan is None and cfg.hybrid_transpose:
        cfg_nt = dataclasses.replace(cfg, hybrid_transpose=False)
        use_t, plan_n, plan_t = True, None, None
        if cfg.hybrid_transpose == "auto":
            plan_n = plan_hybrid(R, cfg_nt, materialize_dense=False)
            plan_t = plan_hybrid(R.transpose(), cfg_nt,
                                 materialize_dense=False)
            use_t = plan_t.nnz_light < plan_n.nnz_light
        if use_t:
            Tt = make_test(T.cols, T.rows, T.col_idx, T.row_idx, T.val)
            Wt, Ht, stats = ccd_hybrid_train(
                R.transpose(), H0, W0, Tt, cfg_nt, callback=callback,
                plan=plan_t, ckpt_every=ckpt_every, ckpt_fn=ckpt_fn,
                resume=resume, rank_callback=rank_callback)
            return Ht, Wt, stats
        plan = plan_n
    if plan is None:
        plan = plan_hybrid(R, cfg, materialize_dense=False)
    rows, cols = plan.ell.rows_side, plan.ell.cols_side
    rdt = jnp.dtype(cfg.residual_dtype)
    k = W0.shape[0]
    m, n = R.rows, R.cols

    idx_r = tuple(jnp.asarray(b.idx) for b in rows.buckets)
    idx_c = tuple(jnp.asarray(b.idx) for b in cols.buckets)
    nan_mask = cfg.mask_dtype == "nan"
    kernel = cfg.hybrid_panel_kernel
    if plan.panel_coo is not None:
        dense_Rds, masks = densify_panels(plan, rdt,
                                          mask_dtype=cfg.mask_dtype)
    elif nan_mask:                         # materialized plan, NaN sentinel
        dense_Rds = tuple(
            jnp.where(jnp.asarray(Mp) > 0, jnp.asarray(Rp),
                      jnp.nan).astype(rdt)
            for Rp, Mp in zip(plan.Rd, plan.Md))
        masks = ()
    else:                                  # caller passed a materialized plan
        mdt = jnp.dtype(cfg.mask_dtype)
        dense_Rds = tuple(jnp.asarray(Rp.astype(rdt)) for Rp in plan.Rd)
        masks = tuple(jnp.asarray(Mp.astype(mdt)) for Mp in plan.Md)

    W0 = np.asarray(W0, np.float32)
    start_oiter = 1
    if resume is not None:
        start_oiter = int(resume["oiter"]) + 1
        Rds = tuple(jnp.asarray(np.asarray(resume[f"Rd_{i}"]).astype(rdt))
                    for i in range(len(plan.panels)))
        W = jnp.asarray(resume["W"])
        H = jnp.asarray(resume["H"])
        u_pend = jnp.asarray(resume["u_pend"])
        v_pend = jnp.asarray(resume["v_pend"])
        vals_r = tuple(jnp.asarray(resume[f"vals_r_{i}"])
                       for i in range(len(rows.buckets)))
        vals_c = tuple(jnp.asarray(resume[f"vals_c_{i}"])
                       for i in range(len(cols.buckets)))
    else:
        Rds = dense_Rds
        W = jnp.asarray(W0[:, plan.user_order])        # sorted entity order
        H = jnp.zeros((k, n), jnp.float32)             # src/CCD.cpp:56-60
        u_pend = jnp.zeros(m, jnp.float32)
        v_pend = jnp.zeros(n, jnp.float32)
        vals_r = tuple(jnp.asarray(b.val) for b in rows.buckets)
        vals_c = tuple(jnp.asarray(b.val) for b in cols.buckets)

    row_nnz = jnp.asarray(plan.row_nnz)
    col_nnz = jnp.asarray(plan.col_nnz)
    upos_safe = jnp.asarray(plan.upos_of_slot_safe)
    ipos_safe = jnp.asarray(plan.ipos_of_slot_safe)
    slot_of_upos = jnp.asarray(plan.slot_of_upos)
    slot_of_ipos = jnp.asarray(plan.slot_of_ipos)

    ti = jnp.asarray(plan.user_pos[T.row_idx])
    tj = jnp.asarray(plan.item_pos[T.col_idx])
    tv = jnp.asarray(T.val)

    rmse_fn_p = jax.jit(functools.partial(
        calrmse_device, entity_major=False,
        chunk=default_eval_chunk(T.nnz, cfg.eval_chunk)))

    if cfg.phase_timing:
        if resume is not None and (np.asarray(resume["u_pend"]).any()
                                   or np.asarray(resume["v_pend"]).any()):
            raise ValueError("cannot resume a fused-schedule checkpoint "
                             "(pending outer product) in phase-timing mode")
        ab, sw, sub = make_hybrid_phase_fns(
            plan, cfg.lambda_, cfg.maxinneriter, nan_mask=nan_mask,
            panel_kernel=kernel, nmf=cfg.do_nmf)
        pbox = {"s": (Rds, vals_r, vals_c, W, H)}

        def _ab(t):
            Rds_, vals_r_, vals_c_, W_, H_ = pbox["s"]
            Rds_, vals_r_, vals_c_ = ab(idx_r, idx_c, Rds_, masks, vals_r_,
                                        vals_c_, W_, H_, t, upos_safe,
                                        ipos_safe)
            pbox["s"] = (Rds_, vals_r_, vals_c_, W_, H_)
            return vals_r_ if vals_r_ else Rds_

        def _sw(t):
            Rds_, vals_r_, vals_c_, W_, H_ = pbox["s"]
            W_, H_ = sw(idx_r, idx_c, Rds_, masks, vals_r_, vals_c_, W_, H_,
                        t, row_nnz, col_nnz, slot_of_upos, slot_of_ipos)
            pbox["s"] = (Rds_, vals_r_, vals_c_, W_, H_)
            return W_

        def _sub(t):
            Rds_, vals_r_, vals_c_, W_, H_ = pbox["s"]
            Rds_, vals_r_, vals_c_ = sub(idx_r, idx_c, Rds_, masks, vals_r_,
                                         vals_c_, W_, H_, t, upos_safe,
                                         ipos_safe)
            pbox["s"] = (Rds_, vals_r_, vals_c_, W_, H_)
            return vals_r_ if vals_r_ else Rds_

        def get_rank_rows(t):
            _, _, _, W_, H_ = pbox["s"]
            return np.asarray(W_[t]), np.asarray(H_[t])

        def do_rmse_p():
            _, _, _, W_, H_ = pbox["s"]
            return rmse_fn_p(ti, tj, tv, W_, H_)

        def get_payload_p():
            Rds_, vals_r_, vals_c_, W_, H_ = pbox["s"]
            payload = {"W": np.asarray(W_), "H": np.asarray(H_),
                       "u_pend": np.zeros(m, np.float32),
                       "v_pend": np.zeros(n, np.float32)}
            for i, Rp in enumerate(Rds_):
                payload[f"Rd_{i}"] = np.asarray(Rp)
            for i, v_ in enumerate(vals_r_):
                payload[f"vals_r_{i}"] = np.asarray(v_)
            for i, v_ in enumerate(vals_c_):
                payload[f"vals_c_{i}"] = np.asarray(v_)
            return payload

        from .phase_loop import phased_ccd_loop
        stats = phased_ccd_loop(
            start_oiter=start_oiter, maxiter=cfg.maxiter, k=k,
            addback=_ab, sweeps=_sw, subtract=_sub, do_rmse=do_rmse_p,
            get_rank_rows=get_rank_rows,
            ti=plan.user_pos[T.row_idx], tj=plan.item_pos[T.col_idx],
            tv=np.asarray(T.val),
            callback=callback, rank_callback=rank_callback,
            ckpt_every=ckpt_every, ckpt_fn=ckpt_fn,
            get_payload=get_payload_p,
            early_stop_eps=cfg.eps if cfg.early_stop else 0.0)
        _, _, _, W_, H_ = pbox["s"]
        W_ent = np.asarray(W_)[:, plan.user_pos]
        H_ent = np.asarray(H_)[:, plan.item_pos]
        return W_ent, H_ent, stats

    step_fn = make_hybrid_outer_step(plan, cfg.lambda_, cfg.maxinneriter,
                                     residual_dtype=rdt, nan_mask=nan_mask,
                                     panel_kernel=kernel,
                                     nmf=cfg.do_nmf,
                                     defer_group=cfg.hybrid_defer_group)
    rmse_fn = jax.jit(functools.partial(
        calrmse_device, entity_major=False,
        chunk=default_eval_chunk(T.nnz, cfg.eval_chunk)))

    box = {"s": (Rds, vals_r, vals_c, W, H, u_pend, v_pend)}

    def do_step():
        Rds, vals_r, vals_c, W, H, up, vp = box["s"]
        box["s"] = step_fn(idx_r, idx_c, Rds, masks, vals_r, vals_c, W, H,
                           up, vp, row_nnz, col_nnz, upos_safe, ipos_safe,
                           slot_of_upos, slot_of_ipos)
        return box["s"][3]

    def do_rmse():
        _, _, _, W, H, _, _ = box["s"]
        return rmse_fn(ti, tj, tv, W, H)

    def get_payload():
        Rds, vals_r, vals_c, W, H, up, vp = box["s"]
        payload = {"W": np.asarray(W), "H": np.asarray(H),
                   "u_pend": np.asarray(up), "v_pend": np.asarray(vp)}
        for i, Rp in enumerate(Rds):
            payload[f"Rd_{i}"] = np.asarray(Rp)
        for i, v_ in enumerate(vals_r):
            payload[f"vals_r_{i}"] = np.asarray(v_)
        for i, v_ in enumerate(vals_c):
            payload[f"vals_c_{i}"] = np.asarray(v_)
        return payload

    stats = pipelined_loop(
        start_oiter=start_oiter, maxiter=cfg.maxiter,
        fuse=cfg.fused_outer_iters, do_step=do_step, do_rmse=do_rmse,
        callback=callback, ckpt_every=ckpt_every, ckpt_fn=ckpt_fn,
        get_payload=get_payload,
        early_stop_eps=cfg.eps if cfg.early_stop else 0.0)

    _, _, _, W, H, _, _ = box["s"]
    W_ent = np.asarray(W)[:, plan.user_pos]            # unsort to orig order
    H_ent = np.asarray(H)[:, plan.item_pos]
    return W_ent, H_ent, stats
