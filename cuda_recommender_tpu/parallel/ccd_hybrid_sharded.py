"""Panel-hybrid CCD++, sharded over a 1-D device mesh with shard_map.

Decomposition (new design — the reference is single-GPU,
/root/reference/cuda_src/CCD_CUDA.cu:170): every dense panel's rows are
split into equal per-device blocks (the planner N-aligns panel boundaries),
and the ELL remainder is built shard-uniform (data/ell.py num_shards=N), so
all residual state — panel blocks and bucket value tiles — is device-local
and never communicated. The factor tables W (k, m) / H (k, n) are
REPLICATED (a rank's vectors are ~2 MB at Netflix scale — tiny next to the
per-rank compute): each device computes partial per-entity sweep sums
(g, h) from its panel blocks + its ELL rows, and ONE ``psum`` per half-sweep
(a few MB) makes the new factor vector identical everywhere. This
is the communication-minimal layout for a doubly-sharded residual: ratings
never move, only (m,)/(n,)-sized partial vectors do.

The per-device math is byte-identical to solvers/ccd_hybrid.py (same panel
matvec schedule, same fused single-pass ELL tail, same fully deferred
pends), so sharded == single-device numerically
(tests/test_hybrid_sharded.py).

Multi-host note: this train wrapper device_puts GLOBAL host arrays, which is
a single-process (1-host, N-chip) pattern. Under real multi-process
jax.distributed, feed each host's panel/ELL row blocks with
multihost.assemble_global (factors replicated per device) — exercised for
real by tests/multihost_hybrid_worker.py: 2 OS processes x 4 devices, Gloo
psum per half-sweep, result matches the single-process sharded run
(tests/test_multihost.py::test_two_process_hybrid_matches_single_process).
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core.config import Config
from ..data.sparse import RatingMatrix, TestCOO
from ..eval.metrics import calrmse_device, default_eval_chunk
from ..ops.ell_ops import (extend_zero, fused_sweep, fused_update_sweep,
                           paired_gather, residual_update, stacked_remap,
                           sweep_partials)
from ..solvers.ccd_hybrid import (HybridPlan, densify_panels,
                                  panel_col_sums, panel_row_sums,
                                  plan_hybrid)
from ..solvers.pipeline import pipelined_loop
from ..solvers.reference import IterStats
from .mesh import AXIS


def make_sharded_hybrid_step(plan: HybridPlan, mesh: Mesh, lam: float,
                             maxinneriter: int, residual_dtype=jnp.float32,
                             axis: str = AXIS, nan_mask: bool = False,
                             panel_kernel: bool = False, nmf: bool = False):
    """``panel_kernel``: each device runs the fused Pallas panel passes
    (ops/panel_pallas.py) on its LOCAL row block — the residual update is
    fused into the first v-sweep kernel and the mask is derived in-register
    from the NaN sentinel; the psum collective pattern is unchanged."""
    if panel_kernel and not nan_mask:
        raise ValueError("panel_kernel requires nan_mask")
    rows_g, cols_g = plan.ell.rows_side, plan.ell.cols_side
    rows, cols = rows_g.local_view(), cols_g.local_view()
    panels = plan.panels
    N = mesh.devices.size
    lam_ = jnp.float32(lam)
    have_light = plan.nnz_light > 0
    rdt = residual_dtype
    m = plan.row_nnz.shape[0]
    n = plan.col_nnz.shape[0]
    f32 = jnp.float32

    def step_local(idx_r, idx_c, Rds, masks, vals_r, vals_c, W, H,
                   u_pend, v_pend, row_nnz, col_nnz,
                   lsu, lsi, eosr, eosi):
        d = jax.lax.axis_index(axis)
        lsu_, lsi_ = lsu[0], lsi[0]
        if nan_mask:
            masks = (None,) * len(panels)

        def panel_rows(x, r0, lr):
            return jax.lax.dynamic_slice(x, (r0 + d * lr,), (lr,))

        def rank_body(t, carry):
            Rds, vals_r, vals_c, W, H, u_pend, v_pend = carry
            u_old = jax.lax.dynamic_slice_in_dim(W, t, 1, 0)[0]
            v_old = jax.lax.dynamic_slice_in_dim(H, t, 1, 0)[0]

            # dense panels: fused deferred-subtract + add-back on the LOCAL
            # row block of each panel. In panel_kernel mode the update is
            # fused INTO the first v-sweep kernel pass instead.
            if not panel_kernel:
                new_Rds = []
                for (r0, r1, w), Rd, mask in zip(panels, Rds, masks):
                    lr = (r1 - r0) // N
                    delta = (jnp.outer(panel_rows(u_old, r0, lr), v_old[:w])
                             - jnp.outer(panel_rows(u_pend, r0, lr),
                                         v_pend[:w]))
                    if mask is None:     # NaN sentinel absorbs the delta
                        new_Rds.append(Rd + delta.astype(rdt))
                    else:
                        new_Rds.append(
                            Rd
                            + (delta * mask.astype(delta.dtype)).astype(rdt))
                Rds = tuple(new_Rds)

            u, v = u_old, v_old
            for i in range(maxinneriter):
                # ---- v-sweep: local panel matvec + local ELL partials,
                # ONE psum makes (g, h) global ----
                g = jnp.zeros(n, f32)
                h = jnp.zeros(n, f32)
                if panel_kernel:
                    from ..ops.panel_pallas import (panel_update_vsweep,
                                                    panel_vsweep)
                    new_Rds = list(Rds)
                    for pi, (r0, r1, w) in enumerate(panels):
                        Rd = new_Rds[pi]
                        lr = (r1 - r0) // N      # entity rows per device
                        if i == 0:
                            Rd, gp, hp = panel_update_vsweep(
                                Rd, panel_rows(u_old, r0, lr),
                                panel_rows(u_pend, r0, lr),
                                v_old[:w], v_pend[:w])
                            new_Rds[pi] = Rd
                        else:
                            gp, hp = panel_vsweep(
                                Rd, panel_rows(u, r0, lr))
                        g = g.at[:w].add(gp)
                        h = h.at[:w].add(hp)
                    Rds = tuple(new_Rds)
                else:
                    for (r0, r1, w), Rd, mask in zip(panels, Rds, masks):
                        lr = (r1 - r0) // N
                        gp, hp = panel_col_sums(panel_rows(u, r0, lr), Rd,
                                                mask)
                        g = g.at[:w].add(gp)
                        h = h.at[:w].add(hp)
                if have_light:
                    if i == 0:
                        # fused single-consumer pass (see ccd_hybrid.py);
                        # entity vectors remapped to LOCAL slots via eosi
                        ovp, ovo = stacked_remap((v_pend, v_old), eosi)
                        vals_c, g_l, h_l = fused_update_sweep(
                            idx_c, vals_c, cols,
                            extend_zero(jnp.stack([u_pend, u_old], -1)),
                            owns=(ovp, ovo), signs=(-1.0, 1.0), sweep_col=1)
                    else:
                        g_l, h_l = fused_sweep(
                            idx_c, vals_c, cols,
                            extend_zero(jnp.stack([u, u], -1)), sweep_col=0)
                    g_e, h_e = stacked_remap((g_l, h_l), lsi_)
                    g = g + g_e
                    h = h + h_e
                g, h = jax.lax.psum((g, h), axis)
                den = lam_ * col_nnz + h
                v = jnp.where(den > 0, g / den, 0.0)
                if nmf:                  # libpmf -N semantics (dead in ref)
                    v = jnp.maximum(v, 0.0)

                # ---- u-sweep ----
                gu = jnp.zeros(m, f32)
                hu = jnp.zeros(m, f32)
                if panel_kernel:
                    from ..ops.panel_pallas import panel_usweep
                    for (r0, r1, w), Rd in zip(panels, Rds):
                        lr = (r1 - r0) // N
                        gp, hp = panel_usweep(Rd, v[:w])
                        off = r0 + d * lr
                        gu = jax.lax.dynamic_update_slice(gu, gp, (off,))
                        hu = jax.lax.dynamic_update_slice(hu, hp, (off,))
                else:
                    for (r0, r1, w), Rd, mask in zip(panels, Rds, masks):
                        lr = (r1 - r0) // N
                        gp, hp = panel_row_sums(Rd, mask, v[:w])
                        off = r0 + d * lr
                        gu = jax.lax.dynamic_update_slice(gu, gp, (off,))
                        hu = jax.lax.dynamic_update_slice(hu, hp, (off,))
                if have_light:
                    if i == 0:
                        oup, ouo = stacked_remap((u_pend, u_old), eosr)
                        vals_r, g_lr, h_lr = fused_update_sweep(
                            idx_r, vals_r, rows,
                            extend_zero(jnp.stack([v_pend, v_old, v], -1)),
                            owns=(oup, ouo), signs=(-1.0, 1.0), sweep_col=2)
                    else:
                        g_lr, h_lr = fused_sweep(
                            idx_r, vals_r, rows,
                            extend_zero(jnp.stack([v, v], -1)), sweep_col=0)
                    gu_e, hu_e = stacked_remap((g_lr, h_lr), lsu_)
                    gu = gu + gu_e
                    hu = hu + hu_e
                gu, hu = jax.lax.psum((gu, hu), axis)
                den_u = lam_ * row_nnz + hu
                u = jnp.where(den_u > 0, gu / den_u, 0.0)
                if nmf:
                    u = jnp.maximum(u, 0.0)

            W = jax.lax.dynamic_update_slice_in_dim(W, u[None], t, 0)
            H = jax.lax.dynamic_update_slice_in_dim(H, v[None], t, 0)
            return (Rds, vals_r, vals_c, W, H, u, v)

        k = W.shape[0]
        return jax.lax.fori_loop(
            0, k, rank_body, (Rds, vals_r, vals_c, W, H, u_pend, v_pend))

    nb_r, nb_c, npan = len(rows.buckets), len(cols.buckets), len(panels)
    nmask = 0 if nan_mask else npan
    bspec = P(axis, None)
    rep = P()
    in_specs = (tuple([bspec] * nb_r), tuple([bspec] * nb_c),
                tuple([bspec] * npan), tuple([bspec] * nmask),
                tuple([bspec] * nb_r), tuple([bspec] * nb_c),
                rep, rep, rep, rep, rep, rep,
                P(axis, None), P(axis, None), P(axis), P(axis))
    out_specs = (tuple([bspec] * npan),
                 tuple([bspec] * nb_r), tuple([bspec] * nb_c),
                 rep, rep, rep, rep)
    fn = jax.shard_map(step_local, mesh=mesh, in_specs=in_specs,
                       out_specs=out_specs, check_vma=False)
    return jax.jit(fn, donate_argnums=(2, 4, 5, 6, 7, 8, 9))


def make_sharded_hybrid_phase_fns(plan: HybridPlan, mesh: Mesh, lam: float,
                                  maxinneriter: int = 1, axis: str = AXIS,
                                  nan_mask: bool = False, nmf: bool = False):
    """Phase-split (addback / sweeps / subtract) shard_map dispatches for
    the SHARDED hybrid step — multi-chip telemetry parity with the
    single-device make_hybrid_phase_fns: each phase is
    one fence-able collective dispatch over the mesh, so the iteration
    line's rank_time/update_time split (the reference's per-phase GpuTimer,
    /root/reference/cuda_src/CCD_CUDA.cu:336-381, printed at
    src/CCD.cpp:158) carries real measured times on a device mesh.

    Same plain reference schedule as the single-chip phase fns (no pend
    state — separable phases need the explicit add-back/subtract order,
    src/CCD.cpp:74-139); per-device partials + ONE psum per half-sweep like
    the fused sharded step. XLA panel schedule (the phase split is for
    attribution, not speed). State: (Rds, vals_r, vals_c, W, H)."""
    rows_g, cols_g = plan.ell.rows_side, plan.ell.cols_side
    rows, cols = rows_g.local_view(), cols_g.local_view()
    panels = plan.panels
    N = mesh.devices.size
    lam_ = jnp.float32(lam)
    have_light = plan.nnz_light > 0
    m = plan.row_nnz.shape[0]
    n = plan.col_nnz.shape[0]
    f32 = jnp.float32

    def _update_local(idx_r, idx_c, Rds, masks, vals_r, vals_c, W, H, t,
                      sign, eosr, eosi):
        d = jax.lax.axis_index(axis)
        if nan_mask:
            masks = (None,) * len(panels)
        u = jax.lax.dynamic_slice_in_dim(W, t, 1, 0)[0]
        v = jax.lax.dynamic_slice_in_dim(H, t, 1, 0)[0]
        new = []
        for (r0, r1, w), Rd, mask in zip(panels, Rds, masks):
            lr = (r1 - r0) // N
            ul = jax.lax.dynamic_slice(u, (r0 + d * lr,), (lr,))
            delta = jnp.float32(sign) * jnp.outer(ul, v[:w])
            if mask is None:
                new.append(Rd + delta.astype(Rd.dtype))
            else:
                new.append(Rd + (delta
                                 * mask.astype(delta.dtype)).astype(Rd.dtype))
        Rds = tuple(new)
        if have_light:
            ov = stacked_remap((v, v), eosi)[0]
            pc = paired_gather(extend_zero(jnp.stack([u, u], -1)), idx_c)
            vals_c = residual_update(idx_c, vals_c, cols, None, ov, sign,
                                     gathered=[p[0] for p in pc])
            ou = stacked_remap((u, u), eosr)[0]
            pr = paired_gather(extend_zero(jnp.stack([v, v], -1)), idx_r)
            vals_r = residual_update(idx_r, vals_r, rows, None, ou, sign,
                                     gathered=[p[0] for p in pr])
        return Rds, vals_r, vals_c

    def _sweeps_local(idx_r, idx_c, Rds, masks, vals_r, vals_c, W, H, t,
                      row_nnz, col_nnz, lsu, lsi):
        d = jax.lax.axis_index(axis)
        lsu_, lsi_ = lsu[0], lsi[0]
        if nan_mask:
            masks = (None,) * len(panels)
        u = jax.lax.dynamic_slice_in_dim(W, t, 1, 0)[0]
        v = jax.lax.dynamic_slice_in_dim(H, t, 1, 0)[0]
        for _ in range(maxinneriter):
            g = jnp.zeros(n, f32)
            h = jnp.zeros(n, f32)
            for (r0, r1, w), Rd, mask in zip(panels, Rds, masks):
                lr = (r1 - r0) // N
                ul = jax.lax.dynamic_slice(u, (r0 + d * lr,), (lr,))
                gp, hp = panel_col_sums(ul, Rd, mask)
                g = g.at[:w].add(gp)
                h = h.at[:w].add(hp)
            if have_light:
                pc = paired_gather(extend_zero(jnp.stack([u, u], -1)),
                                   idx_c)
                g_l, h_l, _ = sweep_partials(idx_c, vals_c, cols, None,
                                             gathered=[p[0] for p in pc])
                ge, he = stacked_remap((g_l, h_l), lsi_)
                g = g + ge
                h = h + he
            g, h = jax.lax.psum((g, h), axis)
            den = lam_ * col_nnz + h
            v = jnp.where(den > 0, g / den, 0.0)
            if nmf:
                v = jnp.maximum(v, 0.0)

            gu = jnp.zeros(m, f32)
            hu = jnp.zeros(m, f32)
            for (r0, r1, w), Rd, mask in zip(panels, Rds, masks):
                lr = (r1 - r0) // N
                gp, hp = panel_row_sums(Rd, mask, v[:w])
                off = r0 + d * lr
                gu = jax.lax.dynamic_update_slice(gu, gp, (off,))
                hu = jax.lax.dynamic_update_slice(hu, hp, (off,))
            if have_light:
                pr = paired_gather(extend_zero(jnp.stack([v, v], -1)),
                                   idx_r)
                g_lr, h_lr, _ = sweep_partials(idx_r, vals_r, rows, None,
                                               gathered=[p[0] for p in pr])
                gue, hue = stacked_remap((g_lr, h_lr), lsu_)
                gu = gu + gue
                hu = hu + hue
            gu, hu = jax.lax.psum((gu, hu), axis)
            den_u = lam_ * row_nnz + hu
            u = jnp.where(den_u > 0, gu / den_u, 0.0)
            if nmf:
                u = jnp.maximum(u, 0.0)
        W = jax.lax.dynamic_update_slice_in_dim(W, u[None], t, 0)
        H = jax.lax.dynamic_update_slice_in_dim(H, v[None], t, 0)
        return W, H

    nb_r, nb_c, npan = len(rows.buckets), len(cols.buckets), len(panels)
    nmask = 0 if nan_mask else npan
    bspec = P(axis, None)
    rep = P()
    upd_in = (tuple([bspec] * nb_r), tuple([bspec] * nb_c),
              tuple([bspec] * npan), tuple([bspec] * nmask),
              tuple([bspec] * nb_r), tuple([bspec] * nb_c),
              rep, rep, rep, P(axis), P(axis))
    upd_out = (tuple([bspec] * npan),
               tuple([bspec] * nb_r), tuple([bspec] * nb_c))
    sw_in = (tuple([bspec] * nb_r), tuple([bspec] * nb_c),
             tuple([bspec] * npan), tuple([bspec] * nmask),
             tuple([bspec] * nb_r), tuple([bspec] * nb_c),
             rep, rep, rep, rep, rep, P(axis, None), P(axis, None))
    sw_out = (rep, rep)

    def _wrap_update(sign):
        def local(idx_r, idx_c, Rds, masks, vals_r, vals_c, W, H, t,
                  eosr, eosi):
            return _update_local(idx_r, idx_c, Rds, masks, vals_r, vals_c,
                                 W, H, t, sign, eosr, eosi)
        fn = jax.shard_map(local, mesh=mesh, in_specs=upd_in,
                           out_specs=upd_out, check_vma=False)
        return jax.jit(fn, donate_argnums=(2, 4, 5))

    addback = _wrap_update(1.0)
    subtract = _wrap_update(-1.0)
    sweeps = jax.jit(
        jax.shard_map(_sweeps_local, mesh=mesh, in_specs=sw_in,
                      out_specs=sw_out, check_vma=False),
        donate_argnums=(6, 7))
    return addback, sweeps, subtract


def ccd_hybrid_train_sharded(R: RatingMatrix, W0: np.ndarray, H0: np.ndarray,
                             T: TestCOO, cfg: Config, mesh: Mesh, *,
                             callback: Optional[Callable] = None,
                             ckpt_every: int = 0, ckpt_fn=None, resume=None,
                             ) -> tuple[np.ndarray, np.ndarray,
                                        list[IterStats]]:
    """Multi-device panel-hybrid CCD++. Factors/stats in the reference's
    rank-major ORIGINAL entity order; numerically equivalent to the
    single-device hybrid backend."""
    N = mesh.devices.size
    plan = plan_hybrid(R, cfg, num_shards=N, materialize_dense=False)
    rows_g, cols_g = plan.ell.rows_side, plan.ell.cols_side
    rdt = jnp.dtype(cfg.residual_dtype)
    k = W0.shape[0]
    m, n = R.rows, R.cols

    shard = NamedSharding(mesh, P(AXIS, None))
    svec = NamedSharding(mesh, P(AXIS))
    rep = NamedSharding(mesh, P())

    idx_r = tuple(jax.device_put(b.idx, shard) for b in rows_g.buckets)
    idx_c = tuple(jax.device_put(b.idx, shard) for b in cols_g.buckets)
    dense_Rds, masks = densify_panels(plan, rdt, sharding=shard,
                                      mask_dtype=cfg.mask_dtype)

    W0 = np.asarray(W0, np.float32)
    start_oiter = 1
    if resume is not None:
        start_oiter = int(resume["oiter"]) + 1
        Rds = tuple(jax.device_put(np.asarray(resume[f"Rd_{i}"]).astype(rdt),
                                   shard) for i in range(len(plan.panels)))
        W = jax.device_put(resume["W"], rep)
        H = jax.device_put(resume["H"], rep)
        u_pend = jax.device_put(resume["u_pend"], rep)
        v_pend = jax.device_put(resume["v_pend"], rep)
        vals_r = tuple(jax.device_put(resume[f"vals_r_{i}"], shard)
                       for i in range(len(rows_g.buckets)))
        vals_c = tuple(jax.device_put(resume[f"vals_c_{i}"], shard)
                       for i in range(len(cols_g.buckets)))
    else:
        Rds = dense_Rds
        W = jax.device_put(W0[:, plan.user_order], rep)
        H = jax.device_put(np.zeros((k, n), np.float32), rep)
        u_pend = jax.device_put(np.zeros(m, np.float32), rep)
        v_pend = jax.device_put(np.zeros(n, np.float32), rep)
        vals_r = tuple(jax.device_put(b.val, shard) for b in rows_g.buckets)
        vals_c = tuple(jax.device_put(b.val, shard) for b in cols_g.buckets)

    row_nnz = jax.device_put(plan.row_nnz, rep)
    col_nnz = jax.device_put(plan.col_nnz, rep)
    eosr = jax.device_put(plan.upos_of_slot_safe, svec)
    eosi = jax.device_put(plan.ipos_of_slot_safe, svec)

    def local_map(slot_of_pos, slots_per_shard, n_ent):
        # (N, n_ent): device row d holds "local slot of entity e if device d
        # owns it, else the local sentinel (slots_per_shard)"
        out = np.full((N, n_ent), slots_per_shard, np.int32)
        owner = slot_of_pos // slots_per_shard
        local = slot_of_pos % slots_per_shard
        out[owner, np.arange(n_ent)] = local
        return out

    lsu = jax.device_put(local_map(plan.slot_of_upos.astype(np.int64),
                                   rows_g.slots_per_shard, m), shard)
    lsi = jax.device_put(local_map(plan.slot_of_ipos.astype(np.int64),
                                   cols_g.slots_per_shard, n), shard)

    ti = jax.device_put(plan.user_pos[T.row_idx], rep)
    tj = jax.device_put(plan.item_pos[T.col_idx], rep)
    tv = jax.device_put(np.asarray(T.val), rep)

    step_fn = make_sharded_hybrid_step(plan, mesh, cfg.lambda_,
                                       cfg.maxinneriter, residual_dtype=rdt,
                                       nan_mask=cfg.mask_dtype == "nan",
                                       panel_kernel=cfg.hybrid_panel_kernel,
                                       nmf=cfg.do_nmf)
    rmse_fn = jax.jit(functools.partial(
        calrmse_device, entity_major=False,
        chunk=default_eval_chunk(T.nnz, cfg.eval_chunk)))

    box = {"s": (Rds, vals_r, vals_c, W, H, u_pend, v_pend)}

    def do_step():
        Rds, vals_r, vals_c, W, H, up, vp = box["s"]
        box["s"] = step_fn(idx_r, idx_c, Rds, masks, vals_r, vals_c, W, H,
                           up, vp, row_nnz, col_nnz, lsu, lsi, eosr, eosi)
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
    W_ent = np.asarray(W)[:, plan.user_pos]
    H_ent = np.asarray(H)[:, plan.item_pos]
    return W_ent, H_ent, stats
