"""Device primitives over the degree-bucketed padded-ELL layout (data/ell.py).

These replace the reference's CSC-segment walks
(/root/reference/src/CCD.cpp:6-43, cuda_src/CCD_CUDA.cu:3-58): every operation
is a fixed-shape gather / elementwise / lane-reduction over (rows, L) bucket
tiles, with padding neutralized by the zero-slot trick (padded idx entries
point one past the other side's slot table, where an appended 0 lives) — no
masks, no scatters, no dynamic shapes.

Bucket lane geometry: a bucket stores ``p`` slots per physical row, each in a
contiguous E-lane span, L = p*E (ell.py). ``lanes_to_slots`` reduces a
(rows, L) tile to per-slot sums; ``slots_to_lanes`` broadcasts per-slot values
back across their lanes.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..data.ell import EllBucket, EllSide


def extend_zero(table: jnp.ndarray) -> jnp.ndarray:
    """Append the zero slot (index n_slots) along axis 0."""
    if table.ndim == 1:
        return jnp.concatenate([table, jnp.zeros((1,), table.dtype)])
    return jnp.concatenate(
        [table, jnp.zeros((1,) + table.shape[1:], table.dtype)], axis=0)


def lanes_to_slots(lanes: jnp.ndarray, b: EllBucket) -> jnp.ndarray:
    """(rows, L) -> per-slot sums (rows*p,), slot-ordered."""
    rows = lanes.shape[0]
    return lanes.reshape(rows * b.p, b.E).sum(axis=1)


def slots_to_lanes(slot_vals: jnp.ndarray, b: EllBucket) -> jnp.ndarray:
    """Per-slot values (rows*p,) -> (rows, L) with each slot's value broadcast
    across its E lanes."""
    rows = slot_vals.shape[0] // b.p
    return jnp.broadcast_to(
        slot_vals.reshape(rows, b.p, 1), (rows, b.p, b.E)).reshape(rows, b.p * b.E)


def bucket_slot_ranges(side: EllSide) -> list[tuple[int, int]]:
    """Global slot [start, stop) of each bucket (single-shard layout, where
    bucket slots are contiguous; the sharded path slices per-shard instead)."""
    assert side.num_shards == 1, "global contiguous ranges need num_shards=1"
    out = []
    for off, b in zip(side.bucket_offsets, side.buckets):
        out.append((off, off + b.slots_per_shard))
    return out


def sweep_new_values(idx_tiles, val_tiles, side: EllSide, other_ext: jnp.ndarray,
                     lam: jnp.ndarray, slot_nnz: jnp.ndarray,
                     gathered=None,
                     nmf: bool = False) -> tuple[jnp.ndarray, list[jnp.ndarray]]:
    """One CCD half-sweep over a side: for every slot j,
    new_j = g_j / (lam*nnz_j + h_j), g = Σ other[idx]*val, h = Σ other[idx]²
    (RankOneUpdate, src/CCD.cpp:6-16; λ nnz-scaled by the caller passing
    lam*slot_nnz implicitly via slot_nnz here). Empty slot -> 0 (src/CCD.cpp:8).
    ``nmf`` clamps updates at 0 (libpmf -N semantics; dead flag in the
    reference, src/pmf.h:33).

    Returns (new_slot_values (n_slots,), per-bucket gathered other tiles for
    reuse by a following residual update with the same vector).
    """
    outs = []
    gathers = []
    for i, b in enumerate(side.buckets):
        og = other_ext[idx_tiles[i]] if gathered is None else gathered[i]
        gathers.append(og)
        g = lanes_to_slots(og * val_tiles[i], b)
        h = lanes_to_slots(og * og, b)
        outs.append(g / (lam * _bslice(slot_nnz, side, i) + h))
    tail = side.n_slots - (side.bucket_offsets[-1] + side.buckets[-1].slots_per_shard
                           if side.buckets else 0)
    if not side.buckets:
        return jnp.zeros(side.n_slots, jnp.float32), gathers
    new_vals = jnp.concatenate(outs + ([jnp.zeros(tail, outs[0].dtype)] if tail else []))
    new_vals = jnp.where(slot_nnz > 0, new_vals, 0.0)
    return (jnp.maximum(new_vals, 0.0) if nmf else new_vals), gathers


def _row_gather_tiles(table_ext: jnp.ndarray, ix: jnp.ndarray) -> tuple:
    """Chunked ROW-mode gather of a T-wide table (S+1, T) at one (rows, L)
    index tile; returns T (rows, L) arrays.

    One gather of an (S, T) table fetches all T values of a row at once,
    so several vectors gathered at the same index share one pass; chunking
    the rows under lax.map bounds the gathered (chunk, L, T) temp to one
    chunk. Padding chunks index the table's last row — the appended zero
    row (extend_zero), so they gather exact zeros.
    """
    zero_row = table_ext.shape[0] - 1
    T = int(table_ext.shape[1])
    rows, L = ix.shape
    chunk = max(8, (1 << 19) // max(1, L))       # padded temp ~256 MB cap
    pad = (-rows) % chunk
    ixp = (jnp.concatenate(
        [ix, jnp.full((pad, L), zero_row, ix.dtype)]) if pad else ix)

    def body(ic):
        g = table_ext[ic]                        # (chunk, L, T) bounded temp
        return tuple(g[..., j] for j in range(T))

    outs = jax.lax.map(body, ixp.reshape(-1, chunk, L))
    return tuple(o.reshape(-1, L)[:rows] for o in outs)


def paired_gather(pair_ext: jnp.ndarray, idx_tiles) -> list:
    """Gather a 2-wide table (S+1, 2) at bucket index tiles in ROW-gather
    mode with bounded padded temps (_row_gather_tiles). Returns per-bucket
    (first, second) (rows, L) arrays.

    NOTE: feeding a returned tile to MORE THAN ONE consumer op makes XLA
    re-run the chunked gather map per consumer. When the same gather must
    serve residual updates AND a sweep, use fused_update_sweep instead.
    """
    return [_row_gather_tiles(pair_ext, ix)[:2] for ix in idx_tiles]


def stacked_remap(vectors, idx: jnp.ndarray) -> list:
    """Gather J >= 2 equal-length vectors at one shared flat int index in a
    single ROW-mode pass: the vectors are stacked (S, J), extended by a zero
    row (sentinel index S), and the flat index is tiled through the chunked
    row gather. Returns J (idx.size,) arrays.

    Replaces one 1-wide gather per vector (the slot<->entity remaps of the
    hybrid tail) with one shared pass."""
    tab = extend_zero(jnp.stack(list(vectors), axis=-1))
    sent = tab.shape[0] - 1
    n = idx.shape[0]
    L = min(1024, max(128, n))
    pad = (-n) % L
    ixp = (jnp.concatenate([idx, jnp.full((pad,), sent, idx.dtype)])
           if pad else idx)
    outs = _row_gather_tiles(tab, ixp.reshape(-1, L))
    return [o.reshape(-1)[:n] for o in outs]


def fused_update_sweep(idx_tiles, val_tiles, side: EllSide,
                       table_ext: jnp.ndarray, owns, signs,
                       sweep_col: int):
    """ONE chunked gather pass per bucket serving the residual update(s) AND
    the sweep partials — the single-consumer fix for XLA's
    rematerialization of a gathered tile fed to >1 consumer op (it re-runs
    the whole chunked gather per consumer).

    Inside each lax.map chunk the T-wide gathered tile ``g`` is consumed by
    exactly one chain:

        val += Σ_j signs[j] · g[..., j] · own_j        (UpdateRating,
                                                        src/CCD.cpp:18-43)
        g_s  = Σ_lanes g[..., sweep_col] · val_new     (RankOneUpdate
        h_s  = Σ_lanes g[..., sweep_col]²               numer/denom partials,
                                                        src/CCD.cpp:6-16)

    ``owns``: per-update (n_slots,) slot vectors (entity vectors remapped by
    the caller, e.g. with stacked_remap); ``signs``: matching floats; update
    j consumes table column j; the sweep consumes the UPDATED values.
    Returns (new_val_tiles, g_slots, h_slots) with zero tails for non-bucket
    slots (like sweep_partials)."""
    if not side.buckets:
        z = jnp.zeros(side.n_slots, jnp.float32)
        return tuple(val_tiles), z, z
    zero_row = table_ext.shape[0] - 1
    sgn = [jnp.float32(s) for s in signs]
    new_vals, gs, hs = [], [], []
    for i, b in enumerate(side.buckets):
        ix, val = idx_tiles[i], val_tiles[i]
        rows, L = ix.shape
        p, E = b.p, b.E
        chunk = max(8, (1 << 19) // max(1, L))
        pad = (-rows) % chunk
        if pad:
            ix = jnp.concatenate([ix, jnp.full((pad, L), zero_row, ix.dtype)])
            val = jnp.concatenate([val, jnp.zeros((pad, L), val.dtype)])
        own_t = tuple(
            jnp.pad(_bslice(o, side, i), (0, pad * p)).reshape(-1, chunk, p)
            for o in owns)

        def body(args, p=p, E=E, L=L):
            ic, vc, ocs = args
            g = table_ext[ic]                    # (chunk, L, T) — ONE temp,
            for j, (s, oc) in enumerate(zip(sgn, ocs)):  # one consumer chain
                ob = jnp.broadcast_to(oc[:, :, None],
                                      oc.shape + (E,)).reshape(-1, L)
                vc = vc + s * g[..., j] * ob
            sw = g[..., sweep_col]
            gsc = (sw * vc).reshape(-1, p, E).sum(axis=-1)
            hsc = (sw * sw).reshape(-1, p, E).sum(axis=-1)
            return vc, gsc, hsc

        nv, gb, hb = jax.lax.map(
            body, (ix.reshape(-1, chunk, L), val.reshape(-1, chunk, L),
                   own_t))
        new_vals.append(nv.reshape(-1, L)[:rows])
        gs.append(gb.reshape(-1)[:rows * p])
        hs.append(hb.reshape(-1)[:rows * p])
    tail = side.n_slots - (side.bucket_offsets[-1]
                           + side.buckets[-1].slots_per_shard)
    ztail = [jnp.zeros(tail, jnp.float32)] if tail else []
    return (tuple(new_vals), jnp.concatenate(gs + ztail),
            jnp.concatenate(hs + ztail))


def fused_sweep(idx_tiles, val_tiles, side: EllSide, table_ext: jnp.ndarray,
                sweep_col: int = 0) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Sweep partials with the gather fused into the map body (no residual
    update): g = Σ g_tile·val, h = Σ g_tile² per slot, the gathered tile
    consumed inside its own chunk. Used by inner iterations (i > 0), which
    re-sweep without touching the residual. Returns (g_slots, h_slots)."""
    if not side.buckets:
        z = jnp.zeros(side.n_slots, jnp.float32)
        return z, z
    zero_row = table_ext.shape[0] - 1
    gs, hs = [], []
    for i, b in enumerate(side.buckets):
        ix, val = idx_tiles[i], val_tiles[i]
        rows, L = ix.shape
        p, E = b.p, b.E
        chunk = max(8, (1 << 19) // max(1, L))
        pad = (-rows) % chunk
        if pad:
            ix = jnp.concatenate([ix, jnp.full((pad, L), zero_row, ix.dtype)])
            val = jnp.concatenate([val, jnp.zeros((pad, L), val.dtype)])

        def body(args, p=p, E=E):
            ic, vc = args
            sw = table_ext[ic][..., sweep_col]
            gsc = (sw * vc).reshape(-1, p, E).sum(axis=-1)
            hsc = (sw * sw).reshape(-1, p, E).sum(axis=-1)
            return gsc, hsc

        gb, hb = jax.lax.map(
            body, (ix.reshape(-1, chunk, L), val.reshape(-1, chunk, L)))
        gs.append(gb.reshape(-1)[:rows * p])
        hs.append(hb.reshape(-1)[:rows * p])
    tail = side.n_slots - (side.bucket_offsets[-1]
                           + side.buckets[-1].slots_per_shard)
    ztail = [jnp.zeros(tail, jnp.float32)] if tail else []
    return jnp.concatenate(gs + ztail), jnp.concatenate(hs + ztail)


def deferred_sweep(idx_tiles, val_tiles, side: EllSide,
                   table_ext: jnp.ndarray):
    """Wide gather-reduce sweep against a FROZEN residual plus deferred
    rank-1 corrections (the opt-in hybrid_defer_group experiment, not the
    default).

    So the residual update is DEFERRED: ``table_ext`` carries the sweep
    vector in column 0 and the group's deferred rank-1 update vectors in
    columns 1..T-1, and everything the sweep needs reduces in one fusion:

        S_0[slot] = sum_lanes col0 * val        (sweep vs frozen residual)
        S_c[slot] = sum_lanes col0 * col_c      (correction cross-terms)
        h[slot]   = sum_lanes col0^2

    The caller reconstitutes the true partials as
    g = S_0 + sum_c sign_c * own_c * S_c (RankOneUpdate numerator against
    the CURRENT residual, src/CCD.cpp:6-16, with UpdateRating's rank-1
    deltas, src/CCD.cpp:18-43, applied algebraically instead of in
    memory). Returns (S0, [S_1..S_{T-1}], h) as full slot vectors with
    zero tails."""
    T = int(table_ext.shape[1])
    if not side.buckets:
        z = jnp.zeros(side.n_slots, jnp.float32)
        return z, [z] * (T - 1), z
    s0s, scs, hs = [], [[] for _ in range(T - 1)], []
    for i, b in enumerate(side.buckets):
        g = table_ext[idx_tiles[i]]              # (rows, L, T) — consumed
        sw = g[..., 0]                           # by sibling reductions only
        s0s.append(lanes_to_slots(sw * val_tiles[i], b))
        for c in range(1, T):
            scs[c - 1].append(lanes_to_slots(sw * g[..., c], b))
        hs.append(lanes_to_slots(sw * sw, b))
    tail = side.n_slots - (side.bucket_offsets[-1]
                           + side.buckets[-1].slots_per_shard)
    zt = [jnp.zeros(tail, jnp.float32)] if tail else []
    return (jnp.concatenate(s0s + zt),
            [jnp.concatenate(sc + zt) for sc in scs],
            jnp.concatenate(hs + zt))


def deferred_flush(idx_tiles, val_tiles, side: EllSide,
                   table_ext: jnp.ndarray, owns: jnp.ndarray, signs):
    """Apply a group of deferred rank-1 residual updates in ONE pass:
    val += sum_c signs[c] * table[idx][..., c] * owns[c][slot] per lane
    (UpdateRating, src/CCD.cpp:18-43, batched over the group). The (S, 2G)
    gather here DOES materialize padded (2G -> 128 lanes) — that is the
    point: amortized over G ranks its amplification is 128/2G instead of
    the per-rank update's 64x. ``owns``: (2G, n_slots) slot-space own
    vectors; ``signs``: length-2G floats."""
    out = []
    sgn = [jnp.float32(s) for s in signs]
    for i, b in enumerate(side.buckets):
        g = table_ext[idx_tiles[i]]              # (rows, L, 2G) padded
        nv = val_tiles[i]
        for c, s in enumerate(sgn):
            nv = nv + s * g[..., c] * slots_to_lanes(
                _bslice(owns[c], side, i), b)
        out.append(nv)
    return tuple(out)


def fused_remap_combine(S_vecs, h_vec, idx: jnp.ndarray,
                        weights: jnp.ndarray, signs) -> tuple:
    """Slot->entity remap of the deferred-sweep outputs FUSED with the
    correction combination, in one chunked pass:

        g_e[e] = S_0[idx[e]] + sum_c signs[c] * weights[e, c] * S_{c+1}[idx[e]]
        h_e[e] = h[idx[e]]

    Why fused: a wide stacked remap whose 2G+2 output slices feed separate
    consumer fusions re-materializes the gathered tile; consuming it by ONE
    in-body chain keeps it unmaterialized. ``S_vecs``: list of 2G+1 slot vectors
    (S_0 first); ``weights``: (2G, N) entity-indexed deferred own values
    (e.g. V_def.T — lane-minor so the per-chunk weight tiles carry no
    minor-dim padding); ``idx``: (N,) slot ids (sentinel = n_slots reads
    the appended zero row). Returns (g_e (N,), h_e (N,))."""
    tab = extend_zero(jnp.stack(list(S_vecs) + [h_vec], axis=-1))
    T = int(tab.shape[1])
    n2g = len(signs)
    sgn = [jnp.float32(s) for s in signs]
    N = idx.shape[0]
    L = min(1024, max(128, N))
    chunk = max(8, (1 << 19) // L)
    pad = (-N) % (chunk * L)
    sent = tab.shape[0] - 1
    ixp = (jnp.concatenate([idx, jnp.full((pad,), sent, idx.dtype)])
           if pad else idx)
    wp = (jnp.concatenate(
        [weights, jnp.zeros((n2g, pad), weights.dtype)], axis=1)
        if pad else weights)
    nc = ixp.size // (chunk * L)
    wx = jnp.transpose(wp.reshape(n2g, nc, chunk * L), (1, 0, 2))

    def body(args):
        ic, wc = args                  # (chunk, L), (2G, chunk*L)
        gt = tab[ic]                   # (chunk, L, T) — one consumer chain
        ge = gt[..., 0]
        for c in range(n2g):
            ge = ge + sgn[c] * wc[c].reshape(ic.shape) * gt[..., c + 1]
        return ge, gt[..., T - 1]

    ge, he = jax.lax.map(body, (ixp.reshape(nc, chunk, L), wx))
    return ge.reshape(-1)[:N], he.reshape(-1)[:N]


def sweep_partials(idx_tiles, val_tiles, side: EllSide, other_ext,
                   gathered=None) -> tuple[jnp.ndarray, jnp.ndarray, list]:
    """Per-slot sweep partial sums WITHOUT the division: g = Σ other[idx]*val,
    h = Σ other[idx]² as full slot vectors (zero tail for non-bucket slots).

    Used by the hybrid backend (solvers/ccd_hybrid.py), which combines these
    with the dense sub-block's matvec partials before forming
    new_j = (g_ell + g_dense) / (λ·nnz_total + h_ell + h_dense) — the same
    RankOneUpdate math (src/CCD.cpp:6-16) with the Ω_j sum split by part.
    Returns (g, h, per-bucket gathered tiles for reuse)."""
    if not side.buckets:
        z = jnp.zeros(side.n_slots, jnp.float32)
        return z, z, []
    gs, hs, gathers = [], [], []
    for i, b in enumerate(side.buckets):
        og = other_ext[idx_tiles[i]] if gathered is None else gathered[i]
        gathers.append(og)
        gs.append(lanes_to_slots(og * val_tiles[i], b))
        hs.append(lanes_to_slots(og * og, b))
    tail = side.n_slots - (side.bucket_offsets[-1]
                           + side.buckets[-1].slots_per_shard)
    ztail = [jnp.zeros(tail, jnp.float32)] if tail else []
    return (jnp.concatenate(gs + ztail), jnp.concatenate(hs + ztail), gathers)


def residual_update(idx_tiles, val_tiles, side: EllSide, other_ext: jnp.ndarray,
                    own_slots: jnp.ndarray, sign: float,
                    gathered=None) -> tuple[jnp.ndarray, ...]:
    """Residual maintenance (UpdateRating, src/CCD.cpp:18-43):
    val[j, e] += sign * other[idx[j, e]] * own[j], per bucket tile. Padded
    lanes gather 0 so they stay exactly 0. Reuses ``gathered`` tiles when the
    caller just gathered the same vector (sweep-then-subtract fusion)."""
    out = []
    s = jnp.float32(sign)
    for i, b in enumerate(side.buckets):
        og = other_ext[idx_tiles[i]] if gathered is None else gathered[i]
        ob = slots_to_lanes(_bslice(own_slots, side, i), b)
        out.append(val_tiles[i] + s * og * ob)
    return tuple(out)


def _bslice(slot_vec: jnp.ndarray, side: EllSide, i: int) -> jnp.ndarray:
    """Slice a per-slot vector down to bucket i's slots (single-shard layout)."""
    off = side.bucket_offsets[i]
    return slot_vec[off:off + side.buckets[i].slots_per_shard]
