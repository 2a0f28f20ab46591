"""Degree-bucketed, lane-packed padded-ELL layout (the sparse format).

This replaces the reference's pointer-chased CSR/CSC walks
(/root/reference/src/CCD.cpp:9-13, cuda_src/CCD_CUDA.cu:14-18) with a fixed-shape
layout that compiles to static-shape gathers and reductions:

* **Degree buckets**: entities (rows or columns) are grouped by padded width.
  Widths are chosen from the degree distribution itself by a small DP
  (_choose_widths) minimizing total padded slots — 1.44x -> ~1.06x padding
  at the Netflix-100M hybrid tail vs the power-of-two ladder — and the
  per-slot gather/gram cost is exactly the width.
* **Lane packing**: a bucket of width E < 128 packs ``p = 128//E`` entities per
  physical row of L = p*E lanes, so rows stay 128 wide however narrow the
  bucket (ROADMAP: whether the GPU rewards this is open).
* **Slot-space permutation**: entities are renamed to "slots" (bucket-major,
  contiguous). Factors live in slot space during training, so per-bucket results
  concatenate — the hot loops contain zero scatters.
* **Zero-slot trick**: index padding points at a dedicated trailing slot of the
  *other* side whose gathered value is always 0 (tables are extended by one zero
  element at gather time), so no mask arrays are ever read: padded entries
  contribute exactly 0 to numerators, denominators, grams, and residual updates.
* **Shard-uniform layout**: with ``num_shards = N``, every bucket (and the empty
  tail) is dealt round-robin across shards and padded so all shards have identical
  shapes; global slot order is shard-major, so a device's slots are one contiguous
  block and ``all_gather`` reassembles the global table as a plain concat.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from .sparse import RatingMatrix

LANE = 128


MAX_BUCKETS = 8    # default width-ladder size (see _choose_widths). The
                   # tradeoff at the Netflix-100M hybrid tail: padding 1.44x
                   # (pow2, 4-5 buckets) -> 1.05/1.10x at B=8 -> 1.03/1.07x at
                   # B=12; each bucket adds a gather + reduce op per sweep to
                   # the traced program (compile time grows with op count).


def _choose_widths(deg_eff: np.ndarray, max_buckets: int) -> np.ndarray:
    """Pick <= max_buckets bucket widths minimizing total padded slots.

    The gather/gram cost of a slot is exactly its bucket width E (lane
    packing makes the 128-lane row shared, so there is no per-row floor —
    ops/ell_ops.lanes_to_slots), so total tail cost is sum over entities of
    width(entity). Power-of-two widths bound that at 2x; measured at the
    Netflix-100M hybrid tail they cost 1.44x the true nnz. Widths need NOT
    be powers of two (any E >= 1 works with p = max(1, 128 // E) slots per
    row and L = p*E lanes), so choose them from the data: candidates are
    the (subsampled) unique effective degrees, and a small exact DP picks
    the <= max_buckets subset minimizing sum(count_i * next_width(u_i)) —
    measured 1.44x -> ~1.06x at the same bucket count.

    ``deg_eff`` is the per-entity degree already floored at min_width;
    returns the chosen widths, ascending (last = max degree).
    """
    u, cnt = np.unique(deg_eff, return_counts=True)
    if u.size <= max_buckets:
        return u
    # subsample candidates (always keeping the max); 512 is plenty fine-
    # grained for the DP to land within a fraction of a percent of optimal
    cap = 512
    if u.size > cap:
        pick = np.unique(np.linspace(0, u.size - 1, cap).round().astype(int))
        # entities between kept candidates must round UP: fold each unique
        # degree onto the next kept candidate
        kept = u[pick]
        cnt = np.bincount(np.searchsorted(kept, u), weights=cnt,
                          minlength=kept.size)
        u = kept
    C = u.size
    w = u.astype(np.float64)
    cw = np.concatenate([[0.0], np.cumsum(cnt)])      # cw[j] = count of u[:j]
    # f[b][j]: min cost covering u[0..j] with b chosen widths, u[j] chosen
    f = np.full((max_buckets + 1, C), np.inf)
    f[1] = w * cw[1:]                                  # one width = u[j] covers all up to j
    for b in range(2, max_buckets + 1):
        prev = f[b - 1]
        # f[b][j] = min_i<j prev[i] + w[j] * (cw[j+1] - cw[i+1])
        for j in range(b - 1, C):
            cand = prev[:j] - w[j] * cw[1:j + 1]
            f[b][j] = cand.min() + w[j] * cw[j + 1]
    # backtrack from the cheapest b at j = C-1 (max degree must be chosen)
    best_b = int(np.argmin(f[1:, C - 1])) + 1
    widths = [int(u[C - 1])]
    j, b = C - 1, best_b
    while b > 1:
        cand = f[b - 1][:j] - w[j] * cw[1:j + 1]
        i = int(np.argmin(cand))
        widths.append(int(u[i]))
        j, b = i, b - 1
    return np.asarray(sorted(widths), dtype=np.int64)


@dataclasses.dataclass(frozen=True)
class EllBucket:
    """One degree bucket of one orientation.

    Arrays are shaped (num_shards * rows_per_shard, L) with L = p*E;
    shard ``s`` owns physical rows [s*rows_per_shard, (s+1)*rows_per_shard).
    Physical row r holds ``p`` consecutive slots, slot j in lanes
    [ (j%p)*E, (j%p+1)*E ).
    """

    E: int                 # logical width (any integer >= min_width)
    p: int                 # slots per physical row = max(1, 128 // E)
    rows_per_shard: int
    slots_per_shard: int   # rows_per_shard * p
    idx: np.ndarray        # (rows, L) int32 — other-side slot ids (pad -> zero slot)
    val: np.ndarray        # (rows, L) float32 — ratings (pad -> 0)

    @property
    def L(self) -> int:
        return int(self.idx.shape[1])

    @property
    def rows(self) -> int:
        return int(self.idx.shape[0])


@dataclasses.dataclass(frozen=True)
class EllSide:
    """One orientation (e.g. columns/CSC for the CCD v-sweep)."""

    n_entities: int
    num_shards: int
    slots_per_shard: int          # uniform across shards (buckets + empty tail)
    buckets: tuple[EllBucket, ...]
    # per-shard slot offset of each bucket (same for every shard):
    bucket_offsets: tuple[int, ...]
    slot_of_entity: np.ndarray    # (n_entities,) int32 — global slot id
    entity_of_slot: np.ndarray    # (n_slots,) int32 — -1 for padding slots
    slot_nnz: np.ndarray          # (n_slots,) float32 — true degree per slot
    other_zero_slot: int          # index of the other side's zero slot (= its n_slots)

    @property
    def n_slots(self) -> int:
        return self.num_shards * self.slots_per_shard

    @property
    def nnz_padded(self) -> int:
        return sum(b.idx.size for b in self.buckets)

    def local_view(self) -> "EllSide":
        """Single-shard geometry view describing ONE shard's local block (what
        a shard_map body sees): bucket arrays sliced to shard 0, slot counts
        per-shard. Bucket offsets are already per-shard. Used only for its
        geometry by ops/ell_ops — the actual sharded arrays are passed to the
        kernel separately."""
        bks = tuple(
            EllBucket(E=b.E, p=b.p, rows_per_shard=b.rows_per_shard,
                      slots_per_shard=b.slots_per_shard,
                      idx=b.idx[:b.rows_per_shard],
                      val=b.val[:b.rows_per_shard])
            for b in self.buckets)
        return dataclasses.replace(
            self, num_shards=1, buckets=bks,
            entity_of_slot=self.entity_of_slot[:self.slots_per_shard],
            slot_nnz=self.slot_nnz[:self.slots_per_shard])

    def spread(self, x: np.ndarray, fill: float = 0.0) -> np.ndarray:
        """Map per-entity values (n_entities,) into slot space (n_slots,)."""
        out = np.full(self.n_slots, fill, dtype=np.asarray(x).dtype)
        out[self.slot_of_entity] = x
        return out

    def collect(self, x_slots: np.ndarray) -> np.ndarray:
        """Map slot-space values back to entity order."""
        return np.asarray(x_slots)[self.slot_of_entity]


@dataclasses.dataclass(frozen=True)
class EllPair:
    """Both orientations of one rating matrix, mutually slot-indexed."""

    rows_side: EllSide   # slots = row entities; idx references col slots (CSR order)
    cols_side: EllSide   # slots = col entities; idx references row slots (CSC order)
    n_rows: int
    n_cols: int
    nnz: int


#: auto bucket-floor padding tolerance: the floor is the LARGEST ladder
#: width whose padded-lane total stays within this factor of the true nnz.
#: 1.3 keeps floor 128 at ml20M (it pads 1.12x there) while rejecting it at
#: yahoo-r1 dims (avg user degree 59, floor 128 pads 4.5x).
AUTO_FLOOR_TAU = 1.3


def auto_min_width(degrees: np.ndarray, tau: float = AUTO_FLOOR_TAU) -> int:
    """Degree-adaptive bucket floor: the largest width in {128, 64, 32, 16,
    8} such that flooring every nonempty entity's degree at it costs <= tau
    x the true nnz in padded lanes. Wide buckets help the ALS gram einsums
    (narrow lane-packed buckets still pay per-bucket op overhead); the cost
    of the floor is exactly the padded lanes, so choose from the degree
    distribution."""
    deg = np.asarray(degrees, dtype=np.int64)
    deg = deg[deg > 0]
    if deg.size == 0:
        return 8
    s = float(deg.sum())
    for w in (128, 64, 32, 16):
        if float(np.maximum(deg, w).sum()) <= tau * s:
            return w
    return 8


def _resolve_min_width(min_width, degrees: np.ndarray) -> int:
    if min_width == "auto":
        return auto_min_width(degrees)
    return int(min_width)


def _plan_buckets(degrees: np.ndarray, min_width: int,
                  max_buckets: int = MAX_BUCKETS):
    """Group entity ids into <= max_buckets degree buckets whose widths are
    chosen by _choose_widths (data-driven, min-padding). Returns list of
    (E, entity_ids sorted by degree desc), widest first, plus empty ids."""
    deg = np.asarray(degrees, dtype=np.int64)
    nonempty = np.where(deg > 0)[0]
    empty = np.where(deg == 0)[0]
    deg_eff = np.maximum(deg[nonempty], min_width)
    if deg_eff.size == 0:
        return [], empty
    ladder = _choose_widths(deg_eff, max_buckets)
    widths = ladder[np.searchsorted(ladder, deg_eff)]
    plan = []
    for E in sorted(set(widths.tolist()), reverse=True):
        ids = nonempty[widths == E]
        ids = ids[np.argsort(-deg[ids], kind="stable")]
        plan.append((int(E), ids))
    return plan, empty


def _build_side(ptr: np.ndarray, n_entities: int, *, min_width: int,
                num_shards: int,
                alloc: bool = True) -> tuple[EllSide, list[list[np.ndarray]]]:
    """First pass: slot assignment + bucket geometry. Returns the side with
    placeholder idx/val plus, per bucket, the per-slot raw entity ids (for the
    fill pass). ``alloc=False`` skips the (rows, L) bucket allocations —
    geometry only, from the tiny ptr array alone; used by the host-local
    shard loader (data/shard_loader.py) where no process may hold full
    nnz-scale arrays.

    ``min_width`` may be the string "auto": the floor is then chosen from
    THIS side's degree distribution (auto_min_width) — each orientation
    gets its own floor (yahoo-r1's 1.9M avg-degree-59 users want 16-32
    while its 98k avg-degree-1171 items are indifferent). Deterministic
    from the ptr array alone, so plan_ell_pair/shard-loader geometry and
    build_ell_pair resolve identically."""
    deg = np.diff(ptr).astype(np.int64)
    min_width = _resolve_min_width(min_width, deg)
    plan, empty = _plan_buckets(deg, min_width)

    buckets_meta = []   # (E, p, rows_per_shard, per-shard entity grid (num_shards, slots_ps))
    for E, ids in plan:
        p = max(1, LANE // E)
        # deal round-robin: shard s gets ids[s::num_shards] (degree-balanced)
        per_shard = [ids[s::num_shards] for s in range(num_shards)]
        slots_ps = max(len(x) for x in per_shard)
        slots_ps = p * math.ceil(slots_ps / p)            # pad to whole rows
        grid = np.full((num_shards, slots_ps), -1, dtype=np.int64)
        for s, x in enumerate(per_shard):
            grid[s, : len(x)] = x
        buckets_meta.append((E, p, slots_ps // p, grid))

    # empty tail: entities with no ratings still need slots (factor rows)
    empty_per_shard = [empty[s::num_shards] for s in range(num_shards)]
    empty_ps = max((len(x) for x in empty_per_shard), default=0)
    empty_grid = np.full((num_shards, empty_ps), -1, dtype=np.int64)
    for s, x in enumerate(empty_per_shard):
        empty_grid[s, : len(x)] = x

    slots_per_shard = sum(m[2] * m[1] for m in buckets_meta) + empty_ps
    n_slots = num_shards * slots_per_shard

    slot_of_entity = np.full(n_entities, -1, dtype=np.int32)
    entity_of_slot = np.full(n_slots, -1, dtype=np.int32)
    slot_nnz = np.zeros(n_slots, dtype=np.float32)

    bucket_offsets = []
    off = 0
    for E, p, rows_ps, grid in buckets_meta:
        bucket_offsets.append(off)
        slots_ps = rows_ps * p
        for s in range(num_shards):
            base = s * slots_per_shard + off
            ids = grid[s]
            valid = ids >= 0
            gslots = base + np.arange(slots_ps)
            entity_of_slot[gslots[valid]] = ids[valid]
            slot_of_entity[ids[valid]] = gslots[valid].astype(np.int32)
            slot_nnz[gslots[valid]] = deg[ids[valid]]
        off += slots_ps
    # empty tail
    for s in range(num_shards):
        base = s * slots_per_shard + off
        ids = empty_grid[s]
        valid = ids >= 0
        gslots = base + np.arange(empty_ps)
        if empty_ps:
            entity_of_slot[gslots[valid]] = ids[valid]
            slot_of_entity[ids[valid]] = gslots[valid].astype(np.int32)

    buckets = []
    fill_grids = []
    for (E, p, rows_ps, grid), boff in zip(buckets_meta, bucket_offsets):
        L = p * E          # <= LANE when E < LANE; XLA pads storage lanes only
        rows = num_shards * rows_ps
        shape = (rows, L) if alloc else (0, L)
        buckets.append(EllBucket(
            E=E, p=p, rows_per_shard=rows_ps, slots_per_shard=rows_ps * p,
            idx=np.zeros(shape, dtype=np.int32),
            val=np.zeros(shape, dtype=np.float32),
        ))
        fill_grids.append(grid)

    side = EllSide(
        n_entities=n_entities, num_shards=num_shards,
        slots_per_shard=slots_per_shard, buckets=tuple(buckets),
        bucket_offsets=tuple(bucket_offsets),
        slot_of_entity=slot_of_entity, entity_of_slot=entity_of_slot,
        slot_nnz=slot_nnz, other_zero_slot=-1,  # patched in build_ell_pair
    )
    return side, fill_grids


def _fill_side(side: EllSide, fill_grids, ptr, nbr_idx, nbr_val,
               other_slot_of_entity: np.ndarray, other_zero_slot: int) -> EllSide:
    """Second pass: write idx (other-side slot ids) and val into bucket arrays.
    Uses the native C++ fill (cuda_recommender_tpu/native) when available —
    the Python per-entity loop is minutes at Netflix-100M scale."""
    native_fill = None
    try:
        from ..native import ellfill as _ellfill
        from ..native import available as _native_ok
        if _native_ok():
            native_fill = _ellfill.fill_bucket
    except Exception:
        native_fill = None

    ptr = np.ascontiguousarray(ptr, dtype=np.int64)
    nbr_idx = np.ascontiguousarray(nbr_idx, dtype=np.int32)
    nbr_val = np.ascontiguousarray(nbr_val, dtype=np.float32)
    other_slot_of_entity = np.ascontiguousarray(other_slot_of_entity,
                                                dtype=np.int32)
    if native_fill is not None:
        for b, grid in zip(side.buckets, fill_grids):
            native_fill(ptr, nbr_idx, nbr_val, other_slot_of_entity,
                        np.ascontiguousarray(grid, dtype=np.int64),
                        b.E, b.p, b.rows_per_shard, b.L, other_zero_slot,
                        b.idx, b.val)
        return dataclasses.replace(side, other_zero_slot=other_zero_slot)

    for b, grid in zip(side.buckets, fill_grids):
        b.idx.fill(other_zero_slot)
        b.val.fill(0.0)
        E, p = b.E, b.p
        num_shards = side.num_shards
        for s in range(num_shards):
            ids = grid[s]
            for j, e in enumerate(ids):
                if e < 0:
                    continue
                lo, hi = int(ptr[e]), int(ptr[e + 1])
                d = hi - lo
                r = s * b.rows_per_shard + j // p
                c0 = (j % p) * E
                b.idx[r, c0:c0 + d] = other_slot_of_entity[nbr_idx[lo:hi]]
                b.val[r, c0:c0 + d] = nbr_val[lo:hi]
    return dataclasses.replace(side, other_zero_slot=other_zero_slot)


def plan_ell_pair(csr_ptr: np.ndarray, csc_ptr: np.ndarray, n_rows: int,
                  n_cols: int, *, min_width: int = 8, num_shards: int = 1
                  ) -> tuple[EllSide, EllSide, list, list]:
    """Geometry-only layout of both orientations from the ptr arrays alone
    (degrees are all the bucketing needs). Bucket idx/val are (0, L)
    placeholders — no nnz-scale allocation happens. Returns
    (rows_side, cols_side, rows_fill_grids, cols_fill_grids); the fill grids
    map each (shard, slot) to its raw entity id so a host-local loader
    (data/shard_loader.py) can range-read and fill ONLY its shards' rows.

    Every process derives the identical deterministic layout, mirroring how
    the reference's offline converter fixes the layout once
    (/root/reference/src/tools.cpp:3-85) and every run just reads it."""
    rows_side, rows_grids = _build_side(csr_ptr, n_rows, min_width=min_width,
                                        num_shards=num_shards, alloc=False)
    cols_side, cols_grids = _build_side(csc_ptr, n_cols, min_width=min_width,
                                        num_shards=num_shards, alloc=False)
    rows_side = dataclasses.replace(rows_side,
                                    other_zero_slot=cols_side.n_slots)
    cols_side = dataclasses.replace(cols_side,
                                    other_zero_slot=rows_side.n_slots)
    return rows_side, cols_side, rows_grids, cols_grids


def build_ell_pair(R: RatingMatrix, *, min_width: int = 8,
                   num_shards: int = 1,
                   index_space: str = "slot") -> EllPair:
    """Build both orientations.

    ``index_space`` selects what the bucket ``idx`` arrays reference:
      * ``"slot"`` (default): the other side's slot ids — gathers read
        slot-space factor tables directly (the pure-ELL solvers' layout).
      * ``"entity"``: the other side's raw entity ids (zero sentinel =
        n_entities) — gathers read entity-order vectors directly. Used by the
        panel-hybrid backend, which keeps factors in (degree-sorted) entity
        order so dense-panel slices stay contiguous.
    """
    rows_side, rows_grids = _build_side(R.csr_ptr, R.rows,
                                        min_width=min_width, num_shards=num_shards)
    cols_side, cols_grids = _build_side(R.csc_ptr, R.cols,
                                        min_width=min_width, num_shards=num_shards)
    if index_space == "entity":
        rmap = np.arange(R.cols, dtype=np.int32)
        cmap = np.arange(R.rows, dtype=np.int32)
        rows_side = _fill_side(rows_side, rows_grids, R.csr_ptr, R.csr_idx,
                               R.csr_val, rmap, R.cols)
        cols_side = _fill_side(cols_side, cols_grids, R.csc_ptr, R.csc_idx,
                               R.csc_val, cmap, R.rows)
    elif index_space == "slot":
        rows_side = _fill_side(rows_side, rows_grids, R.csr_ptr, R.csr_idx,
                               R.csr_val, cols_side.slot_of_entity,
                               cols_side.n_slots)
        cols_side = _fill_side(cols_side, cols_grids, R.csc_ptr, R.csc_idx,
                               R.csc_val, rows_side.slot_of_entity,
                               rows_side.n_slots)
    else:
        raise ValueError(f"index_space must be 'slot' or 'entity', "
                         f"got {index_space!r}")
    return EllPair(rows_side=rows_side, cols_side=cols_side,
                   n_rows=R.rows, n_cols=R.cols, nnz=R.nnz)
