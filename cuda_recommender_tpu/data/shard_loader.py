"""Host-local shard loading for multi-host training.

The reference's binary dataset format (meta_modified_all,
/root/reference/src/tools.cpp:3-85) is trivially range-readable: the CSR/CSC
ptr arrays are tiny ((m+1) + (n+1) int32), and each entity's neighbor
idx/val live at byte offsets ptr[e]*4 .. ptr[e+1]*4 of the payload files.
A multi-host process therefore:

1. reads BOTH ptr arrays (tiny),
2. derives the full deterministic ELL layout from the degrees alone
   (data/ell.plan_ell_pair — every process computes the identical layout,
   like every run of the reference reading the same converted files),
3. range-reads ONLY the idx/val bytes of the entities its mesh shards own
   (coalescing adjacent entity ranges into single reads), and
4. fills ONLY its shards' bucket rows, handing the blocks to
   parallel.multihost.assemble_global.

No process ever materializes a full nnz-scale array — ``RangeReader``
tracks ``nnz_read`` so tests can assert it. Contiguous CSR row-range reads
(``read_csr_row_range``) serve the hybrid backend's panel blocks the same
way: a panel is rows [r0, r1) of the degree-sorted matrix, i.e. a set of
original rows each fetched by range.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from .ell import EllSide, plan_ell_pair


@dataclasses.dataclass(frozen=True)
class DatasetHeader:
    """Parsed meta_modified_all manifest (src/tools.cpp:3-30)."""

    m: int
    n: int
    nnz: int
    train_names: tuple[str, ...]   # 9 filenames, COO + CSR + CSC
    nnz_test: int
    test_names: tuple[str, ...]    # 3 filenames


def load_header(dirname: str) -> DatasetHeader:
    with open(os.path.join(dirname, "meta_modified_all")) as f:
        tokens = f.read().split()
    return DatasetHeader(
        m=int(tokens[0]), n=int(tokens[1]), nnz=int(tokens[2]),
        train_names=tuple(tokens[3:12]),
        nnz_test=int(tokens[12]), test_names=tuple(tokens[13:16]))


def load_ptrs(dirname: str, hdr: DatasetHeader | None = None
              ) -> tuple[np.ndarray, np.ndarray]:
    """The tiny part every process reads in full: (csr_ptr, csc_ptr)."""
    hdr = hdr or load_header(dirname)
    csr_ptr = np.fromfile(os.path.join(dirname, hdr.train_names[3]),
                          dtype="<i4", count=hdr.m + 1).astype(np.int64)
    csc_ptr = np.fromfile(os.path.join(dirname, hdr.train_names[6]),
                          dtype="<i4", count=hdr.n + 1).astype(np.int64)
    if csr_ptr.size != hdr.m + 1 or csc_ptr.size != hdr.n + 1:
        raise ValueError(f"short ptr read in {dirname}")
    return csr_ptr, csc_ptr


class RangeReader:
    """Coalesced range reads of one orientation's idx/val payload files.

    ``fetch(entities)`` returns a compact local CSR over exactly the
    requested entities in the requested order: (lptr, lidx, lval) with
    lidx[lptr[q]:lptr[q+1]] = the q-th entity's neighbors. Adjacent /
    overlapping entity byte ranges are merged into single reads;
    ``gap_merge`` > 0 additionally skips small holes to keep reads
    sequential — useful when the requested entities are contiguous on disk,
    wasteful under the ELL round-robin shard deal (interleaved ranges would
    merge across OTHER shards' data), hence default 0. ``nnz_read`` counts
    total neighbor entries actually read from disk — the honesty meter for
    "no process holds the full nnz arrays"."""

    def __init__(self, dirname: str, idx_name: str, val_name: str,
                 ptr: np.ndarray, *, gap_merge: int = 0):
        self.idx_path = os.path.join(dirname, idx_name)
        self.val_path = os.path.join(dirname, val_name)
        self.ptr = np.asarray(ptr, dtype=np.int64)
        self.gap_merge = int(gap_merge)
        self.nnz_read = 0
        self.reads = 0

    def _runs(self, lo: np.ndarray, hi: np.ndarray) -> list[tuple[int, int]]:
        order = np.argsort(lo, kind="stable")
        runs: list[list[int]] = []
        for s, e in zip(lo[order], hi[order]):
            if runs and s <= runs[-1][1] + self.gap_merge:
                runs[-1][1] = max(runs[-1][1], int(e))
            else:
                runs.append([int(s), int(e)])
        return [(s, e) for s, e in runs if e > s]

    def fetch(self, entities: np.ndarray
              ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        ents = np.asarray(entities, dtype=np.int64)
        lo, hi = self.ptr[ents], self.ptr[ents + 1]
        deg = hi - lo
        lptr = np.concatenate([[0], np.cumsum(deg)])
        total = int(lptr[-1])
        lidx = np.empty(total, np.int32)
        lval = np.empty(total, np.float32)
        runs = self._runs(lo, hi)
        # map each run into a scratch buffer, then slice per entity
        with open(self.idx_path, "rb") as fi, open(self.val_path, "rb") as fv:
            bufs = []
            starts = np.array([s for s, _ in runs], dtype=np.int64)
            for s, e in runs:
                fi.seek(s * 4)
                bi = np.fromfile(fi, dtype="<u4", count=e - s)
                fv.seek(s * 4)
                bv = np.fromfile(fv, dtype="<f4", count=e - s)
                if bi.size != e - s or bv.size != e - s:
                    raise ValueError(f"short range read [{s},{e}) in "
                                     f"{self.idx_path}")
                bufs.append((bi, bv))
                self.nnz_read += e - s
                self.reads += 1
        for q in range(ents.size):
            if deg[q] == 0:
                continue
            r = int(np.searchsorted(starts, lo[q], side="right") - 1)
            off = int(lo[q] - starts[r])
            bi, bv = bufs[r]
            lidx[lptr[q]:lptr[q + 1]] = bi[off:off + deg[q]].astype(np.int32)
            lval[lptr[q]:lptr[q + 1]] = bv[off:off + deg[q]]
        return lptr, lidx, lval


def read_csr_row_range(dirname: str, r0: int, r1: int,
                       hdr: DatasetHeader | None = None
                       ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One contiguous CSR row block [r0, r1): (local_ptr, col_idx, val) via
    a single range read per payload file — the hybrid backend's panel rows
    (contiguous in the DEGREE-SORTED space map to scattered original rows;
    use RangeReader for those. This covers pre-sorted / blocked layouts)."""
    hdr = hdr or load_header(dirname)
    csr_ptr, _ = load_ptrs(dirname, hdr)
    lo, hi = int(csr_ptr[r0]), int(csr_ptr[r1])
    with open(os.path.join(dirname, hdr.train_names[4]), "rb") as f:
        f.seek(lo * 4)
        idx = np.fromfile(f, dtype="<u4", count=hi - lo).astype(np.int32)
    with open(os.path.join(dirname, hdr.train_names[5]), "rb") as f:
        f.seek(lo * 4)
        val = np.fromfile(f, dtype="<f4", count=hi - lo)
    if idx.size != hi - lo or val.size != hi - lo:
        raise ValueError(f"short row-range read [{r0},{r1}) in {dirname}")
    return csr_ptr[r0:r1 + 1] - lo, idx, val


def fill_local_bucket_blocks(side: EllSide, grids, shard_ids,
                             reader: RangeReader,
                             other_slot_of_entity: np.ndarray,
                             other_zero_slot: int) -> list[list[tuple]]:
    """Fill ONLY the bucket rows of ``shard_ids`` from range reads.

    Returns, per bucket, one (idx_block, val_block) pair per requested
    shard, each shaped (rows_per_shard, L) — exactly the per-device blocks
    ``parallel.multihost.assemble_global`` wants (bucket arrays are
    shard-major on axis 0). Same fill semantics as data/ell._fill_side."""
    out = []
    for b, grid in zip(side.buckets, grids):
        blocks = []
        for s in shard_ids:
            ids = np.asarray(grid[s])
            idxb = np.full((b.rows_per_shard, b.L), other_zero_slot,
                           np.int32)
            valb = np.zeros((b.rows_per_shard, b.L), np.float32)
            valid = np.where(ids >= 0)[0]
            lptr, lidx, lval = reader.fetch(ids[valid])
            for q, j in enumerate(valid):
                d = int(lptr[q + 1] - lptr[q])
                r, c0 = int(j) // b.p, (int(j) % b.p) * b.E
                sl = slice(lptr[q], lptr[q + 1])
                idxb[r, c0:c0 + d] = other_slot_of_entity[lidx[sl]]
                valb[r, c0:c0 + d] = lval[sl]
            blocks.append((idxb, valb))
        out.append(blocks)
    return out


@dataclasses.dataclass(frozen=True)
class LocalEllShards:
    """One process's host-local view of the sharded ELL dataset."""

    rows_side: EllSide             # geometry only (buckets hold (0, L))
    cols_side: EllSide
    #: per bucket, per owned shard: (idx_block, val_block), shard-major
    rows_blocks: list[list[tuple]]
    cols_blocks: list[list[tuple]]
    shard_ids: list[int]
    nnz_read: int                  # neighbor entries this process read


def load_local_ell_shards(dirname: str, num_shards: int,
                          shard_ids: list[int], *, min_width: int = 8,
                          index_space: str = "slot") -> LocalEllShards:
    """The full host-local pipeline: header + ptrs (tiny) -> deterministic
    layout -> range-read + fill only ``shard_ids``'s bucket rows."""
    hdr = load_header(dirname)
    csr_ptr, csc_ptr = load_ptrs(dirname, hdr)
    rows_side, cols_side, rgrids, cgrids = plan_ell_pair(
        csr_ptr, csc_ptr, hdr.m, hdr.n, min_width=min_width,
        num_shards=num_shards)
    if index_space == "entity":
        rmap = np.arange(hdr.n, dtype=np.int32)
        cmap = np.arange(hdr.m, dtype=np.int32)
        rzero, czero = hdr.n, hdr.m
    elif index_space == "slot":
        rmap, cmap = cols_side.slot_of_entity, rows_side.slot_of_entity
        rzero, czero = cols_side.n_slots, rows_side.n_slots
    else:
        raise ValueError(f"index_space must be 'slot' or 'entity', "
                         f"got {index_space!r}")
    r_reader = RangeReader(dirname, hdr.train_names[4], hdr.train_names[5],
                           csr_ptr)
    c_reader = RangeReader(dirname, hdr.train_names[7], hdr.train_names[8],
                           csc_ptr)
    rows_blocks = fill_local_bucket_blocks(rows_side, rgrids, shard_ids,
                                           r_reader, rmap, rzero)
    cols_blocks = fill_local_bucket_blocks(cols_side, cgrids, shard_ids,
                                           c_reader, cmap, czero)
    return LocalEllShards(
        rows_side=rows_side, cols_side=cols_side,
        rows_blocks=rows_blocks, cols_blocks=cols_blocks,
        shard_ids=list(shard_ids),
        nnz_read=r_reader.nnz_read + c_reader.nnz_read)


# ---------------------------------------------------------------------------
# Hybrid-backend host-local loading
#
# The hybrid plan's LAYOUT (degree sort, panel stair, light-remainder ELL
# geometry) is nnz-independent once the light degrees are known; only the
# FILL is nnz-scale. A coordinator (or offline converter — the reference's
# own discipline, src/tools.cpp:3-85: fix the layout once, every run reads
# it) computes the layout in one streaming pass and publishes a small
# manifest (O(m+n) ints); every worker then derives the identical ELL
# geometry from the manifest and range-reads ONLY its shards' rows.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class HybridManifest:
    """Layout metadata for host-local hybrid loading: O(m+n), no nnz."""

    m: int
    n: int
    user_order: np.ndarray        # (m,) original user ids, degree-sorted
    item_order: np.ndarray        # (n,)
    panels: tuple                 # ((r0, r1, w), ...) over sorted rows
    light_deg_row: np.ndarray     # (m,) light degree per SORTED row
    light_deg_col: np.ndarray     # (n,) light degree per SORTED col


def hybrid_manifest_from_plan(plan) -> HybridManifest:
    """Derive the manifest from a HybridPlan (what the coordinator/parent
    publishes; workers never see the plan object)."""
    rows, cols = plan.ell.rows_side, plan.ell.cols_side

    def light_deg(side, count):
        deg = np.zeros(count, np.float32)
        has = side.slot_of_entity >= 0
        deg[has] = side.slot_nnz[side.slot_of_entity[has]]
        return deg.astype(np.int64)

    return HybridManifest(
        m=plan.row_nnz.shape[0], n=plan.col_nnz.shape[0],
        user_order=np.asarray(plan.user_order),
        item_order=np.asarray(plan.item_order),
        panels=tuple(tuple(p) for p in plan.panels),
        light_deg_row=light_deg(rows, plan.row_nnz.shape[0]),
        light_deg_col=light_deg(cols, plan.col_nnz.shape[0]))


def save_hybrid_manifest(path: str, mf: HybridManifest) -> None:
    np.savez(path, m=mf.m, n=mf.n, user_order=mf.user_order,
             item_order=mf.item_order,
             panels=np.asarray(mf.panels, np.int64).reshape(-1, 3),
             light_deg_row=mf.light_deg_row, light_deg_col=mf.light_deg_col)


def load_hybrid_manifest(path: str) -> HybridManifest:
    z = np.load(path)
    return HybridManifest(
        m=int(z["m"]), n=int(z["n"]), user_order=z["user_order"],
        item_order=z["item_order"],
        panels=tuple(tuple(int(x) for x in row) for row in z["panels"]),
        light_deg_row=z["light_deg_row"], light_deg_col=z["light_deg_col"])


def _width_at_row(mf: HybridManifest) -> np.ndarray:
    """(m,) panel width covering each sorted row (0 past the stair)."""
    w = np.zeros(mf.m, np.int64)
    for r0, r1, width in mf.panels:
        w[r0:r1] = width
    return w


@dataclasses.dataclass(frozen=True)
class LocalHybridShards:
    """One process's host-local view of the hybrid-plan dataset."""

    rows_side: EllSide            # light-remainder geometry (entity space)
    cols_side: EllSide
    rows_blocks: list             # per bucket, per owned shard: (idx, val)
    cols_blocks: list
    #: per panel, per owned shard: (residual_block, mask_block) f32 dense
    panel_blocks: list
    shard_ids: list
    nnz_read: int
    expected_nnz_read: int        # exact fair share (full degrees fetched)


def load_local_hybrid_shards(dirname: str, mf: HybridManifest,
                             num_shards: int, shard_ids: list[int], *,
                             ell_min_width: int = 8) -> LocalHybridShards:
    """Host-local hybrid loading: light-ELL geometry from the manifest's
    light degrees (identical in every process), then range reads of ONLY

    * this process's panel ROW blocks (each panel's rows shard contiguously
      across devices, entries with item_pos < width densify, the rest are
      skipped here — they live in the ELL blocks), and
    * this process's light-ELL bucket entities (full neighbor lists
      fetched, filtered to light entries by the stair predicate
      item_pos >= width_at_row[row_pos]).

    ``nnz_read`` counts every neighbor entry fetched (panel rows + both ELL
    orientations — an entity's list is fetched whole and filtered locally,
    so the meter counts full degrees); ``expected_nnz_read`` is the exact
    fair share so callers can assert no process over-reads."""
    hdr = load_header(dirname)
    if (hdr.m, hdr.n) != (mf.m, mf.n):
        raise ValueError("manifest/dataset shape mismatch")
    csr_ptr, csc_ptr = load_ptrs(dirname, hdr)
    lptr_r = np.concatenate([[0], np.cumsum(mf.light_deg_row)])
    lptr_c = np.concatenate([[0], np.cumsum(mf.light_deg_col)])
    rows_side, cols_side, rgrids, cgrids = plan_ell_pair(
        lptr_r, lptr_c, mf.m, mf.n, min_width=ell_min_width,
        num_shards=num_shards)
    width_row = _width_at_row(mf)
    user_pos = np.empty(mf.m, np.int64)
    user_pos[mf.user_order] = np.arange(mf.m)
    item_pos = np.empty(mf.n, np.int64)
    item_pos[mf.item_order] = np.arange(mf.n)

    r_reader = RangeReader(dirname, hdr.train_names[4], hdr.train_names[5],
                           csr_ptr)
    c_reader = RangeReader(dirname, hdr.train_names[7], hdr.train_names[8],
                           csc_ptr)
    expected = 0

    def fill_filtered(side, grids, reader, order_self, pos_other,
                      light_of, other_zero):
        """fill_local_bucket_blocks with the stair's light filter; asserts
        each slot's surviving count equals the layout's slot_nnz."""
        nonlocal expected
        out = []
        for bi, (b, grid) in enumerate(zip(side.buckets, grids)):
            off = side.bucket_offsets[bi]
            blocks = []
            for s in shard_ids:
                ids = np.asarray(grid[s])
                idxb = np.full((b.rows_per_shard, b.L), other_zero,
                               np.int32)
                valb = np.zeros((b.rows_per_shard, b.L), np.float32)
                valid = np.where(ids >= 0)[0]
                ents = ids[valid]                    # sorted positions
                lptr, lidx, lval = reader.fetch(order_self[ents])
                expected += int(lptr[-1])
                for q, j in enumerate(valid):
                    sl = slice(lptr[q], lptr[q + 1])
                    po = pos_other[lidx[sl]]
                    keep = light_of(int(ents[q]), po)
                    po, lv = po[keep], lval[sl][keep]
                    d = po.size
                    gslot = s * side.slots_per_shard + off + int(j)
                    if d != int(side.slot_nnz[gslot]):
                        raise ValueError(
                            f"light filter/layout mismatch at slot {gslot}: "
                            f"kept {d}, layout says "
                            f"{int(side.slot_nnz[gslot])}")
                    r, c0 = int(j) // b.p, (int(j) % b.p) * b.E
                    idxb[r, c0:c0 + d] = po.astype(np.int32)
                    valb[r, c0:c0 + d] = lv
                blocks.append((idxb, valb))
            out.append(blocks)
        return out

    rows_blocks = fill_filtered(
        rows_side, rgrids, r_reader, mf.user_order, item_pos,
        lambda rpos, po: po >= width_row[rpos], mf.n)
    cols_blocks = fill_filtered(
        cols_side, cgrids, c_reader, mf.item_order, user_pos,
        lambda ipos, pu: ipos >= width_row[pu], mf.m)

    # panel row blocks: contiguous sorted rows per device
    panel_blocks = []
    for r0, r1, w in mf.panels:
        rows_ = r1 - r0
        if rows_ % num_shards:
            raise ValueError(f"panel rows {rows_} not divisible by "
                             f"{num_shards} shards")
        per = rows_ // num_shards
        blocks = []
        for s in shard_ids:
            lo = r0 + s * per
            ents = np.arange(lo, lo + per)
            lptr, lidx, lval = r_reader.fetch(mf.user_order[ents])
            expected += int(lptr[-1])
            A = np.zeros((per, w), np.float32)
            Mk = np.zeros((per, w), np.float32)
            for q in range(per):
                sl = slice(lptr[q], lptr[q + 1])
                po = item_pos[lidx[sl]]
                keep = po < w
                A[q, po[keep]] = lval[sl][keep]
                Mk[q, po[keep]] = 1.0
            blocks.append((A, Mk))
        panel_blocks.append(blocks)

    return LocalHybridShards(
        rows_side=rows_side, cols_side=cols_side,
        rows_blocks=rows_blocks, cols_blocks=cols_blocks,
        panel_blocks=panel_blocks, shard_ids=list(shard_ids),
        nnz_read=r_reader.nnz_read + c_reader.nnz_read,
        expected_nnz_read=expected)
