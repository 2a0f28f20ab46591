"""Multi-process worker for the real multi-host HYBRID test
(tests/test_multihost.py::test_two_process_hybrid_matches_single_process).

Round-4 host-local discipline for the panel-hybrid flagship path: the
parent writes the reference-format binary dataset plus a small layout
manifest (degree orders, panel stair, light degrees — O(m+n), what a
coordinator computes in one streaming pass; data/shard_loader.py
HybridManifest). Each of the two processes then derives the identical
light-ELL geometry from the manifest and RANGE-READS only its own panel
row blocks and light-ELL bucket entities
(shard_loader.load_local_hybrid_shards) — asserting nnz_read equals its
exact fair share, so no process ever materializes full nnz arrays — and
runs the production shard_map hybrid step with cross-process psum
collectives (factors replicated).

Usage: python multihost_hybrid_worker.py <pid> <nproc> <port> <outdir>
       (dataset at <outdir>/hyb_data, manifest at <outdir>/hyb_manifest.npz)
"""

import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from cuda_recommender_tpu.core.config import Config  # noqa: E402
from cuda_recommender_tpu.core.init import init_factors_np  # noqa: E402
from cuda_recommender_tpu.data.ell import EllPair  # noqa: E402
from cuda_recommender_tpu.data.shard_loader import (  # noqa: E402
    load_header, load_hybrid_manifest, load_local_hybrid_shards, load_ptrs)
from cuda_recommender_tpu.parallel import multihost  # noqa: E402
from cuda_recommender_tpu.parallel.mesh import AXIS  # noqa: E402
from cuda_recommender_tpu.parallel.ccd_hybrid_sharded import (  # noqa: E402
    make_sharded_hybrid_step)
from cuda_recommender_tpu.solvers.ccd_hybrid import HybridPlan  # noqa: E402

M, N, NNZ, K, LAM, SEED, ITERS = 96, 48, 1500, 4, 0.1, 7, 2


def make_cfg():
    return Config(k=K, maxiter=ITERS, lambda_=LAM, backend="hybrid",
                  hybrid_dense_cells=24 * N, hybrid_panel_widths=(16,),
                  mask_dtype="int8")


def main() -> None:
    pid, nproc, port, outdir = (int(sys.argv[1]), int(sys.argv[2]),
                                int(sys.argv[3]), sys.argv[4])
    multihost.initialize(coordinator_address=f"localhost:{port}",
                         num_processes=nproc, process_id=pid)
    assert jax.process_index() == pid
    mesh = multihost.global_mesh()
    n_dev = mesh.devices.size
    mine = multihost.local_shard_ids(mesh)

    cfg = make_cfg()
    data_dir = os.path.join(outdir, "hyb_data")
    mf = load_hybrid_manifest(os.path.join(outdir, "hyb_manifest.npz"))
    shards = load_local_hybrid_shards(data_dir, mf, n_dev, mine,
                                      ell_min_width=cfg.ell_min_width)
    # honesty meter: exactly the fair share (full neighbor lists of this
    # process's panel rows + its light-ELL entities), never the full nnz
    assert shards.nnz_read == shards.expected_nnz_read, (
        f"process {pid} read {shards.nnz_read}, expected "
        f"{shards.expected_nnz_read}")
    assert shards.nnz_read < 2 * NNZ
    rows, cols = shards.rows_side, shards.cols_side

    # geometry-only plan for the production sharded step
    hdr = load_header(data_dir)
    csr_ptr, csc_ptr = load_ptrs(data_dir, hdr)
    deg_u = np.diff(csr_ptr).astype(np.float32)
    deg_i = np.diff(csc_ptr).astype(np.float32)
    user_pos = np.empty(M, np.int64)
    user_pos[mf.user_order] = np.arange(M)
    item_pos = np.empty(N, np.int64)
    item_pos[mf.item_order] = np.arange(N)
    plan = HybridPlan(
        user_order=mf.user_order, item_order=mf.item_order,
        user_pos=user_pos, item_pos=item_pos, panels=tuple(mf.panels),
        ell=EllPair(rows_side=rows, cols_side=cols, n_rows=M, n_cols=N,
                    nnz=NNZ),
        nnz_light=int(mf.light_deg_row.sum()), Rd=(), Md=(),
        row_nnz=deg_u[mf.user_order], col_nnz=deg_i[mf.item_order],
        slot_of_upos=rows.slot_of_entity.astype(np.int32),
        slot_of_ipos=cols.slot_of_entity.astype(np.int32),
        upos_of_slot_safe=np.where(rows.entity_of_slot < 0, M,
                                   rows.entity_of_slot).astype(np.int32),
        ipos_of_slot_safe=np.where(cols.entity_of_slot < 0, N,
                                   cols.entity_of_slot).astype(np.int32))
    W0, _ = init_factors_np(K, M, N, seed=0)

    def put_blocks(blocks_b, shape, which, dtype):
        blks = [np.ascontiguousarray(pair[which], dtype)
                for pair in blocks_b]
        return multihost.assemble_global(blks, mesh, P(AXIS, None), shape)

    def put_side(side, blocks):
        idx, val = [], []
        for b, blocks_b in zip(side.buckets, blocks):
            shp = (n_dev * b.rows_per_shard, b.L)
            idx.append(put_blocks(blocks_b, shp, 0, np.int32))
            val.append(put_blocks(blocks_b, shp, 1, np.float32))
        return tuple(idx), tuple(val)

    idx_r, vals_r = put_side(rows, shards.rows_blocks)
    idx_c, vals_c = put_side(cols, shards.cols_blocks)
    Rds, masks = [], []
    for (r0, r1, w), blocks_b in zip(mf.panels, shards.panel_blocks):
        Rds.append(put_blocks(blocks_b, (r1 - r0, w), 0, np.float32))
        masks.append(put_blocks(blocks_b, (r1 - r0, w), 1, np.int8))
    Rds, masks = tuple(Rds), tuple(masks)

    def put_vec(arr):                # (n_slots,) sharded slot vectors
        return multihost.assemble_global(
            multihost.shard_rows_for_process(arr, mesh), mesh, P(AXIS),
            arr.shape)

    def put_rep(arr):                # replicated: full copy per local device
        nloc = len(mine)
        return multihost.assemble_global([arr] * nloc, mesh, P(), arr.shape)

    def put_rows_arr(arr):
        return multihost.assemble_global(
            multihost.shard_rows_for_process(arr, mesh), mesh,
            P(AXIS, None), arr.shape)

    W = put_rep(np.asarray(W0, np.float32)[:, plan.user_order])
    H = put_rep(np.zeros((K, N), np.float32))
    u_pend = put_rep(np.zeros(M, np.float32))
    v_pend = put_rep(np.zeros(N, np.float32))
    row_nnz = put_rep(plan.row_nnz)
    col_nnz = put_rep(plan.col_nnz)
    eosr = put_vec(plan.upos_of_slot_safe)
    eosi = put_vec(plan.ipos_of_slot_safe)

    def local_map(slot_of_pos, slots_per_shard, n_ent):
        out = np.full((n_dev, n_ent), slots_per_shard, np.int32)
        owner = slot_of_pos.astype(np.int64) // slots_per_shard
        local = slot_of_pos.astype(np.int64) % slots_per_shard
        out[owner, np.arange(n_ent)] = local
        return out

    lsu = put_rows_arr(local_map(plan.slot_of_upos, rows.slots_per_shard, M))
    lsi = put_rows_arr(local_map(plan.slot_of_ipos, cols.slots_per_shard, N))

    step = make_sharded_hybrid_step(plan, mesh, LAM, 1,
                                    residual_dtype=jnp.float32)
    s = (Rds, vals_r, vals_c, W, H, u_pend, v_pend)
    for _ in range(ITERS):
        s = step(idx_r, idx_c, s[0], masks, s[1], s[2], s[3], s[4],
                 s[5], s[6], row_nnz, col_nnz, lsu, lsi, eosr, eosi)

    # factors are replicated — process 0's copy is the full result
    if pid == 0:
        np.savez(os.path.join(outdir, "hybrid_result.npz"),
                 W=np.asarray(s[3]), H=np.asarray(s[4]))
    print(f"hybrid worker {pid} done (nnz_read={shards.nnz_read})",
          flush=True)


if __name__ == "__main__":
    main()
