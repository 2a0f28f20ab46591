"""Multi-process worker for the real multi-host test (tests/test_multihost.py).

Each of the two worker processes owns 4 virtual CPU devices, joins the
process group via ``multihost.initialize`` (jax.distributed), and loads its
shard rows HOST-LOCALLY from the reference-format binary dataset dir the
parent test wrote: the tiny ptr arrays give every process the identical
deterministic ELL layout (data/ell.plan_ell_pair), and range reads fetch
ONLY the idx/val bytes of the entities this process's shards own
(data/shard_loader.py — the worker asserts its nnz_read stays within its
fair share, so no process ever holds the full nnz arrays). The local blocks
feed ``multihost.assemble_global``, then 2 sharded CCD++ outer iterations
run through the production shard_map step and the addressable factor shards
are dumped for the test to reassemble and compare against the
single-process run.

Usage: python multihost_worker.py <process_id> <num_processes> <port> <outdir>
       (the dataset dir is <outdir>/data, written by the parent test)
"""

import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

import numpy as np  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from cuda_recommender_tpu.core.init import init_factors_np  # noqa: E402
from cuda_recommender_tpu.data.ell import EllPair  # noqa: E402
from cuda_recommender_tpu.data.shard_loader import (  # noqa: E402
    load_local_ell_shards)
from cuda_recommender_tpu.parallel import multihost  # noqa: E402
from cuda_recommender_tpu.parallel.ccd_ell_sharded import (  # noqa: E402
    make_sharded_ell_step)
from cuda_recommender_tpu.parallel.mesh import AXIS  # noqa: E402

M, N, NNZ, K, LAM, SEED, ITERS = 120, 60, 2000, 4, 0.1, 5, 2


def main() -> None:
    pid, nproc, port, outdir = (int(sys.argv[1]), int(sys.argv[2]),
                                int(sys.argv[3]), sys.argv[4])
    multihost.initialize(coordinator_address=f"localhost:{port}",
                         num_processes=nproc, process_id=pid)
    assert jax.process_index() == pid
    assert jax.local_device_count() == 4
    assert jax.device_count() == 4 * nproc
    mesh = multihost.global_mesh()
    n_dev = mesh.devices.size
    mine = multihost.local_shard_ids(mesh)

    # host-local load: layout from the tiny ptr arrays, nnz by range reads
    # of ONLY this process's shard entities
    shards = load_local_ell_shards(os.path.join(outdir, "data"), n_dev,
                                   mine, min_width=8)
    rows, cols = shards.rows_side, shards.cols_side
    # honesty: this process read EXACTLY its own shards' entities' neighbor
    # entries (per-shard slot_nnz totals), strictly less than the full nnz
    expected = 0
    for side in (rows, cols):
        for s in mine:
            sl = slice(s * side.slots_per_shard,
                       (s + 1) * side.slots_per_shard)
            expected += int(side.slot_nnz[sl].sum())
    assert shards.nnz_read == expected, (
        f"process {pid} read {shards.nnz_read} neighbor entries, expected "
        f"exactly its shards' {expected}")
    assert shards.nnz_read < 2 * NNZ
    ell = EllPair(rows_side=rows, cols_side=cols, n_rows=M, n_cols=N,
                  nnz=NNZ)
    W0, _ = init_factors_np(K, M, N, seed=0)

    def put_bucket(side, blocks_b, rows_per_shard, L, which):
        blks = [np.ascontiguousarray(pair[which]) for pair in blocks_b]
        return multihost.assemble_global(
            blks, mesh, P(AXIS, None), (n_dev * rows_per_shard, L))

    def put_side(side, blocks):
        idx, val = [], []
        for b, blocks_b in zip(side.buckets, blocks):
            idx.append(put_bucket(side, blocks_b, b.rows_per_shard, b.L, 0))
            val.append(put_bucket(side, blocks_b, b.rows_per_shard, b.L, 1))
        return tuple(idx), tuple(val)

    idx_r, vals_r = put_side(rows, shards.rows_blocks)
    idx_c, vals_c = put_side(cols, shards.cols_blocks)

    def col_blocks(arr):             # (k, n_slots) factors: sharded axis 1
        per = arr.shape[1] // n_dev
        return [arr[:, i * per:(i + 1) * per] for i in mine]

    def vec_blocks(arr):             # (n_slots,) slot vectors
        return multihost.shard_rows_for_process(arr, mesh)

    def put_cols(arr):
        return multihost.assemble_global(col_blocks(arr), mesh,
                                         P(None, AXIS), arr.shape)

    def put_vec(arr):
        return multihost.assemble_global(vec_blocks(arr), mesh, P(AXIS),
                                         arr.shape)

    W_s = np.zeros((K, rows.n_slots), np.float32)
    W_s[:, rows.slot_of_entity] = W0
    W = put_cols(W_s)
    H = put_cols(np.zeros((K, cols.n_slots), np.float32))
    u_pend = put_vec(np.zeros(rows.n_slots, np.float32))
    v_pend = put_vec(np.zeros(cols.n_slots, np.float32))
    nnz_r = put_vec(rows.slot_nnz)
    nnz_c = put_vec(cols.slot_nnz)

    step = make_sharded_ell_step(ell, mesh, LAM, 1)
    for _ in range(ITERS):
        vals_r, vals_c, W, H, u_pend, v_pend = step(
            idx_r, idx_c, vals_r, vals_c, W, H, nnz_r, nnz_c, u_pend, v_pend)

    # dump THIS process's addressable factor shards with their slot offsets
    out = {}
    for name, arr in (("W", W), ("H", H)):
        for s in arr.addressable_shards:
            start = s.index[1].start or 0
            out[f"{name}_{start}"] = np.asarray(s.data)
    np.savez(os.path.join(outdir, f"shards_{pid}.npz"), **out)
    print(f"worker {pid} done (nnz_read={shards.nnz_read})", flush=True)


if __name__ == "__main__":
    main()
