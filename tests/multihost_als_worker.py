"""Multi-process worker for the real multi-host ALS test
(tests/test_multihost.py::test_two_process_als_matches_single_process).

Each of two processes owns 4 virtual CPU devices and — like the CCD ELL
worker (multihost_worker.py) — loads its shard rows HOST-LOCALLY from the
reference-format binary dataset dir the parent test wrote: the tiny ptr
arrays give every process the identical deterministic ELL layout
(data/ell.plan_ell_pair), range reads fetch ONLY the idx/val bytes of the
entities this process's shards own (data/shard_loader.py), and the worker
asserts its nnz_read equals exactly its shards' fair share — no process
ever holds the full nnz arrays. The blocks feed
``multihost.assemble_global`` and one production make_sharded_als_step
runs with cross-process all_gather (Gloo) per half-iteration.

Usage: python multihost_als_worker.py <pid> <nproc> <port> <outdir>
       (the dataset dir is <outdir>/als_data, written by the parent test)
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
from cuda_recommender_tpu.parallel.als_ell_sharded import (  # noqa: E402
    make_sharded_als_step)
from cuda_recommender_tpu.parallel.mesh import AXIS  # noqa: E402

M, N, NNZ, K, LAM, SEED, ITERS = 120, 60, 2000, 4, 0.1, 5, 2
MIN_WIDTH = 128   # cfg.als_min_width default


def main() -> None:
    pid, nproc, port, outdir = (int(sys.argv[1]), int(sys.argv[2]),
                                int(sys.argv[3]), sys.argv[4])
    multihost.initialize(coordinator_address=f"localhost:{port}",
                         num_processes=nproc, process_id=pid)
    mesh = multihost.global_mesh()
    n_dev = mesh.devices.size
    mine = multihost.local_shard_ids(mesh)

    # host-local load: layout from the tiny ptr arrays, nnz by range reads
    # of ONLY this process's shard entities (slot index space — the ALS
    # factor tables are slot-row-sharded)
    shards = load_local_ell_shards(os.path.join(outdir, "als_data"), n_dev,
                                   mine, min_width=MIN_WIDTH)
    rows, cols = shards.rows_side, shards.cols_side
    expected = 0
    for side in (rows, cols):
        for s in mine:
            sl = slice(s * side.slots_per_shard,
                       (s + 1) * side.slots_per_shard)
            expected += int(side.slot_nnz[sl].sum())
    assert shards.nnz_read == expected, (
        f"als process {pid} read {shards.nnz_read} neighbor entries, "
        f"expected exactly its shards' {expected}")
    assert shards.nnz_read < 2 * NNZ
    ell = EllPair(rows_side=rows, cols_side=cols, n_rows=M, n_cols=N,
                  nnz=NNZ)
    W0, H0 = init_factors_np(K, M, N, seed=0, entity_major=True)

    def put_bucket(blocks_b, rows_per_shard, L, which):
        blks = [np.ascontiguousarray(pair[which]) for pair in blocks_b]
        return multihost.assemble_global(
            blks, mesh, P(AXIS, None), (n_dev * rows_per_shard, L))

    def put_side(side, blocks):
        idx, val = [], []
        for b, blocks_b in zip(side.buckets, blocks):
            idx.append(put_bucket(blocks_b, b.rows_per_shard, b.L, 0))
            val.append(put_bucket(blocks_b, b.rows_per_shard, b.L, 1))
        return tuple(idx), tuple(val)

    idx_r, vals_r = put_side(rows, shards.rows_blocks)
    idx_c, vals_c = put_side(cols, shards.cols_blocks)

    def put_rows(arr):               # (n_slots, ...) slot-row sharded
        return multihost.assemble_global(
            multihost.shard_rows_for_process(arr, mesh), mesh,
            P(AXIS, None), arr.shape)

    def put_vec(arr):
        return multihost.assemble_global(
            multihost.shard_rows_for_process(arr, mesh), mesh, P(AXIS),
            arr.shape)

    W_s = np.zeros((rows.n_slots, K), np.float32)
    W_s[rows.slot_of_entity] = np.asarray(W0, np.float32)
    H_s = np.zeros((cols.n_slots, K), np.float32)
    H_s[cols.slot_of_entity] = np.asarray(H0, np.float32)
    W, H = put_rows(W_s), put_rows(H_s)
    nnz_r = put_vec(rows.slot_nnz)
    nnz_c = put_vec(cols.slot_nnz)

    step = make_sharded_als_step(ell, mesh, LAM, 512)
    for _ in range(ITERS):
        W, H = step(idx_r, idx_c, vals_r, vals_c, W, H, nnz_r, nnz_c)

    # dump THIS process's addressable slot-row shards
    out = {}
    for name, arr in (("W", W), ("H", H)):
        for s in arr.addressable_shards:
            start = s.index[0].start or 0
            out[f"{name}_{start}"] = np.asarray(s.data)
    np.savez(os.path.join(outdir, f"als_shards_{pid}.npz"), **out)
    print(f"als worker {pid} done (nnz_read={shards.nnz_read})", flush=True)


if __name__ == "__main__":
    main()
