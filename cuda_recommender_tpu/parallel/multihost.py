"""Multi-host execution: process-group init and host-local shard placement.

The reference has no distributed story (single GPU hard-coded,
/root/reference/cuda_src/CCD_CUDA.cu:170). This is the new layer:
``jax.distributed.initialize`` forms the process group, and every host
feeds ONLY its local devices' shard rows of the
ELL buckets / factor blocks — ``assemble_global`` stitches host-local numpy
blocks into one global jax.Array without any host ever materializing the full
dataset. The solvers are shard-count-agnostic: the same shard_map step runs
unchanged on 1 host or N (its collectives are expressed against the mesh).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .mesh import AXIS


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """jax.distributed.initialize with env fallbacks (JAX_COORDINATOR_ADDRESS,
    JAX_NUM_PROCESSES, JAX_PROCESS_ID). No-op when single-process and no
    coordinator is configured."""
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS")
    if num_processes is None and "JAX_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and "JAX_PROCESS_ID" in os.environ:
        process_id = int(os.environ["JAX_PROCESS_ID"])
    if coordinator_address is None and num_processes is None:
        return
    kw = {}
    if coordinator_address:
        kw["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kw["num_processes"] = num_processes
    if process_id is not None:
        kw["process_id"] = process_id
    jax.distributed.initialize(**kw)


def global_mesh(axis_name: str = AXIS) -> Mesh:
    """1-D mesh over all global devices (all hosts)."""
    return Mesh(np.array(jax.devices()), (axis_name,))


def local_shard_ids(mesh: Mesh) -> list[int]:
    """Global shard indices owned by this process, in mesh order."""
    flat = list(mesh.devices.flat)
    return [i for i, d in enumerate(flat) if d.process_index == jax.process_index()]


def assemble_global(local_blocks: Sequence[np.ndarray], mesh: Mesh,
                    spec: P, global_shape: tuple[int, ...]) -> jax.Array:
    """Build a global sharded array from THIS HOST's shard blocks.

    ``local_blocks`` must be ordered like local_shard_ids(mesh); each block is
    one device's shard (shape = global_shape with the sharded axis divided by
    mesh size). Other hosts contribute their own blocks — no host holds the
    full array.
    """
    sharding = NamedSharding(mesh, spec)
    flat = list(mesh.devices.flat)
    mine = [d for d in flat if d.process_index == jax.process_index()]
    if len(local_blocks) != len(mine):
        raise ValueError(f"need {len(mine)} local blocks, got {len(local_blocks)}")
    buffers = [jax.device_put(blk, d) for blk, d in zip(local_blocks, mine)]
    return jax.make_array_from_single_device_arrays(global_shape, sharding,
                                                    buffers)


def shard_rows_for_process(arr: np.ndarray, mesh: Mesh) -> list[np.ndarray]:
    """Split a full array's axis-0 into this process's shard blocks (testing /
    single-host convenience — real multi-host loaders read only their rows)."""
    n_dev = mesh.devices.size
    if arr.shape[0] % n_dev:
        raise ValueError("axis 0 not divisible by mesh size")
    per = arr.shape[0] // n_dev
    return [arr[i * per:(i + 1) * per] for i in local_shard_ids(mesh)]
