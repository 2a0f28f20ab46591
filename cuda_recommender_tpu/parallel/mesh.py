"""Device mesh setup and sharding specs.

The reference is single-GPU by construction (``cudaSetDevice(0)``,
/root/reference/cuda_src/CCD_CUDA.cu:170) — this layer is new design
(SURVEY.md §2 parallelism inventory): a 1-D mesh over all devices, factor
tables row-sharded in slot space, rating buckets row-sharded, dense residuals
user-sharded. Collectives are XLA's (`all_gather`/`psum`, NCCL on GPUs) —
there is no hand-rolled transport. Every card reaches every other at the
same rate, so the mesh follows the algorithm alone.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

AXIS = "d"


def make_mesh(devices: Optional[Sequence] = None, axis_name: str = AXIS) -> Mesh:
    """1-D mesh over the given (default: all) devices."""
    devs = list(devices) if devices is not None else jax.devices()
    return Mesh(np.array(devs), (axis_name,))


def dense_ccd_shardings(mesh: Mesh, axis_name: str = AXIS) -> dict:
    """Sharding dict consumed by solvers.ccd_dense.ccd_dense_train:
    residual/mask user-row-sharded, W sharded over users, H replicated (the
    v-sweep takes a psum over user partials; the u-sweep is local)."""
    return {
        "rowmat": NamedSharding(mesh, P(axis_name, None)),
        "rowvec": NamedSharding(mesh, P(axis_name)),
        "colvec": NamedSharding(mesh, P()),
        "colshard_k_m": NamedSharding(mesh, P(None, axis_name)),
        "colshard_k_n": NamedSharding(mesh, P()),
        "rep": NamedSharding(mesh, P()),
        "_divs": (mesh.devices.size, 1),
    }


def make_mesh_2d(shape: tuple[int, int],
                 devices: Optional[Sequence] = None,
                 axis_names: tuple[str, str] = ("u", "i")) -> Mesh:
    """2-D (users, items) mesh for the dense CCD path."""
    devs = list(devices) if devices is not None else jax.devices()
    a, b = shape
    if a * b > len(devs):
        raise ValueError(f"mesh {shape} needs {a*b} devices, have {len(devs)}")
    return Mesh(np.array(devs[:a * b]).reshape(a, b), axis_names)


def dense_ccd_shardings_2d(mesh: Mesh) -> dict:
    """2-D dense CCD sharding: residual/mask blocked (users, items), W
    sharded over the user axis, H over the item axis. XLA inserts the
    v-sweep's psum over the user axis and the u-sweep's over the item axis
    ; every device holds an (m/a, n/b) residual block — the layout that
    scales Netflix-sized dense residuals past one device's memory."""
    ua, ia = mesh.axis_names
    a, b = mesh.devices.shape
    return {
        "rowmat": NamedSharding(mesh, P(ua, ia)),
        "rowvec": NamedSharding(mesh, P(ua)),
        "colvec": NamedSharding(mesh, P(ia)),
        "colshard_k_m": NamedSharding(mesh, P(None, ua)),
        "colshard_k_n": NamedSharding(mesh, P(None, ia)),
        "rep": NamedSharding(mesh, P()),
        "_divs": (a, b),
    }


def ell_shardings(mesh: Mesh, axis_name: str = AXIS) -> dict:
    """Shardings for ELL bucket arrays and slot-space factors (shard-major
    slot order makes axis-0/axis-1 block sharding line up with shard ids)."""
    return {
        "bucket": NamedSharding(mesh, P(axis_name, None)),
        "slots": NamedSharding(mesh, P(axis_name)),
        "factors_rank_major": NamedSharding(mesh, P(None, axis_name)),
        "factors_entity_major": NamedSharding(mesh, P(axis_name, None)),
        "rep": NamedSharding(mesh, P()),
    }
