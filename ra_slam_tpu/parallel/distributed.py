"""Multi-host (multi-process) runtime wiring.

The reference is strictly single-process/single-GPU (SURVEY.md §2.9,
§5.8); this is the greenfield multi-host layer: `jax.distributed.initialize`
based process bootstrap, a global device mesh spanning all hosts, and
helpers to build replicated global arrays from per-host data (each host
decodes its own camera frames; images are replicated because they are
tiny next to the sharded map).

On GPUs XLA hands the collectives to NCCL (NVLink within a host, the
network across hosts); the same code runs multi-process on CPU (gloo)
for tests — which is how `tests/test_distributed.py` exercises this
wiring without several hosts.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Bootstrap this process into the multi-host runtime.

    Arguments default to the standard env vars
    (`RA_SLAM_COORDINATOR`, `RA_SLAM_NUM_PROCESSES`, `RA_SLAM_PROCESS_ID`),
    so launchers only need to export three variables per host. No-op
    when num_processes <= 1.
    """
    coordinator_address = coordinator_address or os.environ.get(
        "RA_SLAM_COORDINATOR", "localhost:9910"
    )
    num_processes = int(
        num_processes
        if num_processes is not None
        else os.environ.get("RA_SLAM_NUM_PROCESSES", "1")
    )
    process_id = int(
        process_id
        if process_id is not None
        else os.environ.get("RA_SLAM_PROCESS_ID", "0")
    )
    if num_processes <= 1:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def global_mesh(axis: str = "map", devices: Optional[Sequence] = None) -> Mesh:
    """1-D mesh over every device of every host."""
    devs = list(devices) if devices is not None else jax.devices()
    return Mesh(np.array(devs), (axis,))


def replicate_global(mesh: Mesh, x: np.ndarray) -> jax.Array:
    """Build a fully-replicated global array from host-local data (every
    host passes identical values — e.g. the current camera frame)."""
    sharding = NamedSharding(mesh, P())
    return jax.make_array_from_callback(
        np.shape(x), sharding, lambda idx: np.asarray(x)[idx]
    )


def process_info() -> dict:
    return {
        "process_index": jax.process_index(),
        "process_count": jax.process_count(),
        "local_devices": len(jax.local_devices()),
        "global_devices": len(jax.devices()),
    }
