"""Mesh construction and multi-host bring-up helpers."""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh

BLOCK_AXIS = "blocks"


def local_device_count() -> int:
    return jax.local_device_count()


def make_mesh(n_devices: Optional[int] = None, axis: str = BLOCK_AXIS,
              devices: Optional[Sequence] = None) -> Mesh:
    """1-D mesh over the block axis — the natural FastLanes topology: blocks
    never interact, so data-parallel over all devices (several hosts are
    handled by jax.distributed device ordering). The mesh follows the
    algorithm, not the interconnect."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(f"asked for {n_devices} devices, have {len(devices)}")
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (axis,))


def setup_distributed(coordinator_address: Optional[str] = None,
                      num_processes: Optional[int] = None,
                      process_id: Optional[int] = None) -> int:
    """Multi-host bring-up: initialize jax.distributed when running one
    process per host. No-op for single-process runs.

    Returns the global device count. The codec needs no further host logic —
    shard_map + the mesh handle cross-host collectives."""
    if num_processes is not None and num_processes > 1:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    return len(jax.devices())
