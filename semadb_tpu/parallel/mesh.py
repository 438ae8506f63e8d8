"""Mesh construction helpers."""

from __future__ import annotations

from typing import Optional, Sequence

import jax
from jax.sharding import Mesh

SHARD_AXIS = "shard"


def shard_mesh(n_devices: int = 0, devices: Optional[Sequence] = None) -> Mesh:
    """1-D mesh over the shard axis.

    The reference spreads shards over servers by rendezvous hashing
    (cluster/hashing.go); on one host's devices the analog is one shard per
    device along a single mesh axis, with collectives doing the fan-out.
    """
    if devices is None:
        devices = jax.devices()
        if n_devices:
            devices = devices[:n_devices]
    import numpy as np

    return Mesh(np.array(devices), (SHARD_AXIS,))
