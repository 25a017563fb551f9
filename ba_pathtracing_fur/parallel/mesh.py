"""Device meshes for multi-chip rendering.

The reference has no distributed computing at all (SURVEY §2.4: CTPL threads
on one node, grep-verified no MPI/NCCL). This module is the from-scratch
replacement: a `jax.sharding.Mesh` with two axes —

  * "dp"  — data parallelism over pixels/rays (the primary strategy: the
            image is embarrassingly parallel, mirroring the reference's
            row-sharded `for_loop_double`, Threading.h:104).
  * "geo" — geometry parallelism: triangle/cone packs sharded across
            devices for scenes whose primitive arrays exceed one device's
            memory
            (the "TP analog" of SURVEY §2.4); hits are merged with an
            all-gather + argmin over the axis, occlusion with a psum-OR.

The mesh carries no topology: the cards of one host reach each other at
the same rate, so the axes follow the algorithm alone.
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh

DP_AXIS = "dp"
GEO_AXIS = "geo"


def make_mesh(n_devices: int | None = None, geo: int = 1,
              devices=None) -> Mesh:
    """A (dp, geo) mesh over `n_devices` (default: all available).

    `geo` devices share each pixel shard and split the scene geometry;
    dp = n_devices // geo.
    """
    if devices is None:
        devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    devices = devices[:n_devices]
    if n_devices % geo != 0:
        raise ValueError(f"n_devices={n_devices} not divisible by geo={geo}")
    dp = n_devices // geo
    arr = np.asarray(devices).reshape(dp, geo)
    return Mesh(arr, (DP_AXIS, GEO_AXIS))


def multihost_initialize(**kwargs) -> None:
    """Bring up the JAX multi-host runtime (coordinator discovery via env)
    before building a cross-host mesh. No-op if already initialized."""
    try:
        jax.distributed.initialize(**kwargs)
    except RuntimeError:
        pass  # already initialized
