"""Device mesh construction helpers.

The reference has no distributed machinery at all (SURVEY §2.5); this package
is the parallelism layer: a (data, tile) mesh with `shard_map` SPMD programs
in `parallel/sharded.py`.  The mesh follows the algorithm alone — the cards
of one host are joined all to all (NVLink), so no axis order is preferred.

Axes:
  * data — camera-batch parallelism (DP): each device trains a different view;
    per-Gaussian grads are averaged with `pmean`.
  * tile — image-band parallelism (the workload's sequence/context
    parallelism, SURVEY §2.5): each device rasterizes a horizontal band of
    whole tile rows; per-Gaussian grads are partial sums reduced over the
    axis.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(data: int = 1, tile: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    devices = list(devices if devices is not None else jax.devices())
    n = data * tile
    if len(devices) < n:
        raise ValueError(f"need {n} devices, have {len(devices)}")
    dev = np.asarray(devices[:n]).reshape(data, tile)
    return Mesh(dev, axis_names=("data", "tile"))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def data_sharded(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P("data"))
