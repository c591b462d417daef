"""Multi-process initialization (SURVEY §7 stage 8).

With several processes every process runs the same program;
`initialize_distributed()` wires jax.distributed so jax.devices() spans all
of them, and `make_global_mesh` lays out (data, tile) so that the `tile`
axis (which carries the all_gather of image bands and the psum of
per-Gaussian gradients every step) stays inside one host, while the `data`
axis (one psum of averaged gradients per step) may cross hosts.

Single-host meshes from `parallel.mesh.make_mesh` remain the default; nothing
here is required on one host.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh


_initialized = False


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None) -> None:
    """Idempotent jax.distributed.initialize with env fallbacks
    (COORDINATOR_ADDRESS / NUM_PROCESSES / PROCESS_ID).  Nothing tells JAX
    of a cluster on a plain GPU host: pass all three.

    NOTE: must run before ANY backend query — even jax.process_count()
    initializes the runtime and pins single-process mode (a guard built on
    it silently broke multi-process init; tests/test_multiprocess.py pins
    the fixed behavior)."""
    global _initialized
    if _initialized:
        return
    kwargs = {}
    addr = coordinator_address or os.environ.get("COORDINATOR_ADDRESS")
    if addr:
        kwargs["coordinator_address"] = addr
    if num_processes or os.environ.get("NUM_PROCESSES"):
        kwargs["num_processes"] = int(num_processes
                                      or os.environ["NUM_PROCESSES"])
    if process_id is not None or os.environ.get("PROCESS_ID"):
        kwargs["process_id"] = int(process_id
                                   if process_id is not None
                                   else os.environ["PROCESS_ID"])
    explicit = bool(kwargs)
    try:
        jax.distributed.initialize(**kwargs)
        _initialized = True
    except Exception:
        if explicit:
            # caller asked for a specific topology: failing silently would
            # train a wrong (single-process) program
            raise
        # bare single-process environments (tests, one host) proceed unwired


def make_global_mesh(data: Optional[int] = None,
                     tile: Optional[int] = None) -> Mesh:
    """(data, tile) mesh over all devices with tile kept host-local.

    Default: tile = devices per host, data = number of hosts.  jax orders
    jax.devices() host-major, so reshaping [hosts, devices_per_host] keeps
    each tile group on one host.
    """
    devices = np.asarray(jax.devices())
    n_local = jax.local_device_count()
    n_total = len(devices)
    if tile is None:
        tile = n_local
    if data is None:
        data = n_total // tile
    assert data * tile <= n_total
    grid = devices[: data * tile].reshape(data, tile)
    return Mesh(grid, axis_names=("data", "tile"))
