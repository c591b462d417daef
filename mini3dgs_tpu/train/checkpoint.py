"""Checkpoint / resume: sharded numpy serialization of the training state.

The reference declares but stubs this (`/root/reference/src/train/trainer.py:73-83`,
`save_interval: 5000` in default.yaml).  Resume is exact: the full TrainState
pytree round-trips, including Adam moments, the alive mask and (when enabled)
per-camera exposure + its optimizer state.

Layout of `<output>/checkpoints/it<iteration>/`:
  * `meta.json` (process 0): every leaf's tree path, shape and dtype, and the
    number of writing processes — the capacity is read from it without
    loading any data;
  * `shards-<process>.npz`: each process writes only its addressable shards
    (one replica of each), keyed by leaf number and global index.

Restore places data by the TEMPLATE's shardings (`make_array_from_callback`):
each device reads just the region it owns, so a gauss-sharded TrainState
(parallel/sharded.py) round-trips without ever materializing the full state
on one host, and restoring onto another mesh re-shards.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Any, Optional

import jax
import numpy as np

_META = "meta.json"


def _ckpt_dir(output_path: str, iteration: int) -> Path:
    return Path(output_path).absolute() / "checkpoints" / f"it{iteration:07d}"


def _shard_file(path: Path, process: int) -> Path:
    return path / f"shards-{process:05d}.npz"


def _index_key(leaf: int, index, shape) -> str:
    """`<leaf>|<start>:<stop>,...` for a shard's global index."""
    bounds = [sl.indices(n)[:2] for sl, n in zip(index, shape)]
    return f"{leaf}|" + ",".join(f"{a}:{b}" for a, b in bounds)


def _parse_key(key: str):
    leaf, idx = key.split("|")
    bounds = [tuple(int(v) for v in b.split(":")) for b in idx.split(",")
              if b]
    return int(leaf), bounds


def _sync(tag: str) -> None:
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils
        multihost_utils.sync_global_devices(tag)


def save_checkpoint(output_path: str, iteration: int, state: Any) -> str:
    path = _ckpt_dir(output_path, iteration)
    path.mkdir(parents=True, exist_ok=True)
    leaves, _ = jax.tree_util.tree_flatten_with_path(state)
    pid = jax.process_index()
    arrays = {}
    meta = []
    for i, (kp, x) in enumerate(leaves):
        if isinstance(x, jax.Array):
            for shard in x.addressable_shards:
                if shard.replica_id == 0:
                    key = _index_key(i, shard.index, x.shape)
                    arrays[key] = np.asarray(shard.data)
        else:
            x = np.asarray(x)
            if pid == 0:
                arrays[_index_key(i, (slice(None),) * x.ndim, x.shape)] = x
        meta.append({"path": jax.tree_util.keystr(kp),
                     "shape": list(x.shape), "dtype": str(x.dtype)})
    tmp = path / f".shards-{pid:05d}.tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, _shard_file(path, pid))
    if pid == 0:
        tmp = path / ".meta.tmp"
        tmp.write_text(json.dumps({"processes": jax.process_count(),
                                   "leaves": meta}))
        os.replace(tmp, path / _META)
    _sync(f"save_checkpoint:{path}")
    return str(path)


def _read_meta(path: Path) -> dict:
    return json.loads((path / _META).read_text())


def load_checkpoint(output_path: str, iteration: int, template: Any) -> Any:
    """Restore into the template's structure AND shardings: every jax.Array
    leaf comes back placed per the template leaf's sharding (each device
    assembles only its own region from the stored shards)."""
    path = _ckpt_dir(output_path, iteration)
    meta = _read_meta(path)
    leaves, treedef = jax.tree_util.tree_flatten_with_path(template)
    saved = [m["path"] for m in meta["leaves"]]
    paths = [jax.tree_util.keystr(kp) for kp, _ in leaves]
    if saved != paths:
        raise ValueError(f"checkpoint {path} has leaves {saved}, template "
                         f"has {paths}")
    files = [np.load(_shard_file(path, p))
             for p in range(meta["processes"])]
    stored = [[] for _ in leaves]      # per leaf: (bounds, file, key)
    for f in files:
        for key in f.files:
            leaf, bounds = _parse_key(key)
            stored[leaf].append((bounds, f, key))

    def region(i, index):
        m = meta["leaves"][i]
        shape = m["shape"]
        want = [sl.indices(n)[:2] for sl, n in zip(index, shape)]
        out = np.empty([b - a for a, b in want], np.dtype(m["dtype"]))
        filled = 0
        for bounds, f, key in stored[i]:
            lo = [max(a, c) for (a, _), (c, _) in zip(want, bounds)]
            hi = [min(b, d) for (_, b), (_, d) in zip(want, bounds)]
            if any(l >= h for l, h in zip(lo, hi)):
                continue
            src = tuple(slice(l - c, h - c)
                        for l, h, (c, _) in zip(lo, hi, bounds))
            dst = tuple(slice(l - a, h - a)
                        for l, h, (a, _) in zip(lo, hi, want))
            out[dst] = f[key][src]
            filled += int(np.prod([h - l for l, h in zip(lo, hi)]))
        if filled < out.size:
            raise ValueError(f"checkpoint {path} lacks data for "
                             f"{paths[i]}{want}")
        return out

    restored = []
    try:
        for i, (_, x) in enumerate(leaves):
            shape = tuple(meta["leaves"][i]["shape"])
            if isinstance(x, jax.Array):
                restored.append(jax.make_array_from_callback(
                    shape, x.sharding, lambda idx, i=i: region(i, idx)))
            else:
                restored.append(region(i, (slice(None),) * len(shape)))
    finally:
        for f in files:
            f.close()
    return jax.tree_util.tree_unflatten(treedef, restored)


def checkpoint_capacity(output_path: str, iteration: int) -> Optional[int]:
    """Gaussian slot-pool capacity recorded in a checkpoint (leading dim of
    gaussians.xyz), read from its metadata without loading any data."""
    path = _ckpt_dir(output_path, iteration)
    if not (path / _META).exists():
        return None
    for m in _read_meta(path)["leaves"]:
        if m["path"] == ".gaussians.xyz":
            return int(m["shape"][0])
    return None


def latest_checkpoint_iteration(output_path: str) -> Optional[int]:
    root = Path(output_path) / "checkpoints"
    if not root.exists():
        return None
    its = sorted(int(p.name[2:]) for p in root.iterdir()
                 if p.name.startswith("it"))
    return its[-1] if its else None
