"""Tracing / profiling utilities (SURVEY §5 aux-subsystem checklist).

The reference declares tensorboard/tqdm as dependencies but never uses them;
here we provide real observability: `jax.profiler` trace capture, simple wall
timers, and roofline-style throughput counters for the raster pipeline
(pixels/s, gaussians/s, instances/s).
"""

from __future__ import annotations

import contextlib
import json
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Optional

import jax


@contextlib.contextmanager
def trace(log_dir: str = "output/trace"):
    """Capture a jax.profiler trace viewable in TensorBoard/Perfetto."""
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


@contextlib.contextmanager
def timer(name: str, sink: Optional[Dict[str, float]] = None,
          block_on=None):
    t0 = time.perf_counter()
    yield
    if block_on is not None:
        jax.block_until_ready(block_on)
    dt = time.perf_counter() - t0
    if sink is not None:
        sink[name] = dt
    else:
        print(f"[timer] {name}: {dt * 1000:.2f} ms")


@dataclass
class ThroughputCounters:
    """Roofline-style counters for a render/train step."""

    pixels: int = 0
    gaussians: int = 0
    instances: int = 0
    seconds: float = 0.0

    def report(self) -> Dict[str, float]:
        s = max(self.seconds, 1e-9)
        return {
            "Mpixels_per_s": self.pixels / s / 1e6,
            "Mgaussians_per_s": self.gaussians / s / 1e6,
            "Minstances_per_s": self.instances / s / 1e6,
            "ms_per_step": s * 1e3,
        }

    def json_line(self) -> str:
        return json.dumps(self.report())


class ScalarLogger:
    """Minimal scalar logger: in-memory history + optional JSONL file
    (the reference's train_losses/val_losses lists, trainer.py:28-30,
    generalized)."""

    def __init__(self, path: Optional[str] = None):
        self.history: Dict[str, list] = {}
        self.path = path
        if path:
            Path(path).parent.mkdir(parents=True, exist_ok=True)
            self._f = open(path, "a")
        else:
            self._f = None

    def log(self, step: int, **scalars):
        rec = {"step": step}
        for k, v in scalars.items():
            v = float(v)
            rec[k] = v
            self.history.setdefault(k, []).append((step, v))
        if self._f:
            self._f.write(json.dumps(rec) + "\n")
            self._f.flush()

    def close(self):
        if self._f:
            self._f.close()
