"""Configuration system: flat dataclass + YAML (nested or flat) loader.

Mirrors the reference surface (`/root/reference/config/config.py:33-95` and
`config/default.yaml:1-51`) with the nested-YAML mapping fixed (reference bug
B15: `TrainingConfig(**nested)` raised TypeError) and fields of this system
added (capacity/mesh/kernel knobs).  No import-time side effects (reference
bug B14).  The YAML reader is a small one for the subset `configs/*.yaml`
use (`parse_yaml`), so loading a config needs no third-party package.
"""

from __future__ import annotations

import dataclasses
import json
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import List, Optional


@dataclass
class TrainingConfig:
    """Flat hyperparameter surface (reference `config/config.py:33-67`)."""

    # -- data paths (reference config.py:37-38, default.yaml data:) --
    data_path: str = "data/scene"
    images_path: str = "images"
    sparse_path: str = "sparse/0"
    output_path: str = "output"

    # -- training (reference config.py:41-43, default.yaml training:) --
    # (the reference's generic `learning_rate` knob is dropped: it is unused
    # there too — the real surface is the per-group LRs below)
    iterations: int = 30000
    batch_size: int = 1
    eval_interval: int = 1000
    save_interval: int = 5000
    log_interval: int = 100

    # -- per-group learning rates (reference config.py:46-54) --
    position_lr_init: float = 0.00016
    position_lr_final: float = 0.0000016
    position_lr_delay_steps: int = 0
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 30000
    # Canonical 3DGS scales the position LR by the camera-rig extent
    # (graphdeco: xyz lr = position_lr_init * spatial_lr_scale), so position
    # steps are proportional to scene size.  Without it, positions
    # under-move and the optimizer compensates by inflating scales
    # (measured: splats balloon to the radius clamp on the 30k schedule).
    scale_position_lr_by_extent: bool = True
    feature_lr: float = 0.0025
    opacity_lr: float = 0.05
    scaling_lr: float = 0.005
    rotation_lr: float = 0.001

    # -- density control (reference config.py:57-60, default.yaml density_control:) --
    densify_from_iter: int = 500
    densify_until_iter: int = 15000
    densify_grad_threshold: float = 0.0002
    densify_interval: int = 100
    prune_opacity_threshold: float = 0.005
    prune_interval: int = 1000
    opacity_reset_interval: int = 3000  # canonical 3DGS cadence (reference leaves it unwired)
    percent_dense_split: float = 0.03   # split if mean sigma > 0.03 * extent (gaussian_model.py:137)
    percent_dense_clone: float = 0.01   # clone if mean sigma < 0.01 * extent (gaussian_model.py:166)
    # Canonical-3DGS big-point prunes, applied at densify events once
    # iteration > opacity_reset_interval (graphdeco train.py size_threshold
    # semantics): screen-size prune on the window's max 2D radius (pixels)
    # and world-size prune on max sigma as a fraction of the scene extent.
    # Measured necessity: without them a tail of splats balloons to the
    # radius_max clamp (25 tiles each at tile 32), overflowing the instance
    # stream and capping per-view quality on the 30k schedule.  0 disables.
    prune_max_screen_size: float = 20.0
    prune_max_world_size: float = 0.1
    # Gradient space for the densification statistic: "viewspace" accumulates
    # the canonical-3DGS viewspace (projected-mean) gradient norm scaled to
    # NDC units (0.5*max(H,W) * pixel grad) — the units densify_grad_threshold
    # = 2e-4 is calibrated for, and SURVEY §2.2's documented intent.  "world"
    # is the reference's literal (unwired) semantics, ||grad_xyz||; measured
    # to over-trigger cloning exponentially on long (30k) schedules.
    densify_grad_space: str = "viewspace"

    # -- rendering (reference config.py:63-64, default.yaml rendering:) --
    image_height: int = 800
    image_width: int = 800
    background_color: List[float] = field(default_factory=lambda: [0.0, 0.0, 0.0])
    tile_size: int = 16
    radius_min: float = 0.01
    radius_max: float = 50.0
    sh_degree: int = 3
    color_mode: str = "dc_sigmoid"  # "dc_sigmoid" (reference renderer.py:90) or "sh" (canonical 3DGS)
    sh_increase_interval: int = 1000  # progressive SH degree unlock (canonical 3DGS)
    antialias: bool = False          # mip-splatting 2D dilation + opacity compensation

    # -- loss (reference default.yaml loss:) --
    lambda_dssim: float = 0.2

    # -- per-camera exposure compensation (train/exposure.py; new) --
    use_exposure: bool = False
    exposure_lr: float = 1e-3

    # -- kernel path and parallelism knobs (new; no reference analog) --
    capacity: int = 2 ** 17          # Gaussian slot-pool capacity (static shape under jit)
    max_instances: int = 2 ** 20     # capacity of the (tile, depth)-key instance buffer
    gaussian_chunk: int = 256        # padding granule of the instance stream length
    max_dup_per_axis: int = 0        # 0 = exact bound from radius_max; >0 shrinks the candidate sort
    large_capacity: int = 0          # two-level binning's large-splat (span > 2x2) pool; 0 = capacity/8
    mesh_data: int = 1               # camera/data-parallel mesh axis size
    mesh_tile: int = 1               # tile-parallel mesh axis size
    shard_gauss_state: bool = False  # shard model+Adam state over the gauss axis (per-device memory ~C/n)
    ring_exchange: bool = False      # ring exchange of depth-rank-range segments (parallel/ring.py)
    ring_capacity: int = 0           # per-(band, range) ring segment rows; 0 = max_instances / n
    ring_reshard: bool = False       # ring v2: rank-reshard proj rows first (per-Gaussian stages at C/n)
    ring_local: bool = False         # ring v3 (gauss-sharded step): feed the ring the LOCAL gid block; O(C/n) activations
    ring_reshard_capacity: int = 0   # v3 reshard bucket rows per destination; 0 = 4x uniform mean
    verify_sharding: bool = True     # setup-time sharded-gradient parity self-check under a mesh
    # Automatic instance-stream sizing: the trainer grows max_instances 2x
    # on overflow/near-full occupancy and halves it after sustained low
    # occupancy (pack cost is linear in the static stream length).
    auto_max_instances: bool = True
    # K-step on-device training loop: 0 = auto (gcd of every event cadence,
    # so densify/prune/reset/log/eval/save land on window boundaries),
    # 1 = one host dispatch per step (the mesh paths always use 1).
    # Default 1; opt in with 0 where host dispatch idles the device (not
    # measured on a GPU yet).
    steps_per_call: int = 1
    # K-loop camera staging budget: the loop keeps the FULL train-camera
    # stack (incl. target images) device-resident; above this many MB the
    # trainer falls back to per-step dispatch instead of risking device OOM.
    loop_stage_budget_mb: int = 2048
    # Slot-compact the pool (and Adam moments) once the densify window
    # closes (population frozen; growth headroom becomes pure per-capacity
    # stage tax).
    # Fires at most once, only if it saves >= 25% of the pool.
    compact_after_densify: bool = True
    use_pallas: bool = True          # raster kernels vs pure-XLA golden path
    dtype: str = "float32"

    # -- system (reference config.py:67, default.yaml system:) --
    device: str = "gpu"
    seed: int = 0


# Mapping from nested YAML groups (reference default.yaml) to flat field names.
_NESTED_MAP = {
    ("data", "path"): "data_path",
    ("data", "images_path"): "images_path",
    ("data", "sparse_path"): "sparse_path",
    ("data", "output_path"): "output_path",
    ("training", "iterations"): "iterations",
    ("training", "batch_size"): "batch_size",
    ("training", "eval_interval"): "eval_interval",
    ("training", "save_interval"): "save_interval",
    ("training", "log_interval"): "log_interval",
    ("learning_rates", "feature"): "feature_lr",
    ("learning_rates", "opacity"): "opacity_lr",
    ("learning_rates", "scaling"): "scaling_lr",
    ("learning_rates", "rotation"): "rotation_lr",
    ("density_control", "densify_from_iter"): "densify_from_iter",
    ("density_control", "densify_until_iter"): "densify_until_iter",
    ("density_control", "densify_grad_threshold"): "densify_grad_threshold",
    ("density_control", "densify_interval"): "densify_interval",
    ("density_control", "prune_opacity_threshold"): "prune_opacity_threshold",
    ("density_control", "prune_interval"): "prune_interval",
    ("density_control", "opacity_reset_interval"): "opacity_reset_interval",
    ("density_control", "densify_grad_space"): "densify_grad_space",
    ("density_control", "prune_max_screen_size"): "prune_max_screen_size",
    ("density_control", "prune_max_world_size"): "prune_max_world_size",
    ("rendering", "image_height"): "image_height",
    ("rendering", "image_width"): "image_width",
    ("rendering", "background_color"): "background_color",
    ("rendering", "tile_size"): "tile_size",
    ("rendering", "sh_degree"): "sh_degree",
    ("rendering", "color_mode"): "color_mode",
    ("rendering", "antialias"): "antialias",
    ("loss", "lambda_dssim"): "lambda_dssim",
    ("training", "use_exposure"): "use_exposure",
    ("learning_rates", "exposure"): "exposure_lr",
    ("learning_rates", "scale_position_by_extent"): "scale_position_lr_by_extent",
    ("system", "device"): "device",
    ("system", "seed"): "seed",
    ("tpu", "capacity"): "capacity",
    ("tpu", "max_instances"): "max_instances",
    ("tpu", "gaussian_chunk"): "gaussian_chunk",
    ("tpu", "large_capacity"): "large_capacity",
    ("tpu", "max_dup_per_axis"): "max_dup_per_axis",
    ("tpu", "mesh_data"): "mesh_data",
    ("tpu", "mesh_tile"): "mesh_tile",
    ("tpu", "shard_gauss_state"): "shard_gauss_state",
    ("tpu", "ring_exchange"): "ring_exchange",
    ("tpu", "ring_reshard"): "ring_reshard",
    ("tpu", "ring_local"): "ring_local",
    ("tpu", "ring_reshard_capacity"): "ring_reshard_capacity",
    ("tpu", "ring_capacity"): "ring_capacity",
    ("tpu", "verify_sharding"): "verify_sharding",
    ("tpu", "steps_per_call"): "steps_per_call",
    ("tpu", "loop_stage_budget_mb"): "loop_stage_budget_mb",
    ("tpu", "compact_after_densify"): "compact_after_densify",
    ("tpu", "auto_max_instances"): "auto_max_instances",
    ("training", "steps_per_call"): "steps_per_call",
    ("tpu", "use_pallas"): "use_pallas",
}

# learning_rates.position is itself nested one more level.
_POSITION_LR_MAP = {
    "init": "position_lr_init",
    "final": "position_lr_final",
    "delay_mult": "position_lr_delay_mult",
    "delay_steps": "position_lr_delay_steps",
    "max_steps": "position_lr_max_steps",
}


def _flatten_yaml(data: dict) -> dict:
    """Accept either a flat dict of field names or the reference's nested layout."""
    field_names = {f.name for f in dataclasses.fields(TrainingConfig)}
    flat: dict = {}
    for key, value in data.items():
        if key in field_names and not isinstance(value, dict):
            flat[key] = value
        elif isinstance(value, dict):
            for sub, subval in value.items():
                if key == "learning_rates" and sub == "position" and isinstance(subval, dict):
                    for k2, v2 in subval.items():
                        if k2 in _POSITION_LR_MAP:
                            flat[_POSITION_LR_MAP[k2]] = v2
                elif (key, sub) in _NESTED_MAP:
                    flat[_NESTED_MAP[(key, sub)]] = subval
                elif sub in field_names:
                    flat[sub] = subval
        # silently ignore unknown scalar keys (forward compat)
    return flat


# Implicit scalar types as YAML 1.1 (and so PyYAML's safe_load) resolves
# them: "1e-5" without a dot stays a string, "yes"/"off" are booleans.
_BOOL = {v: True for v in ("yes", "Yes", "YES", "true", "True", "TRUE",
                            "on", "On", "ON")}
_BOOL.update({v: False for v in ("no", "No", "NO", "false", "False",
                                  "FALSE", "off", "Off", "OFF")})
_NULL = ("", "~", "null", "Null", "NULL")
_INT = re.compile(r"[-+]?(0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"[-+]?([0-9][0-9_]*)?\.[0-9_]*([eE][-+][0-9]+)?$")
_INF = re.compile(r"([-+]?)\.(inf|Inf|INF)$")
_NAN = re.compile(r"\.(nan|NaN|NAN)$")


def _strip_comment(line: str) -> str:
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "\"'":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def _scalar(text: str):
    text = text.strip()
    if text[:1] == '"':
        return json.loads(text)
    if text[:1] == "'":
        return text[1:-1].replace("''", "'")
    if text[:1] == "[":
        inner = text[1:-1].strip()
        return [_scalar(v) for v in inner.split(",")] if inner else []
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _FLOAT.match(text) and text not in (".", "+.", "-."):
        return float(text.replace("_", ""))
    m = _INF.match(text)
    if m:
        return float(m.group(1) + "inf")
    if _NAN.match(text):
        return float("nan")
    return text


def parse_yaml(text: str) -> dict:
    """Parse the YAML subset the configs use: nested block mappings by
    indentation, plain / quoted scalars, flow lists and comments.  Anything
    else (block sequences, anchors, multi-line scalars) raises."""
    root: dict = {}
    stack = [(-1, root)]                 # (indent, mapping)
    for n, raw in enumerate(text.splitlines(), 1):
        line = _strip_comment(raw).rstrip()
        if not line.strip():
            continue
        indent = len(line) - len(line.lstrip(" "))
        body = line.strip()
        key, sep, rest = body.partition(":")
        if (not sep or body.startswith(("-", "&", "*", "!", "{", "|", ">"))
                or (rest and not rest[0].isspace())):
            raise ValueError(f"unsupported YAML at line {n}: {raw!r}")
        while indent <= stack[-1][0]:
            stack.pop()
        mapping = stack[-1][1]
        key = _scalar(key)
        if rest.strip():
            mapping[key] = _scalar(rest)
        else:                            # a mapping follows (or null)
            child: dict = {}
            stack.append((indent, child))
            mapping[key] = child
    return _empty_to_none(root)


def _empty_to_none(d: dict) -> dict:
    return {k: (_empty_to_none(v) or None) if isinstance(v, dict) else v
            for k, v in d.items()}


def _dump_scalar(v) -> str:
    if isinstance(v, bool) or v is None:
        return {True: "true", False: "false", None: "null"}[v]
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_dump_scalar(x) for x in v) + "]"
    if isinstance(v, str):
        return json.dumps(v)
    return repr(v)


class ConfigManager:
    """YAML <-> TrainingConfig (reference `config/config.py:69-95`, B15 fixed)."""

    @staticmethod
    def load_from_yaml(config_path: str) -> TrainingConfig:
        data = parse_yaml(Path(config_path).read_text(encoding="utf-8"))
        return TrainingConfig(**_flatten_yaml(data))

    @staticmethod
    def save_to_yaml(config: TrainingConfig, config_path: str) -> None:
        Path(config_path).parent.mkdir(parents=True, exist_ok=True)
        lines = [f"{k}: {_dump_scalar(v)}"
                 for k, v in dataclasses.asdict(config).items()]
        Path(config_path).write_text("\n".join(lines) + "\n",
                                     encoding="utf-8")

    @staticmethod
    def get_default_config() -> TrainingConfig:
        return TrainingConfig()
