"""Gaussian scene state: a fixed-capacity slot pool as an immutable pytree.

Reference semantics: `/root/reference/src/core/gaussian_model.py` — parameters
`_xyz/_features_dc/_features_rest/_scaling/_rotation/_opacity` with exp/log
scaling, sigmoid/logit opacity and L2-normalized wxyz quaternions
(gaussian_model.py:19-40), `create_from_pcd` (:42-76), `create_from_random`
(:78-98), covariance Sigma = R diag(sigma^2) R^T (:200-207) and densification
stat buffers (:29-31).

Redesign: instead of the reference's concat/boolean-index tensor
surgery (gaussian_model.py:181-236), which changes shapes every densify step,
we keep a *static-capacity* slot pool with an `alive` mask so every train step
compiles once.  Split/clone/prune are masked scatters into free slots
(see `train/density.py`); capacity growth is a rare host-driven re-pad.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from .. import struct

from .transforms import build_covariance_3d, inverse_sigmoid, normalize_quat, quat_to_rotmat

SH_REST = 15  # degree<=3 => 16 coeffs per channel, 1 DC + 15 rest


@struct.dataclass
class Gaussians:
    """All arrays have leading dim = capacity C; `alive` masks real points."""

    xyz: jnp.ndarray            # [C,3]
    features_dc: jnp.ndarray    # [C,1,3]
    features_rest: jnp.ndarray  # [C,15,3]
    scaling: jnp.ndarray        # [C,3] log-sigma
    rotation: jnp.ndarray       # [C,4] wxyz quaternion (unnormalized storage)
    opacity: jnp.ndarray        # [C,1] logit
    alive: jnp.ndarray          # [C] bool
    # densification statistics (reference gaussian_model.py:29-31; accumulated
    # view-space gradient norms per the canonical-3DGS intent, SURVEY §2.2)
    xyz_gradient_accum: jnp.ndarray  # [C]
    denom: jnp.ndarray               # [C]
    max_radii2D: jnp.ndarray         # [C]

    # ---- derived quantities (activations, gaussian_model.py:34-40) ----
    @property
    def get_xyz(self) -> jnp.ndarray:
        return self.xyz

    @property
    def get_scaling(self) -> jnp.ndarray:
        return jnp.exp(self.scaling)

    @property
    def get_rotation(self) -> jnp.ndarray:
        return normalize_quat(self.rotation)

    @property
    def get_opacity(self) -> jnp.ndarray:
        return jax.nn.sigmoid(self.opacity)

    @property
    def get_features(self) -> jnp.ndarray:
        """[C,16,3] = concat(dc, rest) (gaussian_model.py:106-111)."""
        return jnp.concatenate([self.features_dc, self.features_rest], axis=1)

    @property
    def get_covariance(self) -> jnp.ndarray:
        return build_covariance_3d(self.get_scaling, self.rotation)

    @property
    def capacity(self) -> int:
        return int(self.xyz.shape[0])

    def num_alive(self) -> jnp.ndarray:
        return jnp.sum(self.alive.astype(jnp.int32))

    def params(self) -> dict:
        """The trainable-leaf subtree (what the optimizer updates)."""
        return {
            "xyz": self.xyz,
            "features_dc": self.features_dc,
            "features_rest": self.features_rest,
            "scaling": self.scaling,
            "rotation": self.rotation,
            "opacity": self.opacity,
        }

    def with_params(self, p: dict) -> "Gaussians":
        return self.replace(xyz=p["xyz"], features_dc=p["features_dc"],
                            features_rest=p["features_rest"], scaling=p["scaling"],
                            rotation=p["rotation"], opacity=p["opacity"])


def _empty(capacity: int) -> dict:
    return dict(
        xyz=jnp.zeros((capacity, 3), jnp.float32),
        features_dc=jnp.zeros((capacity, 1, 3), jnp.float32),
        features_rest=jnp.zeros((capacity, SH_REST, 3), jnp.float32),
        scaling=jnp.full((capacity, 3), -10.0, jnp.float32),  # tiny sigma for dead slots
        rotation=jnp.tile(jnp.array([[1.0, 0, 0, 0]], jnp.float32), (capacity, 1)),
        opacity=jnp.full((capacity, 1), -10.0, jnp.float32),  # ~0 opacity for dead slots
        alive=jnp.zeros((capacity,), bool),
        xyz_gradient_accum=jnp.zeros((capacity,), jnp.float32),
        denom=jnp.zeros((capacity,), jnp.float32),
        max_radii2D=jnp.zeros((capacity,), jnp.float32),
    )


def _fill(base: dict, n: int, **arrays) -> Gaussians:
    for name, arr in arrays.items():
        base[name] = base[name].at[:n].set(arr)
    base["alive"] = base["alive"].at[:n].set(True)
    return Gaussians(**base)


def create_from_random(key: jax.Array, num_points: int, scene_extent: float = 1.0,
                       capacity: Optional[int] = None) -> Gaussians:
    """Random init (reference gaussian_model.py:78-98): xyz uniform in
    +-extent, DC features uniform [0,1), sigma = 0.02*extent, random unit
    quaternions, opacity logit -2.0."""
    capacity = capacity or num_points
    assert capacity >= num_points
    k1, k2, k3 = jax.random.split(key, 3)
    xyz = (jax.random.uniform(k1, (num_points, 3)) - 0.5) * (2.0 * scene_extent)
    features_dc = jax.random.uniform(k2, (num_points, 1, 3))
    scaling = jnp.full((num_points, 3), math.log(0.02 * scene_extent), jnp.float32)
    rotation = normalize_quat(jax.random.normal(k3, (num_points, 4)))
    opacity = jnp.full((num_points, 1), -2.0, jnp.float32)
    return _fill(_empty(capacity), num_points, xyz=xyz, features_dc=features_dc,
                 scaling=scaling, rotation=rotation, opacity=opacity)


def create_from_pcd(points: np.ndarray, colors: Optional[np.ndarray] = None,
                    spatial_lr_scale: float = 1.0,
                    capacity: Optional[int] = None) -> Gaussians:
    """Point-cloud init (reference gaussian_model.py:42-76): DC features = raw
    colors (the renderer sigmoids them), sigma = 0.01*extent*lr_scale,
    random unit quaternions, opacity 0.5 (stored as logit)."""
    points = np.asarray(points, np.float32)
    if points.size == 0:
        raise ValueError("No points found in the point cloud.")
    n = points.shape[0]
    capacity = capacity or n
    assert capacity >= n
    if colors is None:
        colors = np.ones((n, 3), np.float32)
    extent = float((points.max(0) - points.min(0)).mean())
    base_scale = 0.01 * max(extent, 1e-2) * spatial_lr_scale
    rng = np.random.default_rng(0)
    rotation = rng.standard_normal((n, 4)).astype(np.float32)
    rotation /= np.linalg.norm(rotation, axis=-1, keepdims=True)
    opacity_logit = float(np.log(0.5 / 0.5))  # sigmoid^-1(0.5) = 0
    return _fill(
        _empty(capacity), n,
        xyz=jnp.asarray(points),
        features_dc=jnp.asarray(colors, dtype=jnp.float32)[:, None, :],
        scaling=jnp.full((n, 3), math.log(base_scale), jnp.float32),
        rotation=jnp.asarray(rotation),
        opacity=jnp.full((n, 1), opacity_logit, jnp.float32),
    )


def reset_opacity(g: Gaussians, new_opacity: float = 0.01) -> Gaussians:
    """Clamp alive opacities DOWN to logit(new_opacity)
    (gaussian_model.py:210-216 intent; canonical 3DGS uses
    min(opacity, 0.01) — the reset must never RAISE a nearly-transparent
    splat back above the prune threshold, which the reference's set-all
    form would)."""
    val = float(np.clip(new_opacity, 1e-4, 1 - 1e-4))
    logit = math.log(val / (1 - val))
    new = jnp.where(g.alive[:, None], jnp.minimum(g.opacity, logit),
                    g.opacity)
    return g.replace(opacity=new)


def compact(g: Gaussians, capacity: Optional[int] = None,
            margin: float = 1.25) -> Gaussians:
    """Pack alive slots to the front and shrink the static pool (load-time /
    inference).  Per-Gaussian stage cost (projection, pack gathers) scales
    with CAPACITY, not live count, so a checkpoint written mid-growth can sit
    at low occupancy and tax every render (tex30k: 167,714 alive in a 2^19
    pool = 32% occupancy; compacting to 2^18 halves the dead-slot overhead).
    Rendered output is identical — dead slots have ~0 opacity and emit
    nothing.  Host-side (numpy gather); not jittable, call once at load.
    The CUDA reference stack sizes its buffers to the live count every
    densify, so it never pays this; the static-pool answer is one compaction
    at the training/inference boundary."""
    alive = np.asarray(g.alive)
    idx = np.flatnonzero(alive)
    n = int(len(idx))
    if capacity is None:
        # the smaller of: next pow2 over margin*n (small scenes), or a
        # 256-aligned 1.15*n (large scenes, where pow2 rounding wastes up
        # to 2x in per-capacity stage cost)
        pow2 = 1 << max(int(np.ceil(np.log2(max(n * margin, 2.0)))), 1)
        aligned = max(-(-int(n * 1.15) // 256) * 256, 256)
        capacity = min(pow2, aligned) if aligned >= n else pow2
    assert capacity >= n, (capacity, n)
    base = _empty(capacity)
    fields = dict(
        xyz=np.asarray(g.xyz)[idx],
        features_dc=np.asarray(g.features_dc)[idx],
        features_rest=np.asarray(g.features_rest)[idx],
        scaling=np.asarray(g.scaling)[idx],
        rotation=np.asarray(g.rotation)[idx],
        opacity=np.asarray(g.opacity)[idx],
        xyz_gradient_accum=np.asarray(g.xyz_gradient_accum)[idx],
        denom=np.asarray(g.denom)[idx],
        max_radii2D=np.asarray(g.max_radii2D)[idx],
    )
    return _fill(base, n, **{k: jnp.asarray(v) for k, v in fields.items()})


def scene_extent_of(g: Gaussians) -> jnp.ndarray:
    """Mean axis range of alive points (gaussian_model.py:61-62 heuristic)."""
    big = jnp.where(g.alive[:, None], g.xyz, -jnp.inf)
    small = jnp.where(g.alive[:, None], g.xyz, jnp.inf)
    return (big.max(0) - small.min(0)).mean()
