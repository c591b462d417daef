"""Adaptive density control under static shapes (jit-safe slot-pool surgery).

Reference semantics (SURVEY.md §2.2, `/root/reference/src/core/gaussian_model.py`
and `src/core/optimizer.py:34-88`):
  * split  (gaussian_model.py:130-156): candidates with ||grad_xyz|| > tau and
    mean(sigma) > 0.03*extent are replaced by TWO children offset
    +-0.5*mean(sigma) along the rotated principal axis R[:,:,0], child scale
    0.75*sigma (stored as log), same rotation/features, opacity logit clamped
    to +-6; the parent is removed (net +k for k candidates).
  * clone  (gaussian_model.py:159-179): candidates with ||grad_xyz|| > tau and
    mean(sigma) < 0.01*extent get one appended copy jittered by
    N(0,1)*0.5*mean(sigma); the original persists.
  * prune  (optimizer.py:64-66): keep opacity > threshold.
  * cadence (optimizer.py:39-41): densify_from_iter <= it <= densify_until_iter
    and it % densify_interval == 0.

Redesign: the reference's concat/boolean-index reparameterization
changes array shapes; here everything is a masked scatter into free slots of
the fixed-capacity pool, so the whole operation jit-compiles once.  Children
that exceed capacity are dropped (tracked via the returned count).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ..config import TrainingConfig
from ..core.gaussians import Gaussians
from ..core.transforms import quat_to_rotmat


class DensifyResult(NamedTuple):
    gaussians: Gaussians
    changed_slots: jnp.ndarray  # [C] bool: slots whose Adam state must reset
    n_split: jnp.ndarray
    n_clone: jnp.ndarray
    n_pruned: jnp.ndarray
    n_dropped: jnp.ndarray      # children lost to capacity overflow


def should_densify(iteration: int, config: TrainingConfig) -> bool:
    """Host-side cadence check (reference optimizer.py:39-41)."""
    return (config.densify_from_iter <= iteration <= config.densify_until_iter
            and iteration % config.densify_interval == 0)


def accumulate_grad_stats(g: Gaussians, grad_norm: jnp.ndarray,
                          radii: jnp.ndarray, visible: jnp.ndarray) -> Gaussians:
    """Accumulate a per-Gaussian positional-gradient norm [C] into the stat
    buffers (reference buffers gaussian_model.py:29-31; accumulation is the
    canonical 3DGS pattern the reference declares but never wires — SURVEY
    §2.2).  Callers pass `densify_stat_norm(...)`, which selects viewspace
    (canonical) or world (reference-literal) gradients per config."""
    vis = visible.astype(jnp.float32)
    return g.replace(
        xyz_gradient_accum=g.xyz_gradient_accum + grad_norm * vis,
        denom=g.denom + vis,
        max_radii2D=jnp.maximum(g.max_radii2D, radii * vis),
    )


def densify_stat_norm(config: TrainingConfig, xyz_grad: jnp.ndarray,
                      vs_grad: jnp.ndarray, height: int,
                      width: int) -> jnp.ndarray:
    """The densification statistic [C] per `config.densify_grad_space`:

    * "viewspace" (default): ||dL/d means2D|| scaled by 0.5*max(H,W) — the
      canonical-3DGS NDC-unit statistic its tau = 2e-4 default was tuned
      for (pixel coords x_pix = (x_ndc+1) * W/2, so dL/dx_ndc =
      dL/dx_pix * W/2).  Measured: the world-space statistic over-triggers
      cloning exponentially on the 30k schedule (clone counts x1.4 per
      densify event by it ~5000).
    * "world": the reference's literal xyz.grad norm
      (gaussian_model.py:133-136)."""
    if config.densify_grad_space == "world":
        return jnp.linalg.norm(xyz_grad, axis=-1)
    return (jnp.linalg.norm(vs_grad, axis=-1)
            * (0.5 * float(max(height, width))))


def size_mask_quantile(g: Gaussians, percent_dense: float) -> jnp.ndarray:
    """Quantile-based large-Gaussian mask (reference
    `DensityController._get_size_mask`, optimizer.py:81-88: size > the
    percent_dense quantile of mean sigmas; alive-only here)."""
    size = g.get_scaling.mean(axis=-1)
    masked = jnp.where(g.alive, size, jnp.nan)
    th = jnp.nanquantile(masked, percent_dense)
    return g.alive & (size > th)


def should_prune(iteration: int, config: TrainingConfig) -> bool:
    """Standalone prune cadence (reference default.yaml:35 `prune_interval`).

    Runs only when a densify pass (which already prunes) is not scheduled at
    this iteration, so the two cadences compose without double work."""
    return (config.prune_interval > 0
            and iteration % config.prune_interval == 0
            and not should_densify(iteration, config))


def prune_only(g: Gaussians, config: TrainingConfig) -> Tuple[Gaussians, jnp.ndarray]:
    """Opacity-only prune (reference optimizer.py:64-66 keep-mask, without the
    split/clone surgery).  Returns (gaussians, n_pruned)."""
    opacity_sig = jax.nn.sigmoid(g.opacity[:, 0])
    keep = opacity_sig > config.prune_opacity_threshold
    n_pruned = (g.alive & ~keep).sum()
    return g.replace(alive=g.alive & keep), n_pruned


def densify_and_prune(g: Gaussians, key: jax.Array, scene_extent,
                      config: TrainingConfig,
                      size_prune=False) -> DensifyResult:
    """`size_prune` (traced bool OK): additionally prune big points —
    screen-size (window max 2D radius > prune_max_screen_size px) and
    world-size (max sigma > prune_max_world_size * extent) — the canonical
    3DGS rule active once iteration > opacity_reset_interval (the trainer
    passes that condition).  Traced so the jitted step never recompiles."""
    C = g.capacity
    # Mean accumulated gradient norm (visible steps only).
    grad = g.xyz_gradient_accum / jnp.maximum(g.denom, 1.0)
    sigma = g.get_scaling                       # [C,3]
    size = sigma.mean(axis=-1)                  # [C]
    tau = config.densify_grad_threshold

    split_mask = g.alive & (grad > tau) & (size > config.percent_dense_split * scene_extent)
    clone_mask = g.alive & (grad > tau) & (size < config.percent_dense_clone * scene_extent)

    n_split = split_mask.sum()
    n_clone = clone_mask.sum()

    # Parents of splits die; their slots become reusable immediately.
    alive_after_kill = g.alive & ~split_mask
    free_idx = jnp.nonzero(~alive_after_kill, size=C, fill_value=C)[0]  # ascending
    n_free = (~alive_after_kill).sum()

    split_rank = jnp.cumsum(split_mask) - 1     # [C], valid where split_mask
    clone_rank = jnp.cumsum(clone_mask) - 1

    def take_free(rank):
        """free slot for allocation-order `rank`; C (=dropped) if exhausted."""
        ok = (rank >= 0) & (rank < n_free)
        return jnp.where(ok, free_idx[jnp.clip(rank, 0, C - 1)], C)

    slot_child1 = take_free(jnp.where(split_mask, split_rank, -1))
    slot_child2 = take_free(jnp.where(split_mask, n_split + split_rank, -1))
    slot_clone = take_free(jnp.where(clone_mask, 2 * n_split + clone_rank, -1))

    # ---- child parameter construction (at parent rows; scattered below) ----
    R = quat_to_rotmat(g.get_rotation)          # [C,3,3]
    mean_sig = sigma.mean(axis=-1, keepdims=True)
    offset = R[:, :, 0] * (mean_sig * 0.5)      # principal-axis offset
    split_xyz1 = g.xyz - offset
    split_xyz2 = g.xyz + offset
    split_scaling = jnp.log(jnp.maximum(sigma * 0.75, 1e-12))
    split_opacity = jnp.clip(g.opacity, -6.0, 6.0)

    jitter = jax.random.normal(key, g.xyz.shape) * (mean_sig * 0.5)
    clone_xyz = g.xyz + jitter

    def scatter(dst, slots, src):
        return dst.at[slots].set(src, mode="drop")

    new = dict(xyz=g.xyz, features_dc=g.features_dc,
               features_rest=g.features_rest, scaling=g.scaling,
               rotation=g.rotation, opacity=g.opacity)

    for slots, xyz_src, scaling_src, opacity_src in (
            (slot_child1, split_xyz1, split_scaling, split_opacity),
            (slot_child2, split_xyz2, split_scaling, split_opacity),
            (slot_clone, clone_xyz, g.scaling, g.opacity)):
        new["xyz"] = scatter(new["xyz"], slots, xyz_src)
        new["features_dc"] = scatter(new["features_dc"], slots, g.features_dc)
        new["features_rest"] = scatter(new["features_rest"], slots, g.features_rest)
        new["scaling"] = scatter(new["scaling"], slots, scaling_src)
        new["rotation"] = scatter(new["rotation"], slots, g.rotation)
        new["opacity"] = scatter(new["opacity"], slots, opacity_src)

    # Non-candidates carry slot C, which mode="drop" discards.
    alive = alive_after_kill
    for slots in (slot_child1, slot_child2, slot_clone):
        alive = alive.at[slots].set(True, mode="drop")

    # ---- prune by opacity (reference optimizer.py:64-66; threshold from
    # config like reference default.yaml:34 `prune_opacity_threshold`) ----
    opacity_sig = jax.nn.sigmoid(new["opacity"][:, 0])
    keep = opacity_sig > config.prune_opacity_threshold
    # ---- canonical big-point prunes (see docstring), gated on the traced
    # `size_prune` flag.  Screen-size uses the PRE-surgery window max radius
    # and exempts slots just written (their buffer rows are stale values of
    # the previous occupant); world-size uses the post-surgery scales. ----
    newly = jnp.zeros((C,), bool)
    for slots in (slot_child1, slot_child2, slot_clone):
        newly = newly.at[slots].set(True, mode="drop")
    size_keep = jnp.ones((C,), bool)
    if config.prune_max_screen_size > 0:
        size_keep &= newly | (g.max_radii2D <= config.prune_max_screen_size)
    if config.prune_max_world_size > 0:
        sig_new = jnp.exp(new["scaling"]).max(axis=-1)
        size_keep &= sig_new <= config.prune_max_world_size * scene_extent
    keep = keep & (size_keep | ~jnp.asarray(size_prune, bool))
    n_pruned = (alive & ~keep).sum()
    alive_final = alive & keep

    changed = (alive_final != g.alive)
    # also reset moments for any slot that got a child scattered into it
    for slots in (slot_child1, slot_child2, slot_clone):
        changed = changed.at[slots].set(True, mode="drop")

    n_children_wanted = 2 * n_split + n_clone
    n_alloc = ((slot_child1 < C).sum() + (slot_child2 < C).sum()
               + (slot_clone < C).sum())
    n_dropped = n_children_wanted - n_alloc

    g_new = g.replace(
        xyz=new["xyz"], features_dc=new["features_dc"],
        features_rest=new["features_rest"], scaling=new["scaling"],
        rotation=new["rotation"], opacity=new["opacity"],
        alive=alive_final,
        xyz_gradient_accum=jnp.zeros_like(g.xyz_gradient_accum),
        denom=jnp.zeros_like(g.denom),
        max_radii2D=jnp.zeros_like(g.max_radii2D),
    )
    return DensifyResult(g_new, changed, n_split, n_clone, n_pruned, n_dropped)
