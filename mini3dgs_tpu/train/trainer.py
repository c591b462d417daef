"""Training orchestration.

Implements the reference's documented (but stubbed) trainer pipelines
(`/root/reference/src/train/trainer.py:32-89`): setup = dataset -> gaussians
from point cloud -> renderer -> optimizer/loss -> scene extent; train = sample
camera -> render -> loss -> backward -> step -> periodic densify / validate /
checkpoint; plus save/load checkpoint and scene-extent computation.

Design: a functional `TrainState` pytree and a single jitted
`train_step` with donated buffers (no per-step host sync); densification is a
second jitted program (same shapes, so each compiles exactly once); opacity
reset every `opacity_reset_interval` iterations (canonical 3DGS cadence —
the reference declares the op but never wires a cadence, SURVEY §2.2).
"""

from __future__ import annotations

import time
from functools import partial
from typing import Callable, Dict, List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from .. import struct

from ..config import TrainingConfig
from ..core.camera import Camera
from ..core.gaussians import Gaussians, reset_opacity, scene_extent_of
from ..core.loss import gaussian_loss
from ..ops.renderer import RenderSettings, render
from . import density
from .optimizer import make_optimizer, reset_adam_slots


@struct.dataclass
class TrainState:
    gaussians: Gaussians
    opt_state: tuple
    step: jnp.ndarray  # int32 scalar
    # optional per-camera exposure compensation (train/exposure.py)
    exposure: Optional[jnp.ndarray] = None       # [n_cams, 3, 4]
    exp_opt_state: Optional[tuple] = None


def create_train_state(gaussians: Gaussians, config: TrainingConfig,
                       n_cameras: int = 0) -> TrainState:
    tx = make_optimizer(config)
    opt_state = tx.init(gaussians.params())
    exposure = exp_opt = None
    if config.use_exposure and n_cameras > 0:
        from .exposure import init_exposure
        exposure = init_exposure(n_cameras)
        exp_opt = _exposure_optimizer(config).init(exposure)
    return TrainState(gaussians=gaussians, opt_state=opt_state,
                      step=jnp.int32(0), exposure=exposure,
                      exp_opt_state=exp_opt)


def _exposure_optimizer(config: TrainingConfig):
    import optax
    return optax.adam(config.exposure_lr)


def make_step_body(config: TrainingConfig,
                   settings: RenderSettings,
                   sh_degree: Optional[int] = None) -> Callable:
    """Un-jitted single-step body (render -> loss -> grad -> adam -> stats),
    shared by `make_train_step` (one jitted dispatch per step) and
    `make_train_loop` (K steps per dispatch inside one lax.fori_loop).

    `sh_degree` overrides the settings' degree (used by the trainer's
    progressive SH unlock — canonical 3DGS raises the active degree every
    `sh_increase_interval` iterations)."""
    tx = make_optimizer(config)
    if sh_degree is not None:
        settings = settings.replace(sh_degree=sh_degree)

    tx_exp = _exposure_optimizer(config)

    def loss_fn(params, exposure, probe, g: Gaussians, camera: Camera,
                cam_idx):
        g = g.with_params(params)
        out = render(g, camera, settings, means2d_probe=probe)
        image = out["image"]
        if exposure is not None:
            from .exposure import apply_exposure
            image = apply_exposure(exposure[cam_idx], image)
        total, parts = gaussian_loss(image, camera.image,
                                     config.lambda_dssim)
        parts = dict(parts)
        parts["render_drops"] = out["n_dropped"]
        parts["render_drops_large"] = out["n_dropped_large"]
        parts["render_instances"] = out["n_live"]
        parts["render_n_large"] = out["n_large"]
        return total, (parts, out["visibility_filter"], out["radii"])

    def train_step(state: TrainState, camera: Camera,
                   cam_idx=jnp.int32(0)):
        params = state.gaussians.params()
        # zero probe on the projected means: its gradient is the canonical
        # viewspace densification statistic (density.densify_stat_norm)
        probe = jnp.zeros((state.gaussians.capacity, 2), jnp.float32)
        argnums = (0, 1, 2) if state.exposure is not None else (0, 2)
        grads_all, (parts, visible, radii) = jax.grad(
            loss_fn, argnums=argnums,
            has_aux=True, allow_int=False)(
                params, state.exposure, probe, state.gaussians, camera,
                cam_idx)
        if state.exposure is not None:
            grads, exp_grads, vs_grads = grads_all
        else:
            (grads, vs_grads), exp_grads = grads_all, None
        # Dead slots must not drift: zero their grads (their Adam moments are
        # zeroed at allocation, so updates stay exactly 0).
        alive = state.gaussians.alive

        def mask_dead(x):
            return jnp.where(alive.reshape((-1,) + (1,) * (x.ndim - 1)), x, 0.0)

        grads = jax.tree.map(mask_dead, grads)
        updates, opt_state = tx.update(grads, state.opt_state, params)
        params = jax.tree.map(lambda p, u: p + u, params, updates)
        g = state.gaussians.with_params(params)
        stat = density.densify_stat_norm(config, grads["xyz"], vs_grads,
                                         settings.image_height,
                                         settings.image_width)
        g = density.accumulate_grad_stats(g, stat, radii, visible)
        exposure, exp_opt = state.exposure, state.exp_opt_state
        if exposure is not None:
            exp_updates, exp_opt = tx_exp.update(exp_grads, exp_opt, exposure)
            exposure = exposure + exp_updates
        new_state = TrainState(gaussians=g, opt_state=opt_state,
                               step=state.step + 1, exposure=exposure,
                               exp_opt_state=exp_opt)
        metrics = dict(parts)
        metrics["n_visible"] = visible.sum()
        return new_state, metrics

    return train_step


def make_train_step(config: TrainingConfig,
                    settings: RenderSettings,
                    sh_degree: Optional[int] = None) -> Callable:
    """Jitted single train step with donated state buffers."""
    return jax.jit(make_step_body(config, settings, sh_degree),
                   donate_argnums=(0,))


def make_train_loop(config: TrainingConfig, settings: RenderSettings,
                    K: int, sh_degree: Optional[int] = None) -> Callable:
    """K-step on-device training loop: one host dispatch per K steps
    (for runtimes where per-step dispatch idles the device).

    Returns jitted `(state, cams_stacked, idx[K]) -> (state, metrics)`:
    `cams_stacked` is the FULL train-camera stack as one device-resident
    pytree (staged once per run — per-call traffic is only the [K] int32
    index vector), `idx` the per-step camera choices; the body runs the
    SAME step as make_train_step under `lax.fori_loop` with
    `dynamic_index_in_dim` camera selection, and metrics of the LAST step
    come back (the trainer aligns K with its log cadence).  Use only for
    windows with no densify/prune/reset/eval events strictly inside —
    GaussianTrainer picks K = gcd of every cadence so all events land on
    window boundaries."""
    body_fn = make_step_body(config, settings, sh_degree)

    @partial(jax.jit, donate_argnums=(0,))
    def loop_step(state: TrainState, cams_stacked: Camera, idx: jnp.ndarray):
        def sel(ci):
            return jax.tree.map(
                lambda x: jax.lax.dynamic_index_in_dim(x, ci, 0,
                                                       keepdims=False),
                cams_stacked)

        state, metrics = body_fn(state, sel(idx[0]), idx[0])

        def body(i, carry):
            st, prev = carry
            st, m = body_fn(st, sel(idx[i]), idx[i])
            # WINDOW MAX for the stream-health metrics (a transient overflow
            # or occupancy spike on an interior step must not hide behind
            # the last step's value — the auto-sizer reads these)
            for k in ("render_drops", "render_drops_large",
                      "render_instances", "render_n_large"):
                if k in m:
                    m[k] = jnp.maximum(m[k], prev[k])
            return st, m

        return jax.lax.fori_loop(1, K, body, (state, metrics))

    return loop_step


def make_densify_step(config: TrainingConfig) -> Callable:
    @jax.jit
    def densify_step(state: TrainState, key: jax.Array, scene_extent,
                     size_prune=False):
        result = density.densify_and_prune(state.gaussians, key, scene_extent,
                                           config, size_prune=size_prune)
        opt_state = reset_adam_slots(state.opt_state, result.changed_slots)
        # exposure state rides through unchanged: densification only touches
        # Gaussian slots, never the per-camera affines
        new_state = TrainState(gaussians=result.gaussians, opt_state=opt_state,
                               step=state.step, exposure=state.exposure,
                               exp_opt_state=state.exp_opt_state)
        stats = {"n_split": result.n_split, "n_clone": result.n_clone,
                 "n_pruned": result.n_pruned, "n_dropped": result.n_dropped,
                 "n_alive": result.gaussians.num_alive()}
        return new_state, stats

    return densify_step


def make_prune_step(config: TrainingConfig) -> Callable:
    """Standalone opacity prune at `prune_interval` cadence (reference
    default.yaml:35).  Newly-dead slots get their Adam moments zeroed so that
    masked (zero) grads produce exactly-zero updates from then on."""
    @jax.jit
    def prune_step(state: TrainState):
        g, n_pruned = density.prune_only(state.gaussians, config)
        newly_dead = state.gaussians.alive & ~g.alive
        opt_state = reset_adam_slots(state.opt_state, newly_dead)
        return state.replace(gaussians=g, opt_state=opt_state), n_pruned

    return prune_step


@jax.jit
def _reset_opacity_step(state: TrainState):
    return state.replace(gaussians=reset_opacity(state.gaussians, 0.01))


def compact_train_state(state: TrainState,
                        capacity: Optional[int] = None) -> TrainState:
    """Slot-compact a TrainState: alive Gaussians packed to the front,
    Adam moments gathered along, pool shrunk (core.gaussians.compact for
    the sizing policy).  Per-capacity covariance/projection math runs on
    every slot; once the densify window closes the population is frozen,
    so the headroom the pool held for growth is pure tax for the rest of
    the run.  Host-side
    and rare (once per run) — the recompile it causes is amortized like
    grow_capacity's."""
    from ..core.gaussians import compact

    g = state.gaussians
    C = g.capacity
    alive = np.asarray(g.alive)
    idx = np.flatnonzero(alive)
    n = int(len(idx))
    new_g = compact(g, capacity)
    newC = new_g.capacity

    def gather(x):
        if hasattr(x, "ndim") and x.ndim >= 1 and x.shape[0] == C:
            arr = np.asarray(x)
            out = np.zeros((newC,) + arr.shape[1:], arr.dtype)
            out[:n] = arr[idx]
            return jnp.asarray(out)
        return x

    opt_state = jax.tree.map(gather, state.opt_state)
    return TrainState(gaussians=new_g, opt_state=opt_state, step=state.step,
                      exposure=state.exposure,
                      exp_opt_state=state.exp_opt_state)


def grow_capacity(state: TrainState, new_capacity: int) -> TrainState:
    """Re-pad the slot pool (and Adam moments) to a larger static capacity.

    Host-driven and rare (occupancy-triggered), so the recompile it causes is
    amortized over thousands of steps — the static-shape answer to the
    reference's per-densify reallocation (SURVEY §7 hard part #3).
    """
    g = state.gaussians
    old = g.capacity
    assert new_capacity >= old

    def pad(x, fill=0.0):
        widths = [(0, new_capacity - old)] + [(0, 0)] * (x.ndim - 1)
        return jnp.pad(x, widths, constant_values=fill)

    new_g = Gaussians(
        xyz=pad(g.xyz),
        features_dc=pad(g.features_dc),
        features_rest=pad(g.features_rest),
        scaling=pad(g.scaling, -10.0),
        rotation=jnp.concatenate(
            [g.rotation, jnp.tile(jnp.array([[1.0, 0, 0, 0]], g.rotation.dtype),
                                  (new_capacity - old, 1))]),
        opacity=pad(g.opacity, -10.0),
        alive=pad(g.alive, False),
        xyz_gradient_accum=pad(g.xyz_gradient_accum),
        denom=pad(g.denom),
        max_radii2D=pad(g.max_radii2D),
    )

    def pad_moment(x):
        if hasattr(x, "ndim") and x.ndim >= 1 and x.shape[0] == old:
            return pad(x)
        return x

    # Layout contract with make_optimizer (optimizer.py): opt_state is a
    # tuple whose FIRST element is optax's ScaleByAdamState (mu/nu moment
    # pytrees over the Gaussians).  Any optimizer-chain reordering breaks
    # capacity growth at a distance — fail loudly with the expectation named
    # rather than padding the wrong leaf.
    adam = state.opt_state[0]
    if not (hasattr(adam, "mu") and hasattr(adam, "nu")):
        raise TypeError(
            "grow_capacity expects state.opt_state[0] to be optax's "
            "ScaleByAdamState (the scale_by_adam entry must stay first in "
            f"the make_optimizer chain); got {type(adam).__name__}")
    new_adam = adam._replace(mu=jax.tree.map(pad_moment, adam.mu),
                             nu=jax.tree.map(pad_moment, adam.nu))
    return TrainState(gaussians=new_g,
                      opt_state=(new_adam,) + tuple(state.opt_state[1:]),
                      step=state.step, exposure=state.exposure,
                      exp_opt_state=state.exp_opt_state)


class GaussianTrainer:
    """High-level orchestrator with the reference GaussianTrainer's surface
    (trainer.py:12-89): setup / train / train_step / validate /
    save_checkpoint / load_checkpoint / get_scene_extent."""

    def __init__(self, config: TrainingConfig,
                 settings: Optional[RenderSettings] = None):
        self.config = config
        self.settings = settings
        self.dataset = None
        self.gaussians: Optional[Gaussians] = None
        self.state: Optional[TrainState] = None
        self.iteration = 0
        self.scene_extent = 0.0
        self.train_losses: List[float] = []
        self.val_losses: List[float] = []
        self._train_steps = {}
        self._train_loops = {}      # (sh degree, K) -> jitted K-step loop
        self._cams_device = None    # device-resident stacked camera pytree
        self._occupancy_hist = []   # stream-occupancy samples (auto sizing)
        self._large_occ_hist = []   # large-pool occupancy samples (ditto)
        self._window_obs = []       # device-side per-step metric refs
        self._eval_renderers = {}
        self._densify_step = None
        self._key = jax.random.PRNGKey(config.seed)

    # ------------------------------------------------------------------
    def setup(self, dataset=None, gaussians: Optional[Gaussians] = None):
        """Reference trainer.py:32-43 pipeline."""
        from ..data.dataset import load_dataset
        if dataset is None and gaussians is None:
            dataset = load_dataset(self.config)
        self.dataset = dataset
        if gaussians is None:
            from ..core.gaussians import create_from_pcd
            points, colors = dataset.get_point_cloud()
            if self.config.color_mode == "sh" and colors is not None:
                # SH decode is rgb = C0*dc + 0.5 (core/sh.py); invert the DC
                # term so the initial render reproduces the pcd colors
                from ..core.sh import C0
                colors = (np.asarray(colors, np.float32) - 0.5) / C0
            cap = max(self.config.capacity, 1 << int(np.ceil(np.log2(max(len(points), 2)))))
            gaussians = create_from_pcd(points, colors, capacity=cap)
        self.gaussians = gaussians
        if self.settings is None:
            cam0 = self.train_cameras()[0]
            # Datasets whose GT images are composited onto a fixed background
            # (BlenderDataset.white_background) dictate the render background,
            # so training optimizes against a consistent target.
            bg = getattr(self.dataset, "bg_color", None)
            if bg is None:
                bg = self.config.background_color
            self.settings = RenderSettings(
                image_height=cam0.height, image_width=cam0.width,
                bg_color=jnp.asarray(bg, jnp.float32),
                tile_size=self.config.tile_size,
                radius_min=self.config.radius_min,
                radius_max=self.config.radius_max,
                use_pallas=self.config.use_pallas,
                max_instances=self.config.max_instances,
                gaussian_chunk=self.config.gaussian_chunk,
                max_dup_per_axis=self.config.max_dup_per_axis,
                large_capacity=self.config.large_capacity,
                ring=self.config.ring_exchange,
                ring_capacity=self.config.ring_capacity,
                ring_reshard=self.config.ring_reshard,
                ring_local=self.config.ring_local,
                ring_reshard_capacity=self.config.ring_reshard_capacity,
                color_mode=self.config.color_mode,
                antialias=self.config.antialias,
                sh_degree=0 if self.config.color_mode == "dc_sigmoid" else self.config.sh_degree)
        # Canonical scene extent (graphdeco getNerfppNorm): 1.1x the camera
        # rig's max distance from its mean center — the unit behind the
        # percent-dense densify thresholds, the world-size prune, AND the
        # spatial position-LR scaling.  The gaussian-cloud heuristic
        # (reference gaussian_model.py:61-62) is the no-camera fallback.
        if self.dataset is not None and getattr(self.dataset, "cameras", None):
            self.scene_extent = 1.1 * float(
                self.dataset.get_scene_info()["radius"])
        else:
            self.scene_extent = float(scene_extent_of(gaussians))
        if self.config.scale_position_lr_by_extent:
            import dataclasses
            e = self.scene_extent
            self.config = dataclasses.replace(
                self.config,
                position_lr_init=self.config.position_lr_init * e,
                position_lr_final=self.config.position_lr_final * e,
                scale_position_lr_by_extent=False)  # applied exactly once
        n_cams = len(self.train_cameras()) if self.dataset is not None else 0
        self.state = create_train_state(gaussians, self.config,
                                        n_cameras=n_cams)
        self._train_steps = {}  # active SH degree -> jitted step
        self._train_loops = {}
        self._cams_device = None
        self._densify_step = make_densify_step(self.config)
        self._prune_step = make_prune_step(self.config)
        # multi-device: (data, tile) mesh via parallel/sharded.py
        self.mesh = None
        if self.config.mesh_data * self.config.mesh_tile > 1:
            from ..parallel.mesh import make_mesh
            self.mesh = make_mesh(self.config.mesh_data, self.config.mesh_tile)
            if self.config.verify_sharding:
                # one-step oracle check of the sharded gradient reductions:
                # raises at setup if the shard_map transpose scaling ever
                # changes under a JAX upgrade (silent n-fold grad rescale)
                from ..parallel.sharded import verify_shard_grad_parity
                verify_shard_grad_parity(
                    self.config, self.mesh,
                    gauss_sharded=self.config.shard_gauss_state)
            if self.config.shard_gauss_state:
                # shard model + Adam state over the gauss axis: per-device
                # state memory ~C/n (SURVEY §2.5 TP)
                from ..parallel.sharded import (
                    make_gauss_sharded_densify_step, shard_train_state)
                self.state = shard_train_state(self.state, self.mesh)
                self._densify_step = make_gauss_sharded_densify_step(
                    self.config, self.mesh, self.state)

    def train_cameras(self) -> Sequence[Camera]:
        return self.dataset.get_train_cameras() if self.dataset else []

    def get_scene_extent(self) -> float:
        return float(scene_extent_of(self.state.gaussians))

    # ------------------------------------------------------------------
    def active_sh_degree(self) -> int:
        """Progressive SH unlock (canonical 3DGS: one band per interval)."""
        if self.settings.color_mode != "sh" or self.config.sh_increase_interval <= 0:
            return self.settings.sh_degree
        return min(self.iteration // self.config.sh_increase_interval,
                   self.config.sh_degree)

    def train_step(self, camera: Camera, cam_idx: int = 0) -> Dict[str, float]:
        """Single step (reference trainer.py:61-65).  On a multi-device mesh
        `camera` may be a batched camera pytree (leading dim = data axis)."""
        deg = self.active_sh_degree()
        if deg not in self._train_steps:
            if self.mesh is not None:
                from ..parallel.sharded import (make_gauss_sharded_train_step,
                                                make_sharded_train_step)
                settings = self.settings.replace(sh_degree=deg)
                if self.config.shard_gauss_state:
                    self._train_steps[deg] = make_gauss_sharded_train_step(
                        self.config, settings, self.mesh, self.state)
                else:
                    self._train_steps[deg] = make_sharded_train_step(
                        self.config, settings, self.mesh)
            else:
                self._train_steps[deg] = make_train_step(self.config,
                                                         self.settings, deg)
        batched_camera = camera.R.ndim == 3
        if self.mesh is not None and camera.R.ndim == 2:
            # replicate a single camera across the data axis
            n = self.mesh.shape["data"]
            camera = jax.tree.map(
                lambda x: jnp.broadcast_to(x[None], (n,) + x.shape)
                if x is not None else None, camera)
        if self.mesh is not None:
            if self.config.use_exposure:
                n = self.mesh.shape["data"]
                ci = jnp.asarray(cam_idx, jnp.int32).reshape(-1)
                if batched_camera and ci.shape[0] != n:
                    raise ValueError(
                        f"use_exposure with a batched camera needs an explicit "
                        f"per-shard cam_idx of length {n} (got {ci.shape[0]}): "
                        f"a scalar would silently train camera "
                        f"{int(ci[0])}'s exposure for every data shard")
                ci = jnp.broadcast_to(ci, (n,))
                self.state, metrics = self._train_steps[deg](
                    self.state, camera, ci)
            else:
                self.state, metrics = self._train_steps[deg](self.state, camera)
        else:
            self.state, metrics = self._train_steps[deg](
                self.state, camera, jnp.int32(cam_idx))
        # host-side mirror of state.step: int(state.step) would block on the
        # async dispatch every step
        self.iteration += 1
        return metrics

    def _loop_K(self) -> int:
        """Window length of the on-device K-step loop: the gcd of every
        event cadence (densify/prune/reset/log/eval/save/SH-unlock and the
        densify window edges), so every host-side event lands exactly on a
        window boundary and the windows' interiors are event-free.  1
        disables the loop (mesh paths and steps_per_call=1)."""
        import math as _math
        if self.mesh is not None or self.config.steps_per_call == 1:
            return 1
        c = self.config
        g = 0
        for v in (c.log_interval, c.densify_interval, c.prune_interval,
                  c.opacity_reset_interval, c.eval_interval, c.save_interval,
                  c.sh_increase_interval, c.densify_from_iter,
                  c.densify_until_iter):
            if v and v > 0:
                g = _math.gcd(g, int(v))
        if self.config.steps_per_call > 1:
            # explicit K must still divide every cadence
            if g % self.config.steps_per_call == 0:
                return self.config.steps_per_call
            print(f"[train] steps_per_call={self.config.steps_per_call} does "
                  f"not divide the event-cadence gcd {g}; using K={g} so "
                  f"densify/log/eval events stay on window boundaries",
                  flush=True)  # ADVICE r4: never silently override
            return g
        return g

    def _run_loop_window(self, idxs, cams) -> Dict:
        """Dispatch one K-step on-device window (make_train_loop)."""
        deg = self.active_sh_degree()
        if self._cams_device is None:
            sel = [c.replace(uid=0, image_name="") for c in cams]
            self._cams_device = jax.tree.map(lambda *x: jnp.stack(x), *sel)
        key = (deg, len(idxs))
        if key not in self._train_loops:
            self._train_loops[key] = make_train_loop(
                self.config, self.settings, len(idxs), deg)
        self.state, metrics = self._train_loops[key](
            self.state, self._cams_device, jnp.asarray(idxs, jnp.int32))
        self.iteration += len(idxs)
        return metrics

    def _maybe_resize_stream(self, metrics) -> None:
        """Automatic instance-stream sizing (VERDICT r3 next #3b): pack
        cost is linear in the STATIC stream length, so a hand-sized
        max_instances ceiling taxes every step for capacity the scene may
        not use.  At each log boundary, read the window's max live
        occupancy (+ drops): any drop or >85% occupancy doubles the stream
        (the n_dropped == 0 invariant with headroom, exactly like
        grow_capacity); eight consecutive samples all below 35% halve it
        (hysteresis; floor 2^16 or 4 chunks).  Either direction rebuilds
        the jitted steps — rare, amortized over thousands of steps."""
        if (not self.config.auto_max_instances
                or not self.settings.use_pallas):
            return
        inst = metrics.get("render_instances")
        if inst is None:
            return
        k = self.settings.max_instances
        inst = float(inst)
        drops = float(metrics.get("render_drops", 0.0))
        large_drops = float(metrics.get("render_drops_large", 0.0))
        n_large = float(metrics.get("render_n_large", 0.0))
        # Between log boundaries the single-dispatch path accumulates the
        # window's device-side metric refs (ADVICE r4: per-camera instance
        # counts vary widely — sampling only the log step hid interior
        # overflows from the sizer); fold the window max in here.  One
        # stack+max dispatch and one host fetch per log window — never a
        # per-step sync.
        if self._window_obs:
            acc = {"render_instances": inst, "render_drops": drops,
                   "render_drops_large": large_drops,
                   "render_n_large": n_large}
            for kk in acc:
                vals = [o[kk] for o in self._window_obs if kk in o]
                if vals:
                    acc[kk] = max(acc[kk], float(jnp.max(jnp.stack(vals))))
            inst = acc["render_instances"]
            drops = acc["render_drops"]
            large_drops = acc["render_drops_large"]
            n_large = acc["render_n_large"]
            self._window_obs = []
        # Large-pool overflow is a DIFFERENT capacity knob: growing the
        # stream would never fix it (and would double max_instances every
        # window, unbounded).  Grow large_capacity instead; the remaining
        # stream-drop component below sizes the stream.
        drops = drops - large_drops
        cap = self.state.gaussians.capacity
        from ..ops.binning import plan_two_level
        two_level, eff_lc, _ = plan_two_level(
            cap, self.settings.image_height, self.settings.image_width,
            self.settings.tile_size, self.settings.radius_max,
            self.settings.max_dup_per_axis, self.settings.large_capacity)
        if large_drops > 0:
            new_lc = min(2 * eff_lc, cap)
            if new_lc != eff_lc:
                print(f"[auto_large_capacity] {eff_lc} -> {new_lc} "
                      f"(large-pool drops {large_drops:.0f}; rebuilding "
                      f"jitted steps)", flush=True)
                self.settings = self.settings.replace(large_capacity=new_lc)
                self._train_steps = {}
                self._train_loops = {}
                self._eval_renderers = {}
                self._large_occ_hist = []
        elif two_level and self.mesh is None:
            # Shrink an oversized pool exactly like the stream: 8
            # consecutive window maxima under 35% occupancy halve it
            # (hysteresis; 128-aligned).  Per-step candidate-sort cost is
            # linear in C_L, so dead slots tax every remaining step — but
            # small pools cost less than the recompile + transient drop
            # step a shrink/regrow flip costs, so the shrink floor is 8192
            # (a 20k tex run oscillated 6912->3456->6912 with 3.5K drops on
            # the regrow edge without it).  Mesh paths derive a
            # per-shard plan (C/n) — sizing from the replicated plan would
            # be wrong, so shrink stays single-device.
            self._large_occ_hist = (self._large_occ_hist
                                    + [n_large / eff_lc])[-8:]
            if (len(self._large_occ_hist) == 8
                    and max(self._large_occ_hist) < 0.35
                    and eff_lc // 2 >= 8192):
                new_lc = max(-(-(eff_lc // 2) // 128) * 128, 8192)
                print(f"[auto_large_capacity] {eff_lc} -> {new_lc} "
                      f"(large-pool occupancy "
                      f"{max(self._large_occ_hist):.2f}; rebuilding jitted "
                      f"steps)", flush=True)
                self.settings = self.settings.replace(large_capacity=new_lc)
                self._train_steps = {}
                self._train_loops = {}
                self._eval_renderers = {}
                self._large_occ_hist = []
        self._occupancy_hist = (self._occupancy_hist + [inst / k])[-8:]
        floor = max(1 << 16, 4 * self.settings.gaussian_chunk)
        new_k = k
        if drops > 0 or inst > 0.85 * k:
            new_k = 2 * k
        elif (len(self._occupancy_hist) == 8
              and max(self._occupancy_hist) < 0.35 and k // 2 >= floor):
            new_k = k // 2
        if new_k != k:
            print(f"[auto_max_instances] {k} -> {new_k} "
                  f"(occupancy {inst/k:.2f}, drops {drops:.0f}; "
                  f"rebuilding jitted steps)", flush=True)
            self.settings = self.settings.replace(max_instances=new_k)
            self._train_steps = {}
            self._train_loops = {}
            self._eval_renderers = {}   # mesh eval renderers bake the stream
            self._occupancy_hist = []

    def _auto_size_stream_initial(self) -> None:
        """Size the instance stream to the scene with ONE probe render
        before the first step: pack/sort/elementwise work is proportional
        to the static stream length, and the runtime sizer only SHRINKS
        after 8 consecutive low samples.  Grows 2x on probe overflow, then
        sets ~1.5x
        headroom over the observed occupancy; the runtime sizer keeps
        adjusting from there.  One render-only compile, amortized over the
        run."""
        if (not self.config.auto_max_instances or not self.settings.use_pallas
                or self.mesh is not None or getattr(self, "_stream_probed",
                                                    False)):
            return
        cams = self.train_cameras()
        if not cams:
            return
        self._stream_probed = True
        cam = cams[0].replace(uid=0, image_name="")
        g = self.state.gaussians
        from ..ops.binning import plan_two_level

        def _plan(settings):
            return plan_two_level(
                g.capacity, settings.image_height, settings.image_width,
                settings.tile_size, settings.radius_max,
                settings.max_dup_per_axis, settings.large_capacity)

        for _ in range(6):
            st = self.settings.replace(sh_degree=self.active_sh_degree())
            out = jax.jit(lambda gg, cc: render(gg, cc, st))(g, cam)
            n_live = int(out["n_live"])
            large_drops = int(out["n_dropped_large"])
            if int(out["n_dropped"]) == 0:
                G = self.settings.gaussian_chunk
                floor = max(1 << 16, 4 * G)
                k = max(((int(n_live * 1.5) + G - 1) // G) * G, floor)
                if k != self.settings.max_instances:
                    print(f"[auto_max_instances] initial probe: "
                          f"{n_live} instances -> stream "
                          f"{self.settings.max_instances} -> {k}", flush=True)
                    self.settings = self.settings.replace(max_instances=k)
                    self._train_steps = {}
                    self._train_loops = {}
                    self._eval_renderers = {}
                # Size the large pool off the same probe (shrink only —
                # growth is the overflow loop's job): a hand-set or stale
                # large_capacity taxes the candidate sort every step.
                two_level, eff_lc, _ = _plan(self.settings)
                n_large = int(out["n_large"])
                # same 8192 floor as the runtime shrink: below ~16K slots
                # the [C_L] stage cost is noise, and densification can
                # multiply the census 10x past the probe within a window
                lc = max(-(-int(n_large * 1.5) // 128) * 128, 8192)
                if two_level and lc < eff_lc:
                    print(f"[auto_large_capacity] initial probe: "
                          f"{n_large} large -> pool {eff_lc} -> {lc}",
                          flush=True)
                    self.settings = self.settings.replace(large_capacity=lc)
                    self._train_steps = {}
                    self._train_loops = {}
                    self._eval_renderers = {}
                return
            if large_drops > 0:
                # large-pool overflow: doubling the stream can never clear
                # it — grow the pool knob (mirrors _maybe_resize_stream)
                _, eff_lc, _ = _plan(st)
                self.settings = self.settings.replace(
                    large_capacity=min(2 * eff_lc, g.capacity))
            else:
                self.settings = self.settings.replace(
                    max_instances=2 * self.settings.max_instances)
            self._train_steps = {}
            self._train_loops = {}
            self._eval_renderers = {}

    def _maybe_compact_state(self) -> None:
        """Once the densify window closes the population is frozen, but the
        pool still holds the growth headroom — per-capacity stage cost for
        the whole polish phase.  Compact once if it saves >= 25% of the pool;
        one recompile, amortized over the remaining (typically 15000)
        steps.  Fires at most once per run (also on post-window resume)."""
        self._state_compacted = True
        cap = self.state.gaussians.capacity
        n = int(self.state.gaussians.num_alive())
        # same sizing policy as core.gaussians.compact (kept in sync)
        pow2 = 1 << max(int(np.ceil(np.log2(max(n * 1.25, 2.0)))), 1)
        aligned = max(-(-int(n * 1.15) // 256) * 256, 256)
        new_cap = min(pow2, aligned) if aligned >= n else pow2
        if self.mesh is not None:
            n_dev = self.mesh.shape["data"] * self.mesh.shape["tile"]
            new_cap = -(-new_cap // n_dev) * n_dev
        if new_cap > 0.75 * cap:
            return
        print(f"[compact] densify window closed: pool {cap} -> {new_cap} "
              f"({n} alive; rebuilding jitted steps)", flush=True)
        self.state = compact_train_state(self.state, new_cap)
        self._train_steps = {}
        self._train_loops = {}
        self._eval_renderers = {}
        if self.config.shard_gauss_state and self.mesh is not None:
            from ..parallel.sharded import (make_gauss_sharded_densify_step,
                                            shard_train_state)
            self.state = shard_train_state(self.state, self.mesh)
            self._densify_step = make_gauss_sharded_densify_step(
                self.config, self.mesh, self.state)
        else:
            self._densify_step = make_densify_step(self.config)

    def train(self, iterations: Optional[int] = None,
              log_fn: Optional[Callable] = None):
        """Main loop (reference trainer.py:45-59).  With steps_per_call
        != 1, single-device runs dispatch K steps per device call (see
        make_train_loop); every densify/prune/reset/log/eval/save event
        lands on a window boundary by construction of K."""
        iterations = iterations or self.config.iterations
        self._auto_size_stream_initial()
        cams = list(self.train_cameras())
        rng = np.random.default_rng(self.config.seed)
        metrics = {}
        n_data = self.mesh.shape["data"] if self.mesh is not None else 1
        K = self._loop_K() if cams else 1
        if K > 1 and cams:
            # The K-loop stages the FULL camera stack (incl. every target
            # image) as a permanent device-resident pytree (for hundreds of
            # 1080p f32 cameras that is multiple GB of device memory).  Above the budget, fall back to per-step dispatch.
            staged = sum(getattr(leaf, "nbytes", 8)
                         for c in cams for leaf in jax.tree.leaves(c))
            budget = self.config.loop_stage_budget_mb * (1 << 20)
            if staged > budget:
                print(f"[train] K-step loop disabled: staging "
                      f"{len(cams)} cameras needs {staged / 2**20:.0f} MB "
                      f"of device memory (budget "
                      f"{self.config.loop_stage_budget_mb} MB, "
                      f"config.loop_stage_budget_mb); dispatching per step",
                      flush=True)
                K = 1
        end = self.iteration + iterations
        while self.iteration < end:
            it0 = self.iteration
            if K > 1 and it0 % K == 0 and end - it0 >= K:
                # same rng stream as the single-step path: K sequential draws
                idxs = [int(rng.integers(len(cams))) for _ in range(K)]
                metrics = self._run_loop_window(idxs, cams)
                it = self.iteration
            else:
                it = it0 + 1
                if n_data > 1:
                    idxs = [int(rng.integers(len(cams)))
                            for _ in range(n_data)]
                    # static metadata must match across the stack
                    sel = [cams[i].replace(uid=0, image_name="")
                           for i in idxs]
                    cam = jax.tree.map(lambda *x: jnp.stack(x), *sel)
                    cam_idx = np.asarray(idxs, np.int32)
                else:
                    cam_idx = int(rng.integers(len(cams)))
                    # normalize static metadata so every camera shares ONE
                    # compiled step (uid/image_name live in the jit treedef)
                    cam = cams[cam_idx].replace(uid=0, image_name="")
                metrics = self.train_step(cam, cam_idx)
                if (self.config.auto_max_instances
                        and self.settings.use_pallas
                        and it % self.config.log_interval != 0):
                    # keep the DEVICE-side refs; the sizer folds the window
                    # max in at the log boundary (one fetch per window — a
                    # per-step float() would sync the async pipeline)
                    self._window_obs.append(
                        {k: metrics[k] for k in ("render_instances",
                                                 "render_drops",
                                                 "render_drops_large",
                                                 "render_n_large")
                         if k in metrics})
            if density.should_densify(it, self.config):
                self._key, sub = jax.random.split(self._key)
                # canonical big-point prune activates after the first
                # opacity reset (graphdeco size_threshold gating)
                size_prune = (self.config.opacity_reset_interval > 0
                              and it > self.config.opacity_reset_interval)
                self.state, dstats = self._densify_step(
                    self.state, sub, jnp.float32(self.scene_extent),
                    jnp.asarray(size_prune))
                metrics.update(dstats)
                # occupancy-triggered capacity growth (recompiles; rare)
                if (int(dstats["n_alive"])
                        > 0.85 * self.state.gaussians.capacity):
                    self.state = grow_capacity(
                        self.state, 2 * self.state.gaussians.capacity)
                    self._train_steps = {}
                    self._train_loops = {}
                    if self.config.shard_gauss_state and self.mesh is not None:
                        from ..parallel.sharded import (
                            make_gauss_sharded_densify_step, shard_train_state)
                        self.state = shard_train_state(self.state, self.mesh)
                        self._densify_step = make_gauss_sharded_densify_step(
                            self.config, self.mesh, self.state)
                    else:
                        self._densify_step = make_densify_step(self.config)
            elif density.should_prune(it, self.config):
                self.state, n_pruned = self._prune_step(self.state)
                metrics["n_pruned"] = n_pruned
            if (self.config.opacity_reset_interval > 0
                    and it % self.config.opacity_reset_interval == 0
                    and it <= self.config.densify_until_iter):
                self.state = _reset_opacity_step(self.state)
            if (self.config.compact_after_densify
                    and not getattr(self, "_state_compacted", False)
                    and 0 < self.config.densify_until_iter <= it):
                self._maybe_compact_state()
            if it % self.config.log_interval == 0:
                loss = float(metrics["total_loss"])
                self.train_losses.append(loss)
                if log_fn:
                    log_fn(it, {k: float(v) for k, v in metrics.items()})
                self._maybe_resize_stream(metrics)
            if it % self.config.eval_interval == 0 and self.dataset is not None:
                self.val_losses.append(self.validate().get("psnr", 0.0))
            if it % self.config.save_interval == 0:
                self.save_checkpoint(it)
        return metrics

    # ------------------------------------------------------------------
    def _mesh_render_fn(self, st: RenderSettings) -> Optional[Callable]:
        """Sharded eval renderer for the active mesh (VERDICT r2 weak #3):
        band/tile-sharded for replicated state, all_gather-of-projection for
        gauss-sharded state — never materializes replicated parameters.
        Returns None when the camera size cannot band-split on this mesh
        (caller falls back to the single-device path)."""
        if self.mesh is None:
            return None
        n_tile = self.mesh.shape["tile"]
        if st.image_height % (n_tile * st.tile_size) != 0:
            return None
        from ..parallel.sharded import (make_gauss_sharded_render,
                                        make_sharded_render)
        key = (st.image_height, st.image_width, st.sh_degree)
        cache = getattr(self, "_eval_renderers", None)
        if cache is None:
            cache = self._eval_renderers = {}
        if key not in cache:
            if self.config.shard_gauss_state:
                cache[key] = make_gauss_sharded_render(
                    st, self.mesh, self.state.gaussians)
            else:
                cache[key] = make_sharded_render(st, self.mesh)
        return cache[key]

    def validate(self) -> Dict[str, float]:
        """PSNR/SSIM over the test split (reference trainer.py:67-71).

        Dispatches are queued asynchronously for ALL cameras before any
        host sync, so the device renders camera k+1 while the host
        receives metrics k."""
        from ..utils.metrics import psnr as psnr_fn
        from ..core.loss import ssim as ssim_fn
        cams = self.dataset.get_test_cameras() if self.dataset else []
        if not cams:
            return {}
        psnrs, ssims = [], []
        for cam in cams:
            st = self.settings
            if (cam.height != st.image_height or cam.width != st.image_width):
                st = st.replace(image_height=cam.height, image_width=cam.width)
            mesh_render = self._mesh_render_fn(st)
            cam_n = cam.replace(uid=0, image_name="")
            if mesh_render is not None:
                out = mesh_render(self.state.gaussians, cam_n)
            else:
                out = render(self.state.gaussians, cam_n, st)
            psnrs.append(psnr_fn(out["image"], cam.image))
            ssims.append(ssim_fn(out["image"], cam.image))
        return {"psnr": float(np.mean([float(p) for p in psnrs])),
                "ssim": float(np.mean([float(s) for s in ssims]))}

    def save_checkpoint(self, iteration: int) -> None:
        from .checkpoint import save_checkpoint
        save_checkpoint(self.config.output_path, iteration, self.state)

    def load_checkpoint(self, iteration: int) -> None:
        from .checkpoint import checkpoint_capacity, load_checkpoint
        # capacity may have grown (occupancy-triggered grow_capacity) or
        # SHRUNK (post-densify-window compact_train_state) during the
        # checkpointed run; match the template's static shapes either way
        saved_cap = checkpoint_capacity(self.config.output_path, iteration)
        if saved_cap is not None and saved_cap != self.state.gaussians.capacity:
            if saved_cap < self.state.gaussians.capacity:
                # shrink the TEMPLATE (values are overwritten by restore;
                # only shapes/dtypes/structure matter)
                C = self.state.gaussians.capacity

                def shrink(x):
                    if hasattr(x, "ndim") and x.ndim >= 1 and x.shape[0] == C:
                        return x[:saved_cap]
                    return x

                print(f"[load_checkpoint] compacted checkpoint: template "
                      f"{C} -> {saved_cap} slots", flush=True)
                self.state = jax.tree.map(shrink, self.state)
                self._state_compacted = True  # don't re-compact this run
            else:
                self.state = grow_capacity(self.state, saved_cap)
            self._train_steps = {}
            self._train_loops = {}
            self._eval_renderers = {}
        self.state = load_checkpoint(self.config.output_path, iteration,
                                     self.state)
        self.iteration = int(self.state.step)
