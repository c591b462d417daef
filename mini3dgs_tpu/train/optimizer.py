"""Optimizer: multi-group Adam + cosine LR schedule (optax).

Reference semantics: `/root/reference/src/core/optimizer.py` —
`LearningRateScheduler.get_lr` cosine decay with warm-up delay
(optimizer.py:21-32), five Adam parameter groups (xyz / features / opacity /
scaling / rotation, optimizer.py:100-109) whose LRs all follow the scheduled
position LR scaled by their configured ratios (optimizer.py:120-129).

Redesign: a single optax transformation over the parameter pytree —
scale_by_adam, then a per-leaf static LR, then one shared schedule factor
sched(t)/position_lr_init (algebraically identical to the reference's
update_learning_rate).  After densification the reference throws away all Adam
state (optimizer.py:132-137); here moments are *surgically zeroed* only at
slots whose identity changed (`reset_adam_slots`), which preserves optimizer
history for untouched Gaussians — strictly better and shape-stable under jit.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import jax
import jax.numpy as jnp
import optax

from ..config import TrainingConfig


def cosine_delay_lr(step, lr_init: float, lr_final: float,
                    lr_delay_steps: int, lr_delay_mult: float, max_steps: int):
    """Reference optimizer.py:21-32, vectorized over a traced step."""
    if max_steps <= 0:
        return jnp.asarray(lr_final, jnp.float32)
    t = jnp.minimum(step, max_steps) / max_steps
    cos_decay = 0.5 * (1.0 + jnp.cos(jnp.pi * t))
    lr = lr_final + (lr_init - lr_final) * cos_decay
    if lr_delay_steps > 0:
        delay = lr_delay_mult + (1 - lr_delay_mult) * jnp.minimum(
            step / lr_delay_steps, 1.0)
        lr = lr * delay
    return lr


def group_lrs(config: TrainingConfig) -> dict:
    """Static per-leaf base LRs (reference optimizer.py:100-109)."""
    return {
        "xyz": config.position_lr_init,
        "features_dc": config.feature_lr,
        "features_rest": config.feature_lr,
        "opacity": config.opacity_lr,
        "scaling": config.scaling_lr,
        "rotation": config.rotation_lr,
    }


def _scale_by_group(lrs: dict) -> optax.GradientTransformation:
    def init(params):
        return optax.EmptyState()

    def update(updates, state, params=None):
        return {k: v * lrs[k] for k, v in updates.items()}, state

    return optax.GradientTransformation(init, update)


def make_optimizer(config: TrainingConfig) -> optax.GradientTransformation:
    def factor(step):
        base = cosine_delay_lr(step, config.position_lr_init,
                               config.position_lr_final,
                               config.position_lr_delay_steps,
                               config.position_lr_delay_mult,
                               config.position_lr_max_steps)
        return -(base / config.position_lr_init)

    return optax.chain(
        optax.scale_by_adam(b1=0.9, b2=0.999, eps=1e-8),  # torch Adam defaults
        _scale_by_group(group_lrs(config)),
        optax.scale_by_schedule(factor),
    )


def reset_adam_slots(opt_state, slot_mask: jnp.ndarray):
    """Zero first/second Adam moments at `slot_mask` rows (new or killed
    Gaussian slots after densify/prune — the shape-stable analog of the
    reference's full optimizer rebuild at optimizer.py:132-137)."""
    adam_state = opt_state[0]

    def zero_rows(x):
        if x.ndim >= 1 and x.shape[0] == slot_mask.shape[0]:
            mask = slot_mask.reshape((-1,) + (1,) * (x.ndim - 1))
            return jnp.where(mask, 0.0, x)
        return x

    new_adam = adam_state._replace(
        mu=jax.tree.map(zero_rows, adam_state.mu),
        nu=jax.tree.map(zero_rows, adam_state.nu))
    return (new_adam,) + tuple(opt_state[1:])
