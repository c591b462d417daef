"""Per-camera exposure / appearance compensation (beyond reference parity).

Real capture sets have per-image exposure and white-balance drift; canonical
3DGS practice (e.g. the original implementation's --train_test_exp mode and
VastGaussian-style appearance embeddings) learns a small per-training-image
color transform jointly with the scene so the Gaussians don't absorb the
drift.  Here: one learnable 3x4 affine matrix per training camera, applied
to the rendered image before the photometric loss,

    image' = M[:, :3] @ image + M[:, 3]

initialized to identity (a no-op) and trained with its own Adam group
(`config.exposure_lr`).  Evaluation renders stay raw (test views have no
learned exposure).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def init_exposure(n_cameras: int) -> jnp.ndarray:
    """[n, 3, 4] identity affine color transforms."""
    eye = jnp.concatenate([jnp.eye(3, dtype=jnp.float32),
                           jnp.zeros((3, 1), jnp.float32)], axis=1)
    return jnp.tile(eye[None], (n_cameras, 1, 1))


def apply_exposure(M: jnp.ndarray, image: jnp.ndarray) -> jnp.ndarray:
    """Apply one [3,4] affine color transform to a [3,H,W] image."""
    return (jnp.einsum("ij,jhw->ihw", M[:, :3], image,
                       precision=jax.lax.Precision.HIGHEST)
            + M[:, 3][:, None, None])
