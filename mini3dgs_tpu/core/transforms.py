"""Rotation / covariance math (JAX), vectorized.

Reference semantics: `/root/reference/src/utils/math_utils.py:9-34`
(wxyz quaternion -> rotation matrix with normalize-first, and
Sigma = R diag(sigma^2) R^T).  The reference's broken isotropic
`project_covariance_2d` (B13) is replaced by the full EWA chain in
`ops/projection.py`.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_HI = jax.lax.Precision.HIGHEST  # f32 matmuls would run as TF32 on a GPU


def quat_to_rotmat_components(q: jnp.ndarray):
    """[..., 4] wxyz quaternion -> the 9 rotation-matrix entries as a tuple
    of [...] arrays (row-major r00..r22). Normalizes first.

    Kept component-wise so hot paths (ops/projection.py) stay in pure
    elementwise math instead of batched 3x3 dots."""
    q = q / (jnp.linalg.norm(q, axis=-1, keepdims=True) + 1e-12)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    ww, xx, yy, zz = w * w, x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    return (1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy))


def quat_to_rotmat(q: jnp.ndarray) -> jnp.ndarray:
    """[..., 4] wxyz quaternion -> [..., 3, 3] rotation. Normalizes first."""
    R = jnp.stack(quat_to_rotmat_components(q), axis=-1)
    return R.reshape(q.shape[:-1] + (3, 3))


def build_covariance_3d(scaling: jnp.ndarray, rotation_q: jnp.ndarray) -> jnp.ndarray:
    """Sigma = R diag(sigma^2) R^T, [..., 3, 3]; scaling holds sigma (not log)."""
    R = quat_to_rotmat(rotation_q)
    # R @ diag(s^2) @ R^T without materializing the diag: scale columns of R.
    RS = R * (scaling[..., None, :] ** 2)
    return jnp.einsum("...ij,...kj->...ik", RS, R, precision=_HI)


def project_covariance_2d(cov3d: jnp.ndarray, view_rot: jnp.ndarray,
                          J: jnp.ndarray) -> jnp.ndarray:
    """Full EWA covariance projection Sigma2D = J (Rv Sigma Rv^T) J^T.

    The reference's `MathUtils.project_covariance_2d` (math_utils.py:36-42,
    bug B13) was a broken isotropic stand-in; this is the real chain the
    renderer inlines (renderer.py:165-183).  cov3d [...,3,3], view_rot [3,3],
    J [...,2,3] -> [...,2,2].
    """
    cov_cam = jnp.einsum("ij,...jk,lk->...il", view_rot, cov3d, view_rot,
                         precision=_HI)
    return jnp.einsum("...ij,...jk,...lk->...il", J, cov_cam, J,
                      precision=_HI)


def inverse_sigmoid(x: jnp.ndarray) -> jnp.ndarray:
    return jnp.log(x / (1.0 - x))


def normalize_quat(q: jnp.ndarray) -> jnp.ndarray:
    return q / (jnp.linalg.norm(q, axis=-1, keepdims=True) + 1e-12)
