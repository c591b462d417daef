"""Camera model and projective geometry, JAX-native.

Reference semantics: `/root/reference/src/core/camera.py` (Camera container,
`CameraUtils.build_world_view_matrix` at camera.py:79-141, the two provably
equivalent projection parameterizations at camera.py:142-188, and point
projection, camera.py:189-199 — implemented here with the reference's bugs
B1-B5/B7 fixed: single class, both projection forms under distinct names, a
working `camera_center`, and a correct homogeneous point projection).

Design: a `Camera` is a frozen pytree of jnp arrays so it can be
passed straight into jitted/shard_mapped functions and batched with vmap;
matrices are built eagerly as pure functions instead of cached mutable state.
"""

from __future__ import annotations

import math
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from .. import struct

_HI = jax.lax.Precision.HIGHEST  # f32 matmuls would run as TF32 on a GPU


def build_world_view_matrix(R, T, from_c2w: bool = True) -> jnp.ndarray:
    """Build the 4x4 world->camera (W2C) view matrix.

    With C2W input (reference camera.py:130-133): ``R`` is the camera->world
    rotation R_cw and ``T`` the camera center C_w in world coordinates, so
        R_wc = R_cw^T,   t_wc = -R_cw^T @ C_w.
    With W2C input the pair is used directly.
    """
    # Host-side numpy: this runs once, at camera construction time.
    R = np.asarray(R, dtype=np.float32).reshape(3, 3)
    T = np.asarray(T, dtype=np.float32).reshape(3)
    if from_c2w:
        R_wc = R.T
        t_wc = -(R_wc @ T)
    else:
        R_wc = R
        t_wc = T
    view = np.eye(4, dtype=np.float32)
    view[:3, :3] = R_wc
    view[:3, 3] = t_wc
    return jnp.asarray(view)


def build_projection_matrix_v1(znear: float, zfar: float,
                               fovX, fovY) -> jnp.ndarray:
    """OpenGL-style perspective matrix from FoV (reference camera.py:142-166).

    fovX/fovY may be python floats or traced jnp scalars."""
    tx = jnp.tan(jnp.float32(fovX) * 0.5)
    ty = jnp.tan(jnp.float32(fovY) * 0.5)
    tan_half_x = jnp.where(jnp.abs(tx) < 1e-6, 1e-6, tx)
    tan_half_y = jnp.where(jnp.abs(ty) < 1e-6, 1e-6, ty)
    A = 1.0 / tan_half_x
    B = 1.0 / tan_half_y
    C = -(zfar + znear) / (zfar - znear)
    D = -(2.0 * zfar * znear) / (zfar - znear)
    zero = jnp.zeros_like(A)
    return jnp.stack([
        jnp.stack([A, zero, zero, zero]),
        jnp.stack([zero, B, zero, zero]),
        jnp.stack([zero, zero, jnp.full_like(A, C), jnp.full_like(A, D)]),
        jnp.stack([zero, zero, jnp.full_like(A, -1.0), zero]),
    ]).astype(jnp.float32)


def build_projection_matrix_v2(znear: float, zfar: float,
                               fovX: float, fovY: float,
                               width: int, height: int) -> jnp.ndarray:
    """Focal-length form (reference camera.py:168-188); equals v1 identically."""
    focal_x = (width / 2.0) / math.tan(float(fovX) / 2.0)
    focal_y = (height / 2.0) / math.tan(float(fovY) / 2.0)
    P = jnp.zeros((4, 4), dtype=jnp.float32)
    P = P.at[0, 0].set(2.0 * focal_x / width)
    P = P.at[1, 1].set(2.0 * focal_y / height)
    P = P.at[2, 2].set(-(zfar + znear) / (zfar - znear))
    P = P.at[2, 3].set(-2.0 * zfar * znear / (zfar - znear))
    P = P.at[3, 2].set(-1.0)
    return P


# Canonical accessor used by the rest of the framework.
build_projection_matrix = build_projection_matrix_v1


def focal_from_fov(fov, pixels: int):
    """f = 0.5 * pixels / tan(fov/2) (reference renderer.py:142-143)."""
    return 0.5 * pixels / jnp.tan(jnp.float32(fov) * 0.5)


def fov_from_focal(focal: float, pixels: int) -> float:
    return 2.0 * math.atan(pixels / (2.0 * focal))


@struct.dataclass
class Camera:
    """A single view, as an immutable pytree (jit/vmap/shard_map friendly).

    Fields mirror the reference Camera (`camera.py:8-42`): `R` is the
    camera->world rotation, `T` the camera center in world frame.  Static
    (non-traced) metadata lives in pytree_node=False fields.
    """

    R: jnp.ndarray                    # [3,3] camera->world rotation
    T: jnp.ndarray                    # [3]   camera center, world frame
    view_matrix: jnp.ndarray          # [4,4] W2C (precomputed, pure data)
    # FoV as traced leaves so cameras with different intrinsics share one
    # compiled executable (only H/W changes retrace).
    FoVx: jnp.ndarray = struct.field(default_factory=lambda: jnp.float32(1.0))
    FoVy: jnp.ndarray = struct.field(default_factory=lambda: jnp.float32(1.0))
    image: Optional[jnp.ndarray] = None  # [3,H,W] ground-truth image or None
    width: int = struct.field(pytree_node=False, default=0)
    height: int = struct.field(pytree_node=False, default=0)
    uid: int = struct.field(pytree_node=False, default=0)
    image_name: str = struct.field(pytree_node=False, default="")
    znear: float = struct.field(pytree_node=False, default=0.1)
    zfar: float = struct.field(pytree_node=False, default=1000.0)

    @classmethod
    def create(cls, uid: int, R, T, FoVx: float, FoVy: float,
               image=None, image_name: str = "",
               width: Optional[int] = None, height: Optional[int] = None,
               znear: float = 0.1, zfar: float = 1000.0) -> "Camera":
        R = np.asarray(R, dtype=np.float32).reshape(3, 3)
        T = np.asarray(T, dtype=np.float32).reshape(3)
        if image is not None:
            image = jnp.asarray(image, dtype=jnp.float32)
            if width is None:
                width = int(image.shape[-1])
            if height is None:
                height = int(image.shape[-2])
        view = build_world_view_matrix(R, T, from_c2w=True)
        return cls(R=jnp.asarray(R), T=jnp.asarray(T), view_matrix=view,
                   image=image, FoVx=jnp.float32(FoVx), FoVy=jnp.float32(FoVy),
                   width=int(width), height=int(height), uid=int(uid),
                   image_name=image_name, znear=float(znear), zfar=float(zfar))

    # -- reference-parity accessors --
    @property
    def world_view_transform(self) -> jnp.ndarray:
        return self.view_matrix

    @property
    def projection_matrix(self) -> jnp.ndarray:
        return build_projection_matrix_v1(self.znear, self.zfar, self.FoVx, self.FoVy)

    @property
    def full_proj_transform(self) -> jnp.ndarray:
        # P @ V (reference camera.py:60-63)
        return jnp.matmul(self.projection_matrix, self.view_matrix,
                          precision=_HI)

    @property
    def camera_center(self) -> jnp.ndarray:
        """Camera position in world frame (reference B4 fixed): with C2W input
        this is simply T; recover it robustly from the view matrix."""
        R_wc = self.view_matrix[:3, :3]
        t_wc = self.view_matrix[:3, 3]
        return -jnp.matmul(R_wc.T, t_wc, precision=_HI)

    @property
    def fx(self) -> float:
        return focal_from_fov(self.FoVx, self.width)

    @property
    def fy(self) -> float:
        return focal_from_fov(self.FoVy, self.height)


def project_points(points_3d: jnp.ndarray, camera: Camera) -> jnp.ndarray:
    """Project [N,3] world points to pixel coordinates [N,2] (reference B7 fixed).

    Uses the same pinhole convention as the renderer (renderer.py:161-163):
    x = fx*X/Z + cx, y = -fy*Y/Z + cy (y-down), cx = W/2, cy = H/2.
    """
    V = camera.view_matrix
    Xc = jnp.matmul(points_3d, V[:3, :3].T, precision=_HI) + V[:3, 3]
    X, Y, Z = Xc[:, 0], Xc[:, 1], Xc[:, 2]
    x = camera.fx * X / Z + 0.5 * camera.width
    y = -camera.fy * Y / Z + 0.5 * camera.height
    return jnp.stack([x, y], axis=-1)


def project_points_ndc(points_3d: jnp.ndarray, camera: Camera) -> jnp.ndarray:
    """Project via the full 4x4 chain to NDC (for the v1/v2 equivalence tests)."""
    N = points_3d.shape[0]
    homo = jnp.concatenate([points_3d, jnp.ones((N, 1), dtype=points_3d.dtype)], axis=-1)
    clip = jnp.matmul(homo, camera.full_proj_transform.T, precision=_HI)
    return clip[:, :3] / clip[:, 3:4]
