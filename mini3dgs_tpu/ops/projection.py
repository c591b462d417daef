"""EWA projection of 3D Gaussians to screen space + frustum culling (JAX).

Reference semantics: `/root/reference/src/core/renderer.py:117-220` —
world->camera transform, pinhole projection x = fx*X/Z + cx, y = -fy*Y/Z + cy
(y-down; renderer.py:161-163), covariance chain Sigma_cam = Rv Sigma Rv^T,
Sigma_2D = J Sigma_cam J^T + 1e-6 I with the projective Jacobian entries
fx/Z, -fx*X/Z^2, -fy/Z, fy*Y/Z^2 (renderer.py:171-183), conic = Sigma_2D^-1,
radius = 3*sqrt(lambda_max) clamped to [radius_min, radius_max]
(renderer.py:186-192), and the cull predicate Z>0, -r<=x<W+r, -r<=y<H+r, r>0
(renderer.py:201-220).

Design: fully vectorized elementwise math with *closed-form* 2x2 inverse and
eigenvalues instead of batched `linalg.inv`/`eigvalsh`; culling is a mask (no
compaction — static shapes); dead pool slots are masked out through `alive`.
Everything here is differentiable and fuses under jit; the raster custom-VJP
boundary is downstream in `ops/raster*`.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core import sh as sh_lib
from ..core.camera import Camera
from ..core.gaussians import Gaussians


class Projected(NamedTuple):
    means2d: jnp.ndarray   # [C,2] pixel coordinates
    conic: jnp.ndarray     # [C,3] (a, b, c) of the symmetric 2x2 conic Q
    depth: jnp.ndarray     # [C]   camera-frame Z
    radius: jnp.ndarray    # [C]   pixel radius (3 sigma), clamped
    visible: jnp.ndarray   # [C]   bool cull mask (includes alive)
    color: jnp.ndarray     # [C,3] decoded RGB
    opacity: jnp.ndarray   # [C]   sigmoid opacity
    # Exact-cull half-extents (optional): a pixel at |px-cx| > ext_x has
    # s = d^T Q d >= dx^2/Sigma_xx > 2 ln(1/W_EPS), i.e. its weight falls
    # below the reference's own skip threshold (renderer.py:336) and its
    # contribution is EXACTLY zero in forward and backward.  Binning
    # intersects the reference AABB with this per-axis box — output-identical
    # (the reference tile-AABB cutoff stays the outer bound) but elongated
    # splats stop emitting whole-tile zero-weight instances.
    ext_x: jnp.ndarray = None  # [C] pixel half-extent along x (incl. margin)
    ext_y: jnp.ndarray = None  # [C] pixel half-extent along y


def project_gaussians(g: Gaussians, camera: Camera, *,
                      radius_min: float = 0.01, radius_max: float = 50.0,
                      color_mode: str = "dc_sigmoid", sh_degree: int = 0,
                      scale_modifier: float = 1.0,
                      antialias: bool = False) -> Projected:
    W, H = camera.width, camera.height
    fx = 0.5 * W / jnp.tan(camera.FoVx * 0.5)
    fy = 0.5 * H / jnp.tan(camera.FoVy * 0.5)
    cx, cy = 0.5 * W, 0.5 * H

    V = camera.view_matrix
    Rv, Tv = V[:3, :3], V[:3, 3]

    Xw = g.xyz
    Xc = jnp.matmul(Xw, Rv.T, precision=jax.lax.Precision.HIGHEST) + Tv
    X, Y, Z = Xc[:, 0], Xc[:, 1], Xc[:, 2]

    # Guard divides: behind-camera / dead points get Z=1 then are culled.
    front = Z > 1e-6
    Zs = jnp.where(front, Z, 1.0)
    invZ = 1.0 / Zs
    invZ2 = invZ * invZ

    xpix = fx * X * invZ + cx
    ypix = -fy * Y * invZ + cy
    means2d = jnp.stack([xpix, ypix], axis=-1)

    # 3D covariance in camera frame: Sigma_cam = Rv Sigma Rv^T
    #                                          = (Rv R diag(s)) (Rv R diag(s))^T.
    # Expanded per-component: 9+6 fused elementwise chains never
    # materialize a [C,3,3] array and keep full f32 (batched 3x3 einsums are
    # the plain alternative; not compared on the GPU yet).
    sigma = g.get_scaling * scale_modifier
    s0, s1, s2 = sigma[:, 0], sigma[:, 1], sigma[:, 2]
    from ..core.transforms import quat_to_rotmat_components
    r = quat_to_rotmat_components(g.rotation)  # 9 x [C], row-major
    # B = Rv @ R, then columns scaled by s: b_il = (sum_j Rv[i,j] r_jl) * s_l
    b = []
    for i in range(3):
        m0, m1, m2 = Rv[i, 0], Rv[i, 1], Rv[i, 2]
        b.append(((m0 * r[0] + m1 * r[3] + m2 * r[6]) * s0,
                  (m0 * r[1] + m1 * r[4] + m2 * r[7]) * s1,
                  (m0 * r[2] + m1 * r[5] + m2 * r[8]) * s2))

    def _dot3(u, v):
        return u[0] * v[0] + u[1] * v[1] + u[2] * v[2]

    # 2D covariance via the projective Jacobian, expanded in closed form:
    # J = [[fx/Z, 0, -fx X/Z^2], [0, -fy/Z, fy Y/Z^2]]  (renderer.py:171-177)
    j00 = fx * invZ
    j02 = -fx * X * invZ2
    j11 = -fy * invZ
    j12 = fy * Y * invZ2
    c00, c01, c02 = _dot3(b[0], b[0]), _dot3(b[0], b[1]), _dot3(b[0], b[2])
    c11, c12, c22 = _dot3(b[1], b[1]), _dot3(b[1], b[2]), _dot3(b[2], b[2])
    # row0 of J @ Sigma_cam: [j00*c00 + j02*c02, j00*c01 + j02*c12, j00*c02 + j02*c22]
    a = j00 * (j00 * c00 + j02 * c02) + j02 * (j00 * c02 + j02 * c22) + 1e-6
    b = j11 * (j00 * c01 + j02 * c12) + j12 * (j00 * c02 + j02 * c22)
    c = j11 * (j11 * c11 + j12 * c12) + j12 * (j11 * c12 + j12 * c22) + 1e-6

    # Mip-splatting-style antialiasing (opt-in; beyond reference parity):
    # dilate the screen-space covariance by the pixel footprint (0.3 px^2)
    # and compensate opacity by sqrt(det(Sigma)/det(Sigma+sI)) so an
    # isolated Gaussian's total integrated contribution is preserved as it
    # shrinks below a pixel (Yu et al., "Mip-Splatting", CVPR 2024).
    comp = 1.0
    if antialias:
        det_raw = jnp.maximum(a * c - b * b, 1e-12)
        a = a + 0.3
        c = c + 0.3
        det_blur = a * c - b * b
        comp = jnp.sqrt(jnp.maximum(det_raw / det_blur, 0.0))

    # conic = [[a,b],[b,c]]^-1 in closed form.
    det = a * c - b * b
    det = jnp.where(jnp.abs(det) < 1e-12, 1e-12, det)
    inv_det = 1.0 / det
    conic = jnp.stack([c * inv_det, -b * inv_det, a * inv_det], axis=-1)

    # radius = 3 sqrt(lambda_max), closed-form symmetric 2x2 eigenvalue.
    mid = 0.5 * (a + c)
    disc = jnp.sqrt(jnp.maximum(0.25 * (a - c) ** 2 + b * b, 0.0))
    lam_max = jnp.maximum(mid + disc, 1e-12)
    radius = jnp.clip(3.0 * jnp.sqrt(lam_max), radius_min, radius_max)

    visible = (front & g.alive
               & (xpix >= -radius) & (xpix < W + radius)
               & (ypix >= -radius) & (ypix < H + radius)
               & (radius > 0))

    # Color decode (renderer.py:88-92 uses sigmoid(DC); "sh" is canonical 3DGS).
    if color_mode == "dc_sigmoid":
        color = jax.nn.sigmoid(g.features_dc[:, 0, :])
    elif color_mode == "sh":
        dirs = Xw - camera.camera_center[None, :]
        dirs = dirs / (jnp.linalg.norm(dirs, axis=-1, keepdims=True) + 1e-12)
        color = sh_lib.sh_to_rgb(sh_degree, g.get_features, dirs)
    else:
        raise ValueError(f"unknown color_mode {color_mode!r}")

    opacity = jax.nn.sigmoid(g.opacity[:, 0]) * comp

    # Exact-cull half-extents: s >= dx^2/Sigma_xx (conditional minimum of the
    # quadratic form), so |dx| > sqrt(2 ln(1/W_EPS) * a) guarantees w < W_EPS
    # — the reference's skip threshold (renderer.py:336) zeroes such
    # contributions exactly.  +1 px margin absorbs float rounding of the
    # sqrt and of the kernel's f32 quadratic form.
    cull_sigma = math.sqrt(2.0 * math.log(1.0 / 1e-5))  # = raster_ref.W_EPS
    ext_x = cull_sigma * jnp.sqrt(jnp.maximum(a, 0.0)) + 1.0
    ext_y = cull_sigma * jnp.sqrt(jnp.maximum(c, 0.0)) + 1.0
    return Projected(means2d=means2d, conic=conic, depth=Z, radius=radius,
                     visible=visible, color=color, opacity=opacity,
                     ext_x=ext_x, ext_y=ext_y)


