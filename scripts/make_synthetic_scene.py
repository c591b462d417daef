"""Generate a NeRF-synthetic-format dataset from a hidden procedural model.

The upstream BASELINE configs call for training on real scenes (NeRF-synthetic
lego); with no network egress the dataset files cannot be fetched, so this
script procedurally builds an equivalent benchmark scene: ground-truth images
come from a *different renderer family* (a ray-marched SDF scene with
Lambertian shading — nothing the Gaussian model could trivially memorize),
rendered at 800x800 from cameras on the upper hemisphere, and written in the
exact `transforms_{train,test}.json` + RGBA-PNG layout that
`mini3dgs_tpu.data.dataset.BlenderDataset` (and original NeRF/3DGS loaders)
consume.

Ray generation matches the renderer's camera model exactly
(ops/projection.py: xpix = fx X/Z + cx, ypix = -fy Y/Z + cy, integer pixel
coords), so a perfectly-fit Gaussian model could in principle reach GT.

Usage:
    python scripts/make_synthetic_scene.py --out data/sdf_scene \
        [--n-train 64] [--n-test 8] [--size 800]
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

FOVX = 0.6911112070083618  # camera_angle_x of NeRF-synthetic lego


# --------------------------------------------------------------------------
# Texture-dense albedo variant (VERDICT r3 missing #2 / next #5): the base
# scene's smooth Lambertian albedos optimize toward FEW, LARGE splats, so
# the canonical densification hyperparameters (reference
# gaussian_model.py:137,166 — split > 0.03*extent, clone < 0.01*extent —
# and the 20px screen prune) were never load-tested.  These albedos are
# piecewise-constant procedural textures with 5-15px cells at the bench
# camera distance (scene spans ~350 px/unit at 800^2, lattice constants
# 24-74 cells/unit), so reconstruction REQUIRES a dense population of small
# splats — the regime those knobs were designed for.  `xp` is numpy or
# jax.numpy: the renderer and the seed-point-cloud sampler share one
# definition.
# --------------------------------------------------------------------------

TEX_PALETTES = [
    ([0.90, 0.20, 0.15], [0.95, 0.85, 0.20]),   # torus: red/gold
    ([0.10, 0.30, 0.85], [0.20, 0.90, 0.90]),   # sphere: blue/cyan
    ([0.90, 0.45, 0.10], [0.30, 0.10, 0.50]),   # box: orange/purple
    ([0.10, 0.70, 0.20], [0.95, 0.95, 0.90]),   # small sphere: green/white
    ([0.85, 0.10, 0.50], [0.15, 0.15, 0.20]),   # small sphere: magenta/near-black
    ([0.40, 0.25, 0.10], [0.90, 0.80, 0.60]),   # small torus: brown/sand
]
TEX_FREQS = [24.0, 30.0, 26.0, 40.0, 40.0, 34.0]


def _hash_lattice(xp, p, scale):
    """Per-lattice-cell uniform [0,1) value (piecewise constant — sharp
    edges at every cell boundary, the texture's high-frequency content)."""
    q = xp.floor(p * scale)
    h = xp.sin(q[..., 0] * 12.9898 + q[..., 1] * 78.233
               + q[..., 2] * 37.719) * 43758.5453
    return h - xp.floor(h)


def _tex_albedo(xp, p, ca, cb, freq):
    """Two-color palette mixed by a fine 3D checker + two hash lattices."""
    ca = xp.asarray(ca, xp.float32)
    cb = xp.asarray(cb, xp.float32)
    ch = (xp.floor(p[..., 0] * freq) + xp.floor(p[..., 1] * freq)
          + xp.floor(p[..., 2] * freq)) % 2.0
    m = 0.35 * ch + 0.45 * _hash_lattice(xp, p, freq * 1.7) \
        + 0.20 * _hash_lattice(xp, p, freq * 3.1)
    m = xp.clip(m, 0.0, 1.0)[..., None]
    return ca * (1.0 - m) + cb * m


# --------------------------------------------------------------------------
# SDF scene (the hidden model)
# --------------------------------------------------------------------------

def _build_renderer(size: int, spp: int = 2, texture: bool = False):
    """Returns a jitted (R, T) -> RGBA renderer.  R: our C2W rotation
    (columns = camera basis, +z forward, y-down pixels), T: camera center."""
    import jax
    import jax.numpy as jnp

    H = W = size
    fx = fy = 0.5 * W / math.tan(FOVX / 2)
    cx, cy = 0.5 * W, 0.5 * H

    def sd_sphere(p, c, r):
        return jnp.linalg.norm(p - c, axis=-1) - r

    def sd_torus(p, c, R_, r_):
        q = p - c
        qxz = jnp.sqrt(q[..., 0] ** 2 + q[..., 2] ** 2) - R_
        return jnp.sqrt(qxz ** 2 + q[..., 1] ** 2) - r_

    def sd_box(p, c, b, rad):
        q = jnp.abs(p - c) - b
        return (jnp.linalg.norm(jnp.maximum(q, 0.0), axis=-1)
                + jnp.minimum(jnp.maximum(q[..., 0],
                                          jnp.maximum(q[..., 1], q[..., 2])),
                              0.0) - rad)

    # object list: (sdf fn, albedo fn)
    def albedo_torus(p):
        ang = jnp.arctan2(p[..., 2], p[..., 0])
        stripe = 0.5 + 0.5 * jnp.sin(6.0 * ang)
        return jnp.stack([0.85 * stripe + 0.1, 0.25 + 0.2 * stripe,
                          0.2 * jnp.ones_like(stripe)], axis=-1)

    def albedo_sphere(p):
        checker = ((jnp.floor(p[..., 0] * 6) + jnp.floor(p[..., 1] * 6)
                    + jnp.floor(p[..., 2] * 6)) % 2)
        return jnp.stack([0.15 + 0.1 * checker, 0.35 + 0.45 * checker,
                          0.8 - 0.3 * checker], axis=-1)

    def albedo_box(p):
        g = 0.5 + 0.5 * jnp.sin(10.0 * p[..., 1])
        return jnp.stack([0.9 * jnp.ones_like(g), 0.75 * g + 0.15,
                          0.15 + 0.2 * g], axis=-1)

    def albedo_const(rgb):
        def f(p):
            return jnp.broadcast_to(jnp.asarray(rgb, jnp.float32),
                                    p.shape[:-1] + (3,))
        return f

    sdfs = [
        lambda p: sd_torus(p, jnp.array([0.0, -0.15, 0.0]), 0.75, 0.22),
        lambda p: sd_sphere(p, jnp.array([0.45, 0.38, -0.25]), 0.34),
        lambda p: sd_box(p, jnp.array([-0.55, 0.25, 0.35]),
                         jnp.array([0.22, 0.3, 0.2]), 0.05),
        lambda p: sd_sphere(p, jnp.array([-0.2, -0.1, -0.65]), 0.18),
        lambda p: sd_sphere(p, jnp.array([0.75, -0.35, 0.55]), 0.15),
        lambda p: sd_torus(p, jnp.array([0.05, 0.75, 0.3]), 0.3, 0.09),
    ]
    if texture:
        def make_tex(i):
            ca, cb = TEX_PALETTES[i]
            return lambda p: _tex_albedo(jnp, p, ca, cb, TEX_FREQS[i])
        albedos = [make_tex(i) for i in range(6)]
    else:
        albedos = [albedo_torus, albedo_sphere, albedo_box,
                   albedo_const([0.9, 0.9, 0.25]),
                   albedo_const([0.35, 0.9, 0.5]),
                   albedo_const([0.55, 0.35, 0.95])]
    objects = list(zip(sdfs, albedos))

    def scene_sdf(p):
        ds = jnp.stack([o[0](p) for o in objects], axis=-1)  # [..., n_obj]
        return ds.min(axis=-1), ds.argmin(axis=-1)

    def scene_albedo(p, oid):
        cols = jnp.stack([o[1](p) for o in objects], axis=-2)  # [..., n_obj, 3]
        return jnp.take_along_axis(cols, oid[..., None, None],
                                   axis=-2)[..., 0, :]

    lights = [
        (jnp.asarray([0.5, 0.7, -0.5]), 0.9),   # key
        (jnp.asarray([-0.6, 0.4, 0.6]), 0.45),  # fill
    ]
    AMBIENT = 0.22

    def render(R, T):
        """R [3,3] C2W (+z forward), T [3] center -> [H,W,4] float RGBA.
        All spp^2 subsample rays march in ONE batched scan (leading axis S)
        — keeps the compile graph small."""
        sub = (jnp.arange(spp) + 0.5) / spp - 0.5
        dxy = jnp.stack(jnp.meshgrid(sub, sub), axis=-1).reshape(-1, 2)  # [S,2]
        jj, ii = jnp.meshgrid(jnp.arange(W, dtype=jnp.float32),
                              jnp.arange(H, dtype=jnp.float32))
        x = (jj[None] + dxy[:, 0, None, None] - cx) / fx          # [S,H,W]
        y = -(ii[None] + dxy[:, 1, None, None] - cy) / fy
        d_cam = jnp.stack([x, y, jnp.ones_like(x)], axis=-1)      # [S,H,W,3]
        d_cam = d_cam / jnp.linalg.norm(d_cam, axis=-1, keepdims=True)
        d = d_cam @ R.T
        o = jnp.broadcast_to(T, d.shape)

        def march(carry, _):
            t, _hit = carry
            p = o + t[..., None] * d
            dist, _ = scene_sdf(p)
            t = t + jnp.maximum(dist, 0.0) * 0.9
            return (t, dist < 1e-3), None

        t0 = jnp.full(d.shape[:-1], 0.05, jnp.float32)
        (t, hit), _ = jax.lax.scan(march, (t0, t0 < 0), None, length=128)
        hit = hit & (t < 12.0)
        p = o + t[..., None] * d
        _, oid = scene_sdf(p)
        # normal by central differences
        eps = 1e-3

        def sd0(q):
            return scene_sdf(q)[0]

        n = jnp.stack([
            sd0(p + jnp.array([eps, 0, 0])) - sd0(p - jnp.array([eps, 0, 0])),
            sd0(p + jnp.array([0, eps, 0])) - sd0(p - jnp.array([0, eps, 0])),
            sd0(p + jnp.array([0, 0, eps])) - sd0(p - jnp.array([0, 0, eps])),
        ], axis=-1)
        n = n / (jnp.linalg.norm(n, axis=-1, keepdims=True) + 1e-9)
        alb = scene_albedo(p, oid)
        shade = AMBIENT
        for ldir, lint in lights:
            ldir = ldir / jnp.linalg.norm(ldir)
            shade = shade + lint * jnp.maximum((n * ldir).sum(-1), 0.0)
        rgb = jnp.clip(alb * shade[..., None], 0.0, 1.0)
        a = hit.astype(jnp.float32)
        rgb_acc = (rgb * a[..., None]).mean(axis=0)               # [H,W,3]
        a_acc = a.mean(axis=0)
        # store premultiplied-unpremultiplied: PNG expects straight alpha
        straight = jnp.where(a_acc[..., None] > 1e-6,
                             rgb_acc / jnp.maximum(a_acc[..., None], 1e-6),
                             0.0)
        return jnp.concatenate([jnp.clip(straight, 0, 1),
                                a_acc[..., None]], axis=-1)

    return jax.jit(render)


def camera_pose(theta: float, phi: float, radius: float):
    """Camera on the sphere looking at the origin.  Returns (R, T) in OUR
    convention (C2W columns = [right, up, fwd], +z forward)."""
    center = np.array([radius * math.cos(phi) * math.sin(theta),
                       radius * math.sin(phi),
                       -radius * math.cos(phi) * math.cos(theta)], np.float64)
    fwd = -center / np.linalg.norm(center)
    up = np.array([0.0, 1.0, 0.0])
    right = np.cross(up, fwd)
    nr = np.linalg.norm(right)
    if nr < 1e-6:
        right = np.array([1.0, 0.0, 0.0])
        nr = 1.0
    right = right / nr
    upv = np.cross(fwd, right)
    R = np.stack([right, upv, fwd], axis=1)
    return R.astype(np.float32), center.astype(np.float32)


def to_blender_c2w(R: np.ndarray, T: np.ndarray) -> np.ndarray:
    """Inverse of BlenderDataset's convention flip (dataset.py:188):
    c2w_blender[:3,:3] = R_ours @ diag(1,-1,-1)."""
    c2w = np.eye(4, dtype=np.float64)
    c2w[:3, :3] = R @ np.diag([1.0, -1.0, -1.0])
    c2w[:3, 3] = T
    return c2w


def sample_surface_points(n: int = 30000, seed: int = 1,
                          texture: bool = False):
    """Analytic surface samples + shaded albedo colors (pure numpy) — the
    stand-in for the SfM/COLMAP seed points real scenes provide.  Written as
    `points3d.ply` which BlenderDataset.get_point_cloud prefers over random
    init."""
    rng = np.random.default_rng(seed)

    def torus(c, R_, r_, m):
        u = rng.uniform(0, 2 * math.pi, m)
        v = rng.uniform(0, 2 * math.pi, m)
        return np.stack([c[0] + (R_ + r_ * np.cos(v)) * np.cos(u),
                         c[1] + r_ * np.sin(v),
                         c[2] + (R_ + r_ * np.cos(v)) * np.sin(u)], axis=1)

    def sphere(c, r_, m):
        d = rng.standard_normal((m, 3))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        return np.asarray(c) + r_ * d

    def box(c, b, m):
        # sample on the 6 faces, area-weighted
        b = np.asarray(b)
        areas = np.array([b[1] * b[2], b[1] * b[2], b[0] * b[2],
                          b[0] * b[2], b[0] * b[1], b[0] * b[1]])
        face = rng.choice(6, m, p=areas / areas.sum())
        p = rng.uniform(-1, 1, (m, 3)) * b
        axis = face // 2
        sign = np.where(face % 2 == 0, 1.0, -1.0)
        p[np.arange(m), axis] = sign * b[axis]
        return np.asarray(c) + p

    # mirror of _build_renderer's object list / albedos (numpy)
    def alb_torus(p):
        ang = np.arctan2(p[:, 2], p[:, 0])
        s = 0.5 + 0.5 * np.sin(6.0 * ang)
        return np.stack([0.85 * s + 0.1, 0.25 + 0.2 * s,
                         0.2 * np.ones_like(s)], axis=1)

    def alb_sphere(p):
        ch = ((np.floor(p[:, 0] * 6) + np.floor(p[:, 1] * 6)
               + np.floor(p[:, 2] * 6)) % 2)
        return np.stack([0.15 + 0.1 * ch, 0.35 + 0.45 * ch,
                         0.8 - 0.3 * ch], axis=1)

    def alb_box(p):
        g = 0.5 + 0.5 * np.sin(10.0 * p[:, 1])
        return np.stack([0.9 * np.ones_like(g), 0.75 * g + 0.15,
                         0.15 + 0.2 * g], axis=1)

    geoms = [
        torus([0.0, -0.15, 0.0], 0.75, 0.22, n * 4 // 10),
        sphere([0.45, 0.38, -0.25], 0.34, n * 2 // 10),
        box([-0.55, 0.25, 0.35], [0.22, 0.3, 0.2], n * 2 // 10),
        sphere([-0.2, -0.1, -0.65], 0.18, n // 20),
        sphere([0.75, -0.35, 0.55], 0.15, n // 20),
        torus([0.05, 0.75, 0.3], 0.3, 0.09, n // 10),
    ]
    if texture:
        def make_tex(i):
            ca, cb = TEX_PALETTES[i]
            return lambda p: _tex_albedo(np, p, ca, cb, TEX_FREQS[i])
        albs = [make_tex(i) for i in range(6)]
    else:
        albs = [alb_torus, alb_sphere, alb_box,
                lambda p: np.tile([0.9, 0.9, 0.25], (len(p), 1)),
                lambda p: np.tile([0.35, 0.9, 0.5], (len(p), 1)),
                lambda p: np.tile([0.55, 0.35, 0.95], (len(p), 1))]
    parts = list(zip(geoms, albs))
    pts = np.concatenate([p for p, _ in parts]).astype(np.float32)
    cols = np.concatenate([a(p) for p, a in parts]).astype(np.float32)
    cols = np.clip(cols * 0.65, 0.0, 1.0)  # typical shading factor
    return pts, cols


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", type=str, default="data/sdf_scene")
    ap.add_argument("--n-train", type=int, default=64)
    ap.add_argument("--n-test", type=int, default=8)
    ap.add_argument("--size", type=int, default=800)
    ap.add_argument("--spp", type=int, default=2)
    ap.add_argument("--radius", type=float, default=3.6)
    ap.add_argument("--points-only", action="store_true",
                    help="only (re)write points3d.ply, no rendering")
    ap.add_argument("--n-points", type=int, default=30000,
                    help="surface samples for the seed point cloud")
    ap.add_argument("--points-name", type=str, default="points3d.ply")
    ap.add_argument("--texture", action="store_true",
                    help="texture-dense albedos (5-15px procedural cells): "
                         "the canonical-densification benchmark variant")
    args = ap.parse_args(argv)

    if args.points_only:
        from mini3dgs_tpu.utils.io import save_ply
        out = Path(args.out)
        out.mkdir(parents=True, exist_ok=True)
        pts, cols = sample_surface_points(n=args.n_points,
                                          texture=args.texture)
        save_ply(pts, cols, str(out / args.points_name))
        print(f"wrote {len(pts)} surface points to {out/args.points_name}")
        return 0

    from PIL import Image

    out = Path(args.out)
    (out / "train").mkdir(parents=True, exist_ok=True)
    (out / "test").mkdir(parents=True, exist_ok=True)

    render = _build_renderer(args.size, args.spp, texture=args.texture)
    rng = np.random.default_rng(0)

    def make_split(name, n, stratified):
        frames = []
        for i in range(n):
            if stratified:  # deterministic spiral over the upper hemisphere
                theta = 2 * math.pi * (i * 0.618034 % 1.0)
                phi = math.radians(10 + 60 * ((i * 0.381966) % 1.0))
            else:
                theta = float(rng.uniform(0, 2 * math.pi))
                phi = float(rng.uniform(math.radians(15), math.radians(65)))
            R, T = camera_pose(theta, phi, args.radius)
            img = np.asarray(render(R, T))
            rgba = (np.clip(img, 0, 1) * 255).astype(np.uint8)
            fname = f"{name}/r_{i}"
            Image.fromarray(rgba).save(out / f"{fname}.png")
            frames.append({"file_path": f"./{fname}",
                           "rotation": 0.0,
                           "transform_matrix": to_blender_c2w(R, T).tolist()})
            print(f"  {fname}: alpha={img[..., 3].mean():.3f}", flush=True)
        meta = {"camera_angle_x": FOVX, "frames": frames}
        with open(out / f"transforms_{name}.json", "w") as f:
            json.dump(meta, f, indent=1)

    print(f"rendering {args.n_train} train views at {args.size}^2 ...",
          flush=True)
    make_split("train", args.n_train, stratified=True)
    print(f"rendering {args.n_test} test views ...", flush=True)
    make_split("test", args.n_test, stratified=False)
    print(f"scene written to {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
