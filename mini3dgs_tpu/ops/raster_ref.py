"""Golden rasterizer: exact reference compositing semantics in pure jnp.

This is the numerical oracle for the raster kernels (BASELINE.md requires the
kernels' forward image *and* pixel gradients to be allclose to it), and the
plain-XLA compute path (`use_pallas=False`).

Reference semantics: `/root/reference/src/core/renderer.py:300-362` — per
pixel, in ascending-depth order: s = d^T Q d, w = clamp(exp(-0.5 s), 0, 1),
skip w < 1e-5, alpha = clamp(op*w, 0, 1), contrib = (1-A)*alpha, accumulate
rgb/alpha/depth, stop once A >= 0.995; then background composited *once*
(reference bug B6 fixed: init to zero, add (1-A)*bg at the end) and expected
depth = D/(A+1e-6) (renderer.py:357-362).

Vectorization: the sequential front-to-back loop is reformulated exactly with
an exclusive cumulative product of (1 - alpha) along the sorted Gaussian axis.
The early-stop `break` is the gate [A_before < 0.995]: since alphas are only
ever zeroed *after* the first crossing, the gated and ungated accumulated
alphas agree everywhere the gate can fire, so using the ungated transmittance
inside the gate reproduces the loop bit-for-bit.  A `lax.scan` over Gaussian
chunks keeps memory at O(pixels * chunk).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

EARLY_STOP_A = 0.995
W_EPS = 1e-5
# The oracle's f32 matmuls are pinned: a default f32 dot runs as TF32 on a
# GPU, about three decimal digits.
_HI = jax.lax.Precision.HIGHEST


def composite_chunk(px: jnp.ndarray, py: jnp.ndarray,
                    x: jnp.ndarray, y: jnp.ndarray,
                    qa: jnp.ndarray, qb: jnp.ndarray, qc: jnp.ndarray,
                    op: jnp.ndarray, valid: jnp.ndarray,
                    T_in: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Shared per-chunk compositing math.

    px/py: [P] pixel coords; gaussian attrs: [G]; T_in: [P] carry transmittance.
    Returns (contrib [P,G], T_out [P]).
    """
    dx = px[:, None] - x[None, :]
    dy = py[:, None] - y[None, :]
    s = dx * dx * qa[None, :] + 2.0 * dx * dy * qb[None, :] + dy * dy * qc[None, :]
    w = jnp.clip(jnp.exp(-0.5 * s), 0.0, 1.0)
    alpha = jnp.clip(op[None, :] * w, 0.0, 1.0)
    valid_b = valid if valid.ndim == 2 else valid[None, :]
    alpha = jnp.where((w >= W_EPS) & valid_b, alpha, 0.0)
    # exclusive cumprod of (1 - alpha) within the chunk
    one_minus = 1.0 - alpha
    cp = jnp.cumprod(one_minus, axis=-1)
    T_excl = jnp.concatenate([jnp.ones_like(cp[:, :1]), cp[:, :-1]], axis=-1)
    T_before = T_in[:, None] * T_excl
    gate = (1.0 - T_before) < EARLY_STOP_A
    contrib = T_before * alpha * gate
    T_out = T_in * cp[:, -1]
    return contrib, T_out


def rasterize_pixels(px: jnp.ndarray, py: jnp.ndarray,
                     means2d: jnp.ndarray, conic: jnp.ndarray,
                     depth: jnp.ndarray, color: jnp.ndarray,
                     opacity: jnp.ndarray, visible: jnp.ndarray,
                     chunk: int = 512, tile_bounds=None, tile_size: int = 16):
    """Composite all Gaussians (depth-sorted internally) onto pixels [P].

    `tile_bounds` = (tx0, tx1, ty0, ty1) inclusive per-Gaussian tile AABBs:
    when given, a Gaussian only composites onto pixels whose tile lies inside
    its AABB — the reference's binning cutoff (renderer.py:277-298), which is
    part of the rendered function, not an optimization (tails beyond ~3 sigma
    are dropped even though their weight can exceed the 1e-5 skip threshold).

    Returns (rgb [P,3], alpha [P], depth_accum [P]) — pre-background,
    pre-normalization.
    """
    C = means2d.shape[0]
    # Depth sort with invisible points pushed to the back and zeroed.
    sort_key = jnp.where(visible, depth, jnp.inf)
    order = jnp.argsort(sort_key)
    x = means2d[order, 0]
    y = means2d[order, 1]
    qa, qb, qc = conic[order, 0], conic[order, 1], conic[order, 2]
    op = opacity[order]
    col = color[order]
    dep = depth[order]
    val = visible[order]
    if tile_bounds is not None:
        tx0, tx1, ty0, ty1 = (b[order] for b in tile_bounds)
        ptx = (px // tile_size).astype(jnp.int32)
        pty = (py // tile_size).astype(jnp.int32)

    pad = (-C) % chunk
    arrays = dict(x=x, y=y, qa=qa, qb=qb, qc=qc, op=op, col=col, dep=dep,
                  val=val)
    if tile_bounds is not None:
        arrays.update(tx0=tx0, tx1=tx1, ty0=ty0, ty1=ty1)
    if pad:
        arrays = {k: (jnp.pad(v, ((0, pad), (0, 0))) if v.ndim == 2
                      else jnp.pad(v, (0, pad)))
                  for k, v in arrays.items()}
    n_chunks = (C + pad) // chunk

    @jax.checkpoint
    def body(carry, ck):
        # remat: the [pixels, chunk] intermediates are recomputed in the
        # backward pass instead of being saved per scan step (without this,
        # autodiff residuals are O(pixels * gaussians) — tens of GB).
        T, rgb, A, D = carry
        cval = ck["val"]
        if tile_bounds is not None:
            inside = ((ptx[:, None] >= ck["tx0"][None, :])
                      & (ptx[:, None] <= ck["tx1"][None, :])
                      & (pty[:, None] >= ck["ty0"][None, :])
                      & (pty[:, None] <= ck["ty1"][None, :]))
            cval = cval[None, :] & inside  # [P, G]
        contrib, T = composite_chunk(px, py, ck["x"], ck["y"], ck["qa"],
                                     ck["qb"], ck["qc"], ck["op"], cval, T)
        rgb = rgb + jnp.matmul(contrib, ck["col"], precision=_HI)
        A = A + contrib.sum(-1)
        D = D + jnp.matmul(contrib, ck["dep"], precision=_HI)
        return (T, rgb, A, D), None

    P = px.shape[0]
    init = (jnp.ones((P,)), jnp.zeros((P, 3)), jnp.zeros((P,)), jnp.zeros((P,)))
    chunked = {k: v.reshape((n_chunks, chunk) + v.shape[1:])
               for k, v in arrays.items()}
    (T, rgb, A, D), _ = jax.lax.scan(body, init, chunked)
    return rgb, A, D


def rasterize_image(means2d, conic, depth, color, opacity, visible,
                    height: int, width: int, bg: jnp.ndarray,
                    radius=None, row0: int = 0, col0: int = 0,
                    chunk: int = 512, tile_size: int = 16,
                    full_height=None, full_width=None,
                    pixel_block: int = 65536):
    """Full-image golden raster. Returns dict(image [3,H,W], alpha [1,H,W],
    depth [1,H,W]).

    When `radius` is given, the reference's tile-AABB binning cutoff
    (renderer.py:277-298) is applied.  row0/col0 offset pixel coordinates for
    tile-sharded sub-images; full_height/full_width are the uncropped image
    dims the reference clamps AABBs against (default: this sub-image)."""
    tile_bounds = None
    if radius is not None:
        from .binning import _tile_bounds
        fh = full_height if full_height is not None else row0 + height
        fw = full_width if full_width is not None else col0 + width
        tx0, tx1, ty0, ty1, degen = _tile_bounds(means2d, radius, fh, fw,
                                                 tile_size)
        visible = visible & ~degen
        tile_bounds = (tx0, tx1, ty0, ty1)
    ys, xs = jnp.meshgrid(jnp.arange(height, dtype=jnp.float32) + row0,
                          jnp.arange(width, dtype=jnp.float32) + col0,
                          indexing="ij")
    px = xs.reshape(-1)
    py = ys.reshape(-1)
    n_pix = height * width
    if n_pix <= pixel_block:
        rgb, A, D = rasterize_pixels(px, py, means2d, conic, depth, color,
                                     opacity, visible, chunk=chunk,
                                     tile_bounds=tile_bounds,
                                     tile_size=tile_size)
    else:
        # Large images: map over pixel blocks to bound the [pixels, chunk]
        # intermediates (the golden path must scale far enough to serve as
        # the baseline oracle at benchmark sizes).
        pad = (-n_pix) % pixel_block
        pxp = jnp.pad(px, (0, pad))
        pyp = jnp.pad(py, (0, pad))
        nb = (n_pix + pad) // pixel_block

        def block(args):
            bx, by = args
            return rasterize_pixels(bx, by, means2d, conic, depth, color,
                                    opacity, visible, chunk=chunk,
                                    tile_bounds=tile_bounds,
                                    tile_size=tile_size)

        rgb, A, D = jax.lax.map(block, (pxp.reshape(nb, pixel_block),
                                        pyp.reshape(nb, pixel_block)))
        rgb = rgb.reshape(-1, 3)[:n_pix]
        A = A.reshape(-1)[:n_pix]
        D = D.reshape(-1)[:n_pix]
    image = rgb + (1.0 - A)[:, None] * bg[None, :]
    image = jnp.clip(image, 0.0, 1.0).reshape(height, width, 3).transpose(2, 0, 1)
    alpha = jnp.clip(A, 0.0, 1.0).reshape(1, height, width)
    depth_out = (D / (A + 1e-6)).reshape(1, height, width)
    return {"image": image, "alpha": alpha, "depth": depth_out}
