"""Photometric loss: (1-lambda)*L1 + lambda*D-SSIM (JAX).

Reference semantics: `/root/reference/src/core/loss.py` — separable Gaussian
blur SSIM with window K=11, sigma = K/6, C1 = 0.01^2, C2 = 0.03^2, SSIM map
clamped to [0,1] (loss.py:14-39; B11 fixed: forward *returns* mean D-SSIM =
1 - mean(ssim)); total = (1-lambda)*L1 + lambda*D-SSIM with lambda = 0.2
(loss.py:56-58).

The separable K=11 blur is an UNROLLED static-slice stencil (one fused
weighted sum of 11 shifted views per direction), not an XLA convolution:
it stays in full f32, fuses with the SSIM map math, and its VJP is the same
stencil transposed (a convolution is the plain alternative; not compared on
the GPU yet).  Everything is pure and jit/vjp friendly.
"""

from __future__ import annotations

from functools import partial
from typing import Dict, Tuple

import jax
import jax.numpy as jnp

C1 = 0.01 ** 2
C2 = 0.03 ** 2


def _gaussian_window(window_size: int) -> jnp.ndarray:
    x = jnp.arange(window_size, dtype=jnp.float32) - (window_size - 1) / 2.0
    g = jnp.exp(-(x ** 2) / (2.0 * (window_size / 6.0) ** 2))
    return g / g.sum()


def _blur1d(img: jnp.ndarray, g1d: jnp.ndarray, axis: int,
            mode: str = "same") -> jnp.ndarray:
    """1-D blur along `axis` as an unrolled static-slice stencil:
    out[x] = sum_k g[k] * in[x + k - pad] ('same', zero padding — identical
    to torch grouped conv2d with padding=K//2, cross-correlation form) or
    the 'valid' restriction (no padding).  Eleven shifted views fuse into
    one elementwise chain; no XLA conv, no bf16 passes."""
    K = g1d.shape[0]
    pad = K // 2
    if mode == "same":
        cfg = [(0, 0)] * img.ndim
        cfg[axis] = (pad, pad)
        src = jnp.pad(img, cfg)
        n_out = img.shape[axis]
    else:  # valid
        src = img
        n_out = img.shape[axis] - 2 * pad
    out = None
    for k in range(K):
        term = g1d[k] * jax.lax.slice_in_dim(src, k, k + n_out, axis=axis)
        out = term if out is None else out + term
    return out


def _blur(img: jnp.ndarray, g1d: jnp.ndarray) -> jnp.ndarray:
    """Separable depthwise blur of [B,C,H,W] with 'same' zero padding
    (matches torch grouped conv2d with padding=K//2, loss.py:25-28)."""
    return _blur1d(_blur1d(img, g1d, axis=3), g1d, axis=2)


@partial(jax.jit, static_argnames=("window_size",))
def ssim(pred: jnp.ndarray, target: jnp.ndarray, window_size: int = 11) -> jnp.ndarray:
    """Mean SSIM over the image. Inputs [C,H,W] or [B,C,H,W]."""
    if pred.ndim == 3:
        pred, target = pred[None], target[None]
    g1d = _gaussian_window(window_size)
    mu_x = _blur(pred, g1d)
    mu_y = _blur(target, g1d)
    sigma_x = _blur(pred ** 2, g1d) - mu_x ** 2
    sigma_y = _blur(target ** 2, g1d) - mu_y ** 2
    sigma_xy = _blur(pred * target, g1d) - mu_x * mu_y
    ssim_map = ((2 * mu_x * mu_y + C1) * (2 * sigma_xy + C2)) / (
        (mu_x ** 2 + mu_y ** 2 + C1) * (sigma_x + sigma_y + C2))
    return jnp.clip(ssim_map, 0.0, 1.0).mean()


def dssim(pred: jnp.ndarray, target: jnp.ndarray, window_size: int = 11) -> jnp.ndarray:
    return 1.0 - ssim(pred, target, window_size)


def gaussian_loss(rendered: jnp.ndarray, target: jnp.ndarray,
                  lambda_dssim: float = 0.2) -> Tuple[jnp.ndarray, Dict[str, jnp.ndarray]]:
    """Total loss and components (reference loss.py:46-63)."""
    l1 = jnp.abs(rendered - target).mean()
    d = dssim(rendered, target)
    total = (1.0 - lambda_dssim) * l1 + lambda_dssim * d
    return total, {"l1": l1, "dssim": d, "total_loss": total}


# ---------------------------------------------------------------------------
# Band-sharded loss with halo exchange (multi-chip path).
#
# The 11x11 SSIM window has radius 5, so each image band can compute its rows
# of the SSIM map EXACTLY from a 5-row halo of (pred, target) exchanged with
# its neighbors — 5*W*3*2 floats per boundary instead of the full
# [3,H,W] all_gather (ROADMAP item: SSIM halo exchange).  `lax.ppermute`
# delivers zeros to devices with no sender, which is exactly the reference's
# zero 'same'-padding at the global image border (loss.py:25-28 semantics).
# ---------------------------------------------------------------------------

HALO = 5  # window_size // 2 for the fixed K=11 reference window


def _blur_x_same_y_valid(img: jnp.ndarray, g1d: jnp.ndarray) -> jnp.ndarray:
    """x-direction 'same' blur then y-direction 'valid' blur of [B,C,H,W].
    On a band extended with HALO true neighbor rows (or zeros at the global
    border) this equals the global 'same'-padded separable blur restricted
    to the band's own rows.  Same unrolled-stencil form as `_blur1d` (and
    the same summation order, so banded == full bit-for-reduction-order)."""
    return _blur1d(_blur1d(img, g1d, axis=3), g1d, axis=2, mode="valid")


def _halo_extend(band: jnp.ndarray, axis_name: str) -> jnp.ndarray:
    """[C,bh,W] -> [C,bh+2*HALO,W] with true neighbor rows over `axis_name`
    (zeros at the ends, matching global zero padding)."""
    n = jax.lax.axis_size(axis_name)
    top, bot = band[:, :HALO], band[:, -HALO:]
    if n == 1:
        z = jnp.zeros_like(top)
        return jnp.concatenate([z, band, z], axis=1)
    # from previous band (i-1 -> i): its bottom rows become our top halo
    prev_bot = jax.lax.ppermute(bot, axis_name,
                                [(i, i + 1) for i in range(n - 1)])
    # from next band (i+1 -> i): its top rows become our bottom halo
    next_top = jax.lax.ppermute(top, axis_name,
                                [(i + 1, i) for i in range(n - 1)])
    return jnp.concatenate([prev_bot, band, next_top], axis=1)


def gaussian_loss_banded(band_pred: jnp.ndarray, band_target: jnp.ndarray,
                         full_height: int, axis_name: str = "tile",
                         lambda_dssim: float = 0.2,
                         window_size: int = 11
                         ) -> Tuple[jnp.ndarray, Dict[str, jnp.ndarray]]:
    """Exact `gaussian_loss` over a band-sharded image, inside shard_map.

    band_pred/band_target: this device's [3, band_h, W] rows.  Returns the
    GLOBAL loss (psum'd over `axis_name`) — bit-equal (up to float reduction
    order) to gaussian_loss on the gathered image."""
    assert window_size == 11, "halo size is derived for the reference K=11"
    C, bh, W = band_pred.shape
    H = full_height
    pred = _halo_extend(band_pred, axis_name)[None]
    target = _halo_extend(band_target, axis_name)[None]
    g1d = _gaussian_window(window_size)

    mu_x = _blur_x_same_y_valid(pred, g1d)
    mu_y = _blur_x_same_y_valid(target, g1d)
    sigma_x = _blur_x_same_y_valid(pred ** 2, g1d) - mu_x ** 2
    sigma_y = _blur_x_same_y_valid(target ** 2, g1d) - mu_y ** 2
    sigma_xy = _blur_x_same_y_valid(pred * target, g1d) - mu_x * mu_y
    ssim_map = ((2 * mu_x * mu_y + C1) * (2 * sigma_xy + C2)) / (
        (mu_x ** 2 + mu_y ** 2 + C1) * (sigma_x + sigma_y + C2))
    ssim_sum = jnp.clip(ssim_map, 0.0, 1.0).sum()
    l1_sum = jnp.abs(band_pred - band_target).sum()

    denom = C * H * W
    l1 = jax.lax.psum(l1_sum, axis_name) / denom
    ssim_mean = jax.lax.psum(ssim_sum, axis_name) / denom
    d = 1.0 - ssim_mean
    total = (1.0 - lambda_dssim) * l1 + lambda_dssim * d
    return total, {"l1": l1, "dssim": d, "total_loss": total}
