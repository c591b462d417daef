"""Differentiable renderer: projection -> cull -> sort -> tile raster -> blend.

Reference API surface: `/root/reference/src/core/renderer.py:13-114`
(`RenderSettings`, `GaussianRenderer.render` returning image/alpha/depth/
viewspace_points/visibility_filter/radii/conics).  Functional here: pure
`render(gaussians, camera, settings) -> dict`, jit/grad/shard_map friendly.

Two compute paths:
  * golden  — vectorized jnp (ops/raster_ref.py), XLA autodiff end to end.
  * pallas  — tile binning + Pallas (Triton) raster kernels with a
              hand-written VJP
              (ops/binning.py, ops/raster_pallas.py).
Both share the projection op and are validated against each other in tests.
"""

from __future__ import annotations

from typing import Optional

import jax.numpy as jnp
from .. import struct

from ..core.camera import Camera
from ..core.gaussians import Gaussians
from . import raster_ref
from .projection import project_gaussians


@struct.dataclass
class RenderSettings:
    """Reference RenderSettings (renderer.py:13-20) + kernel path knobs."""

    image_height: int = struct.field(pytree_node=False, default=256)
    image_width: int = struct.field(pytree_node=False, default=256)
    bg_color: jnp.ndarray = struct.field(
        default_factory=lambda: jnp.zeros((3,), jnp.float32))
    scale_modifier: float = struct.field(pytree_node=False, default=1.0)
    debug: bool = struct.field(pytree_node=False, default=False)
    # kernel path knobs
    tile_size: int = struct.field(pytree_node=False, default=16)
    radius_min: float = struct.field(pytree_node=False, default=0.01)
    radius_max: float = struct.field(pytree_node=False, default=50.0)
    color_mode: str = struct.field(pytree_node=False, default="dc_sigmoid")
    sh_degree: int = struct.field(pytree_node=False, default=0)
    # Mip-splatting antialiasing: dilate Sigma2D by the 0.3px^2 pixel filter
    # and scale opacity by sqrt(det ratio).  Off by default (reference
    # semantics, renderer.py:179-186, add only the 1e-6 stabilizer).
    antialias: bool = struct.field(pytree_node=False, default=False)
    use_pallas: bool = struct.field(pytree_node=False, default=False)
    max_instances: int = struct.field(pytree_node=False, default=2 ** 18)
    # the instance stream's padding granule: its length is a multiple of it
    gaussian_chunk: int = struct.field(pytree_node=False, default=256)
    # 0 = derive from radius_max (exact); >0 trades completeness of huge
    # splats for a (value/8)^2-smaller candidate sort (drops counted)
    max_dup_per_axis: int = struct.field(pytree_node=False, default=0)
    # capacity of the two-level binning's large-gaussian (span > 2x2) slot
    # pool; 0 = C/8.  Overflow drops are counted in binning n_dropped.
    large_capacity: int = struct.field(pytree_node=False, default=0)
    # Pixel-block width of the golden (XLA oracle) path's lax.map — smaller
    # blocks bound the dense [pixels, chunk] autodiff working set.
    golden_pixel_block: int = struct.field(pytree_node=False, default=65536)
    # Exact ellipse-vs-tile candidate culling at emission: output- and
    # gradient-identical (prunes only whole tiles below the reference's
    # w < W_EPS skip cutoff); anisotropic splats emit far fewer instances.
    exact_tile_cull: bool = struct.field(pytree_node=False, default=True)
    # Tile-sharding offsets: this invocation renders rows [row0, row0+H).
    row0: int = struct.field(pytree_node=False, default=0)
    col0: int = struct.field(pytree_node=False, default=0)
    # Ring exchange for the tile-sharded raster (parallel/ring.py): instances
    # partitioned by depth-rank range, exchanged around the tile ring with
    # per-pixel transmittance carried across steps (vs. the default one-shot
    # all_to_all home routing).  Only affects sharded (mesh) rendering.
    ring: bool = struct.field(pytree_node=False, default=False)
    # Per-(band, rank-range) segment capacity of the ring stream; 0 derives
    # max_instances // n_shards (chunk-aligned).  Overflow drops counted.
    ring_capacity: int = struct.field(pytree_node=False, default=0)
    # Ring v2 (ROADMAP item 6 follow-up): reshard the projected rows by
    # depth-rank range before origin binning, so every per-Gaussian stage
    # downstream of projection (emission grids, candidate sort, pack) works
    # on ~C/n rows per device instead of C.  Output-identical to ring v1
    # (same candidate multiset per origin, same keys); gradients flow back
    # through the routing all_to_all's transpose.
    ring_reshard: bool = struct.field(pytree_node=False, default=False)
    # Ring v3 (gauss-sharded step only): feed the ring the LOCAL gid-block
    # projection directly — depth KEYS are all_gathered alone and the rows
    # route through a bucket-compacted all_to_all, so no per-device array
    # with leading dim C exists except [C] key/rank vectors (O(C/n)
    # ACTIVATIONS, not just state; parallel/ring.py gid_sharded).
    ring_local: bool = struct.field(pytree_node=False, default=False)
    # Per-destination row capacity of the v3 reshard buckets; 0 = 4x the
    # uniform mean (C/n^2).  Overflow rows dropped + counted in n_dropped.
    ring_reshard_capacity: int = struct.field(pytree_node=False, default=0)


def render(gaussians: Gaussians, camera: Camera,
           settings: Optional[RenderSettings] = None,
           means2d_probe: Optional[jnp.ndarray] = None) -> dict:
    """Render one view.  Returns the reference's output dict
    (renderer.py:106-114): image [3,H,W], alpha [1,H,W], depth [1,H,W],
    viewspace_points [C,2], visibility_filter [C], radii [C], conics [C,3].

    `means2d_probe` ([C,2], zeros): added to the projected pixel means, so
    its gradient is the VIEWSPACE positional gradient — the quantity
    canonical 3DGS accumulates for densification (SURVEY §2.2; the
    reference declares the stat buffers but never wires them)."""
    if settings is None:
        settings = RenderSettings(image_height=camera.height,
                                  image_width=camera.width)
    H, W = settings.image_height, settings.image_width
    bg = jnp.asarray(settings.bg_color, jnp.float32)

    proj = project_gaussians(
        gaussians, camera,
        radius_min=settings.radius_min, radius_max=settings.radius_max,
        color_mode=settings.color_mode, sh_degree=settings.sh_degree,
        scale_modifier=settings.scale_modifier,
        antialias=settings.antialias)
    if means2d_probe is not None:
        # the exact-cull half-extents are center-relative, so they remain
        # valid under the (identically zero) probe offset
        proj = proj._replace(means2d=proj.means2d + means2d_probe)

    if settings.use_pallas:
        from .raster_pallas import rasterize_tiles
        out = rasterize_tiles(proj, H, W, bg,
                              tile_size=settings.tile_size,
                              max_instances=settings.max_instances,
                              gaussian_chunk=settings.gaussian_chunk,
                              radius_max=settings.radius_max,
                              max_dup_per_axis=settings.max_dup_per_axis,
                              large_capacity=settings.large_capacity,
                              exact_cull=settings.exact_tile_cull,
                              row0=settings.row0, col0=settings.col0)
    else:
        out = raster_ref.rasterize_image(
            proj.means2d, proj.conic, proj.depth, proj.color, proj.opacity,
            proj.visible, H, W, bg, radius=proj.radius,
            row0=settings.row0, col0=settings.col0,
            tile_size=settings.tile_size,
            pixel_block=settings.golden_pixel_block)

    return {
        "image": out["image"],
        "alpha": out["alpha"],
        "depth": out["depth"],
        "viewspace_points": proj.means2d,
        "visibility_filter": proj.visible,
        "radii": proj.radius,
        "conics": proj.conic,
        # instance-stream overflow count (0 on the golden path, which has no
        # stream capacity); trainers surface it so undersized max_instances
        # cannot silently degrade gradients
        "n_dropped": out.get("n_dropped", jnp.int32(0)),
        # live instance-stream occupancy (Pallas path; 0 on golden) — the
        # trainer's auto max_instances sizing reads it
        "n_live": out.get("n_live", jnp.int32(0)),
        # large-pool (two-level C_L) share of n_dropped -- a different
        # capacity knob (large_capacity): the auto-sizer must grow it, not
        # the stream, when this is the nonzero component
        "n_dropped_large": out.get("n_dropped_large", jnp.int32(0)),
        # large-pool OCCUPANCY (gaussians with tile span > 2x2 this render;
        # Pallas two-level path only) — the auto large_capacity sizer reads
        # it to shrink oversized pools, which drops alone cannot signal
        "n_large": out.get("n_large", jnp.int32(0)),
    }
