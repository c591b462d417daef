"""Ring exchange of depth-rank-range instance segments (SURVEY §2.5).

This is the workload's ring-attention analog: the tile-sharded devices
exchange *sorted Gaussian instance chunks* around the ring so each image
band composites every overlapping Gaussian without a single one-shot
home-routing collective — each exchange hop can overlap the raster of the
previous chunk on multi-card hardware (reference contrast: nothing to
exchange, single device at `/root/reference/src/core/renderer.py:28`).

Why DEPTH-RANK-RANGE partitioning (and not gaussian-id shards, as the
all_to_all route uses): front-to-back "over" compositing is associative but
NOT commutative, so a band can only consume exchange steps incrementally if
step s's instances sit strictly behind steps < s in depth everywhere.
Partitioning the global depth order into n contiguous rank ranges gives
exactly that; the per-pixel transmittance at the end of range s-1 is the
initial transmittance of range s (kernel t0 chaining, raster_pallas).

Schedule (device i = image-band owner i = rank-range owner i):
  1. origin: bin + pack MY rank range's instances for ALL bands
     (ops/binning.bin_gaussians_ring_origin) — n fixed-capacity segments.
  2. pre-placement all_to_all: segment (band b, range r) -> device
     (b + r) mod n, so every device starts holding one segment per band
     and the buffers form a ring schedule.
  3. n unrolled steps: raster buffer entry s (which at step s is MY band's
     range-s segment) with carried transmittance, then ppermute the
     not-yet-consumed entries one hop backward (j -> j-1).  On real
     hardware the ppermute of step s+1's data overlaps step s's raster.

Output differs from the one-shot route only by f32 association at segment
boundaries (the monolithic stream groups chunks differently); gradients
flow through the ppermute/all_to_all transposes back to the origin packs.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..ops import binning as B
from ..ops import raster_pallas as RP
from ..ops.projection import Projected


def ring_rasterize_band(proj: Projected, band_h: int, W: int,
                        bg: jnp.ndarray, *, axis_name: str, n_shards: int,
                        tile_size: int = 16, max_instances: int = 2 ** 18,
                        gaussian_chunk: int = 256,
                        radius_max: float = 50.0, max_dup_per_axis: int = 0,
                        large_capacity: int = 0, exact_cull: bool = True,
                        ring_capacity: int = 0, reshard: bool = False,
                        gid_sharded: bool = False,
                        reshard_capacity: int = 0,
                        interpret=None) -> dict:
    """Render this device's image band (rows [i*band_h, (i+1)*band_h) of the
    full band_h*n x W image) via the ring schedule.  Must be called inside
    shard_map over `axis_name`.

    `proj` is the full (replicated) projected set, as in the all_to_all
    route — UNLESS `gid_sharded=True` (ring v3, VERDICT r3 missing #3):
    then `proj` holds only this device's LOCAL gid block (global gids
    [i*Cs, (i+1)*Cs), Cs = C/n) and NO per-device array with leading dim C
    is ever materialized (tests/test_ring.py walks the jaxpr to enforce
    it): global depth ranks come from the ring-rotation counting sort
    (binning.distributed_ranks, peak O(Cs)), rows route to their
    rank-range owners through the bucket-compacted all_to_all
    (binning.rank_reshard_rows_compact, buffers [n, reshard_capacity, 16]),
    and every per-Gaussian stage runs at Cs rows.  Invisible rows are
    excluded from the reshard (sentinel rank; ADVICE r4): only VISIBLE
    bucket overflow is dropped, surfaced as the separate `reshard_drops`
    output (Gaussian ROWS, not stream instances — different units than
    `n_dropped`; default capacity 4x the uniform mean Cs/n)."""
    if interpret is None:
        interpret = RP._interpret()
    n = n_shards
    H = band_h * n
    G = gaussian_chunk
    Cs_in = proj.means2d.shape[0]
    C = Cs_in * n if gid_sharded else Cs_in
    gtx = -(-W // tile_size)
    gty = -(-H // tile_size)
    ntb = (band_h // tile_size) * gtx          # tiles per band
    P = tile_size * tile_size
    Q = ring_capacity if ring_capacity > 0 else max(max_instances // n, G)
    Q = ((Q + G - 1) // G) * G
    i = jax.lax.axis_index(axis_name)

    # ---- origin: bin + pack MY rank range for all bands ----
    per_axis = B._per_axis_bound(radius_max, tile_size, max_dup_per_axis,
                                 gtx, gty)
    reshard_drops = jnp.int32(0)
    if gid_sharded:
        # v3: O(C/n) activations AND zero [C] arrays (VERDICT r4 next #3):
        # ranks come from the ring-rotation counting sort on local blocks;
        # invisible rows get a sentinel rank and never enter the reshard.
        Cs = Cs_in
        assert C % n == 0
        rank_local = B.distributed_ranks(proj.depth, proj.visible,
                                         axis_name, n)
        zero = jnp.zeros((Cs,), jnp.float32)
        ext_x = proj.ext_x if proj.ext_x is not None else zero
        ext_y = proj.ext_y if proj.ext_y is not None else zero
        mat = jnp.stack([
            proj.means2d[:, 0], proj.means2d[:, 1],
            proj.conic[:, 0], proj.conic[:, 1], proj.conic[:, 2],
            proj.depth, proj.radius, proj.visible.astype(jnp.float32),
            proj.color[:, 0], proj.color[:, 1], proj.color[:, 2],
            proj.opacity, ext_x, ext_y, zero, zero], axis=1)    # [Cs, 16]
        cap = reshard_capacity if reshard_capacity > 0 else 4 * (-(-Cs // n))
        cmp, reshard_drops = B.rank_reshard_rows_compact(
            mat, rank_local, axis_name, n, cap)
        proj_r = Projected(
            means2d=cmp[:, 0:2], conic=cmp[:, 2:5], depth=cmp[:, 5],
            radius=cmp[:, 6], visible=cmp[:, 7] > 0.5,
            color=cmp[:, 8:11], opacity=cmp[:, 11],
            ext_x=cmp[:, 12] if proj.ext_x is not None else None,
            ext_y=cmp[:, 13] if proj.ext_y is not None else None)
        rb = B.bin_gaussians_ring_origin_resharded(
            proj_r, i * Cs, C, H, W, tile_size, Q, G, n,
            radius_max=radius_max, max_dup_per_axis=max_dup_per_axis,
            large_capacity=large_capacity, exact_cull=exact_cull)
        attrs = RP.instance_attrs(proj_r)                  # [Cs, 10] local
    elif reshard:
        # v2: route each projected row to its rank-range owner first, so
        # emission/sort/pack below run on Cs = C/n rows (v1 restricts the
        # full replicated set instead — O(C) per-Gaussian stages).  Same
        # candidate keys (tile*C + GLOBAL rank) => bit-identical segments.
        assert C % n == 0, "capacity must divide over the ring devices"
        Cs = C // n
        depth_key = jnp.where(proj.visible, proj.depth, jnp.inf)
        order = jax.lax.sort(
            (depth_key, jnp.arange(C, dtype=jnp.int32)), num_keys=1)[1]
        rank = B._inverse_permutation(order)               # [C] replicated
        rank_local = jax.lax.dynamic_slice_in_dim(rank, i * Cs, Cs)

        def loc(x):
            return jax.lax.dynamic_slice_in_dim(x, i * Cs, Cs, axis=0)

        zero = jnp.zeros((Cs,), jnp.float32)
        ext_x = loc(proj.ext_x) if proj.ext_x is not None else zero
        ext_y = loc(proj.ext_y) if proj.ext_y is not None else zero
        mat = jnp.stack([
            loc(proj.means2d)[:, 0], loc(proj.means2d)[:, 1],
            loc(proj.conic)[:, 0], loc(proj.conic)[:, 1],
            loc(proj.conic)[:, 2], loc(proj.depth), loc(proj.radius),
            loc(proj.visible).astype(jnp.float32),
            loc(proj.color)[:, 0], loc(proj.color)[:, 1],
            loc(proj.color)[:, 2], loc(proj.opacity),
            ext_x, ext_y, zero, zero], axis=1)             # [Cs, 16]
        cmp = B.rank_reshard_rows(mat, rank_local, axis_name, n)
        proj_r = Projected(
            means2d=cmp[:, 0:2], conic=cmp[:, 2:5], depth=cmp[:, 5],
            radius=cmp[:, 6], visible=cmp[:, 7] > 0.5,
            color=cmp[:, 8:11], opacity=cmp[:, 11],
            ext_x=cmp[:, 12] if proj.ext_x is not None else None,
            ext_y=cmp[:, 13] if proj.ext_y is not None else None)
        rb = B.bin_gaussians_ring_origin_resharded(
            proj_r, i * Cs, C, H, W, tile_size, Q, G, n,
            radius_max=radius_max, max_dup_per_axis=max_dup_per_axis,
            large_capacity=large_capacity, exact_cull=exact_cull)
        attrs = RP.instance_attrs(proj_r)                  # [Cs, 10] local
    else:
        rb = B.bin_gaussians_ring_origin(
            proj, H, W, tile_size, Q, G, axis_name, n,
            radius_max=radius_max, max_dup_per_axis=max_dup_per_axis,
            large_capacity=large_capacity, exact_cull=exact_cull)
        attrs = RP.instance_attrs(proj)                    # global [C, 10]
    inst = B.pack_instances(attrs, rb.flat_rank, rb.rank_perm, rb.rank_key,
                            rb.seg_start_gid, rb.counts_gid, rb.order,
                            rb.n_live, per_axis * per_axis)   # [10, n*Q]
    inst = inst.reshape(B.STREAM_ROWS, n, Q).transpose(1, 0, 2)

    # ---- pre-placement: segment b -> device (b + i) mod n ----
    src = (jnp.arange(n, dtype=jnp.int32) - i) % n   # send[d] = seg[(d-i)%n]
    send_inst = jnp.take(inst, src, axis=0)
    send_ts = jnp.take(rb.tile_start, src, axis=0)
    send_tc = jnp.take(rb.tile_count, src, axis=0)
    a2a = lambda x: jax.lax.all_to_all(x, axis_name, split_axis=0,
                                       concat_axis=0, tiled=True)
    rb_inst = a2a(send_inst)                   # [n, 10, Q]
    rb_ts = a2a(send_ts)                       # [n, ntb]
    rb_tc = a2a(send_tc)
    # entry r at device j now holds (band (j - r) mod n, range r); after s
    # backward shifts, entry s is (band j, range s) — the ring invariant.

    # ---- ring steps: raster entry s with carried T, shift the rest ----
    op = RP._make_raster_op(gtx, tile_size, interpret, has_t0=True)
    tile_gid = i * ntb + jnp.arange(ntb, dtype=jnp.int32)  # global tile ids
    perm = [(j, (j - 1) % n) for j in range(n)]
    T = jnp.ones((ntb, 1, P), jnp.float32)
    acc = jnp.zeros((ntb, RP.N_ACC, P), jnp.float32)
    for s in range(n):
        # entry 0 is (MY band, range s) by the ring invariant
        out = op(rb_inst[0], rb_ts[0], rb_tc[0], tile_gid, T)
        acc = acc + out.at[:, 5:6, :].set(0.0)
        T = out[:, 5:6, :]
        if s + 1 < n:
            # Drop the consumed entry; shift the rest one hop backward.
            # Every hop's ppermute consumes only pre-placement buffers and
            # earlier hops — never a raster output — so a latency-hiding
            # scheduler is free to run the exchange under the raster.  Hop
            # s moves a (n-1-s)/n shrinking buffer.
            rb_inst = jax.lax.ppermute(rb_inst[1:], axis_name, perm)
            rb_ts = jax.lax.ppermute(rb_ts[1:], axis_name, perm)
            rb_tc = jax.lax.ppermute(rb_tc[1:], axis_name, perm)

    out = RP.compose_tiles(acc, band_h // tile_size, gtx, tile_size, band_h,
                           W, bg)
    # origin-local overflow count (this device's rank range, all bands) —
    # same per-device semantics as the one-shot sharded route; callers psum
    # over the axis for the per-camera total (trainer metric render_drops).
    # reshard_drops is SEPARATE (ADVICE r4: it counts dropped Gaussian ROWS
    # in the v3 rank reshard, a different unit than n_dropped's stream
    # instances — summing them made capacity sizing uninterpretable).
    out.update(n_dropped=jax.lax.stop_gradient(rb.n_dropped),
               n_live=jax.lax.stop_gradient(rb.n_live),
               reshard_drops=jax.lax.stop_gradient(reshard_drops))
    return out
