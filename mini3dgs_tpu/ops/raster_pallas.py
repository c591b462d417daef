"""Tile-rasterization kernels (Pallas, Triton route) with a hand-written VJP.

This replaces the reference's Python triple loop
(`/root/reference/src/core/renderer.py:300-362`) — the component that is the
CUDA extension `diff-gaussian-rasterization` in the canonical 3DGS ecosystem
(SURVEY §2.4).

Design (one program per image tile, `tile_size**2` pixels held as a [P]
vector; the shape of the 3DGS CUDA rasterizer, written through Pallas):
  * the program loads its own tile_start / tile_count and walks the tile's
    depth-sorted instance slice of the compact stream (ops/binning.py)
    front to back, BLOCK instances at a time, loading each attribute row of
    the block as one masked [BLOCK] vector;
  * per block, the [P, BLOCK] quadratic form / exp / alpha math is
    elementwise; the in-block transmittance is an exclusive cumulative sum
    of log(1 - alpha) (the vectorized equivalent of the sequential loop —
    ops/raster_ref.py holds the equivalence argument);
  * [r, g, b, depth, alpha] accumulate as f32 elementwise row sums (no dot,
    so no TF32 rounding);
  * the loop exits once every pixel of the tile has A >= 0.995 (reference
    renderer.py:316-353).  The per-pixel gate already masks saturated
    pixels, so the exit changes no output.

Backward (custom VJP, original-3DGS style but replayed front to back):
  dL/dalpha_j = u_j*T_j*gate_j - S_j/(1-alpha_j), with u_j = <dOut, c_j> and
  the suffix S_j = <dOut, O_total> - prefix(u*w) read off the saved forward
  output — no division chain, no back-to-front pass.  A stream row belongs
  to at most one tile, so each program stores its instances' gradient rows
  directly, with no atomics, into a zero-initialized output (rows behind the
  early exit or outside every tile's range keep their zero).  Per-rank
  gradients flow back to Gaussians through the hand-written pack backward
  (binning.pack_instances).

Where the kernels run is decided in one place, `kernel_mode`: compiled
through Triton on a GPU, in the Pallas interpreter on the CPU (tests), and
nowhere else.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import dtypes as jax_dtypes
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from . import binning as B
from .projection import Projected
from .raster_ref import EARLY_STOP_A, W_EPS

STREAM_ROWS = B.STREAM_ROWS  # 10 attribute rows per instance
N_ACC = 8          # output rows: r, g, b, depth, alpha, T_out (t0 op), 2 zero

# Instances per loop step: BLOCK = _PAIRS // P, at least 4 and at most 32,
# which bounds the [P, BLOCK] working set of a program.  Measured on an
# H100 (fwd+bwd step, 800x800 / 100K): tile 16 is fastest at 8 (16 and 32
# are slower), tile 32 at 4 (2 and 8 are slower).
_PAIRS = 2048


def kernel_mode(platform: str) -> bool:
    """The one decision point for the raster kernels: returns `interpret`.

    gpu -> compiled Triton kernel (False); cpu -> Pallas interpreter (True,
    what the CPU tests run); any other platform has no kernel and raises —
    nothing falls back to the interpreter or the golden path on a card."""
    if platform == "gpu":
        return False
    if platform == "cpu":
        return True
    raise NotImplementedError(
        f"no raster kernel for platform {platform!r} (gpu or cpu only)")


def _interpret() -> bool:
    return kernel_mode(jax.default_backend())


def _block(P: int) -> int:
    return max(4, min(32, _PAIRS // P))


def _num_warps(P: int) -> int:
    return 4 if P <= 256 else 8


def _pixel_coords(gid, tile_size, tiles_x, P):
    """[P] pixel coordinates of global tile id `gid` (band-local starts and
    counts still address full-image coordinates through `gid`)."""
    p = jnp.arange(P, dtype=jnp.int32)
    px = ((gid % tiles_x) * tile_size + p % tile_size).astype(jnp.float32)
    py = ((gid // tiles_x) * tile_size + p // tile_size).astype(jnp.float32)
    return px, py


def _load_block(inst_ref, start, count, j, blk):
    """The j-th BLOCK of the tile's instances [start, start + count) as ten
    [blk] attribute rows (binning.ROW_* order) and the lane-valid mask.
    Lanes past the tile's count read zeros and are masked out of alpha."""
    k = j * blk + jnp.arange(blk, dtype=jnp.int32)
    valid = k < count
    off = start + j * blk
    rows = [plgpu.load(inst_ref.at[r, pl.ds(off, blk)], mask=valid,
                       other=0.0)
            for r in range(STREAM_ROWS)]
    return rows, valid


def _block_alpha(rows, valid, px, py):
    """Shared fwd/bwd per-block alpha math.  The conic rows are PRE-SCALED
    at pack time (qa, qc by -0.5, qb by -1; see instance_attrs) so the
    quadratic form IS log w; exp >= 0 and op*w >= 0 always, so only the
    upper clamps survive (reference renderer.py:334,339 semantics)."""
    x, y, qa, qb, qc, op = rows[:6]
    dx = px[:, None] - x[None, :]                       # [P, BLOCK]
    dy = py[:, None] - y[None, :]
    lw = dx * dx * qa[None, :] + dx * dy * qb[None, :] + dy * dy * qc[None, :]
    w = jnp.minimum(jnp.exp(lw), 1.0)
    a_raw = op[None, :] * w
    keep = (w >= W_EPS) & valid[None, :]
    alpha = jnp.where(keep, jnp.minimum(a_raw, 1.0), 0.0)
    return dict(dx=dx, dy=dy, w=w, a_raw=a_raw, alpha=alpha, keep=keep)


def _transmittance(alpha, T):
    """(T_before [P, BLOCK] — transmittance before each instance, T_new [P],
    lg = log(1 - alpha)).  The 1e-30 floor keeps log finite at alpha == 1;
    the prefix then underflows exp to 0, matching the product semantics."""
    lg = jnp.log(jnp.maximum(1.0 - alpha, 1e-30))
    incl = jnp.cumsum(lg, axis=1)
    T_before = T[:, None] * jnp.exp(incl - lg)
    T_new = T * jnp.exp(jnp.sum(lg, axis=1))
    return T_before, T_new, lg


def _live(T):
    return jnp.max(T) > (1.0 - EARLY_STOP_A)


# ======================== forward kernel ========================

def _fwd_kernel(inst_ref, ts_ref, tc_ref, gid_ref, *refs, tile_size,
                tiles_x, has_t0):
    # t0_ref [1,1,P]: per-pixel transmittance ENTERING this raster call.
    # Only the ring route (parallel/ring.py) feeds it, chaining the previous
    # depth-rank segment's outgoing transmittance (row 5 of the output), so
    # compositing resumes mid-stream with reference semantics — the early
    # stop sees the GLOBAL accumulated alpha.  The single-pass op is built
    # with has_t0=False: t0 is the constant ones, folded at trace time.
    if has_t0:
        t0_ref, out_ref = refs
    else:
        (out_ref,) = refs
    t = pl.program_id(0)
    start = ts_ref[t]
    count = tc_ref[t]
    P = tile_size * tile_size
    blk = _block(P)
    px, py = _pixel_coords(gid_ref[t], tile_size, tiles_x, P)
    n_blocks = (count + blk - 1) // blk

    def body(carry):
        j, T, acc = carry
        rows, valid = _load_block(inst_ref, start, count, j, blk)
        m = _block_alpha(rows, valid, px, py)
        T_before, T_new, _ = _transmittance(m["alpha"], T)
        gate = (1.0 - T_before) < EARLY_STOP_A
        contrib = jnp.where(gate, T_before * m["alpha"], 0.0)
        r, g, b, d = rows[6:10]
        acc = (acc[0] + jnp.sum(contrib * r[None, :], axis=1),
               acc[1] + jnp.sum(contrib * g[None, :], axis=1),
               acc[2] + jnp.sum(contrib * b[None, :], axis=1),
               acc[3] + jnp.sum(contrib * d[None, :], axis=1),
               acc[4] + jnp.sum(contrib, axis=1))
        return j + 1, T_new, acc

    def cond(carry):
        j, T, _ = carry
        return (j < n_blocks) & _live(T)

    T0 = t0_ref[0, 0, :] if has_t0 else jnp.ones((P,), jnp.float32)
    zero = jnp.zeros((P,), jnp.float32)
    _, T_fin, acc = jax.lax.while_loop(
        cond, body, (jnp.int32(0), T0, (zero,) * 5))
    for c in range(5):
        out_ref[0, c, :] = acc[c]
    out_ref[0, 5, :] = T_fin if has_t0 else zero
    out_ref[0, 6, :] = zero
    out_ref[0, 7, :] = zero


# ======================== backward kernel ========================

def _bwd_kernel(inst_ref, ts_ref, tc_ref, gid_ref, gout_ref, oraw_ref,
                *refs, tile_size, tiles_x, has_t0):
    # dinst_ref is aliased to a zero-filled input: rows the program never
    # stores (behind the early exit, or outside every tile's range) stay 0.
    if has_t0:
        t0_ref, _, dinst_ref, dt0_ref = refs
    else:
        _, dinst_ref = refs
    t = pl.program_id(0)
    start = ts_ref[t]
    count = tc_ref[t]
    P = tile_size * tile_size
    blk = _block(P)
    px, py = _pixel_coords(gid_ref[t], tile_size, tiles_x, P)
    n_blocks = (count + blk - 1) // blk

    gout = [gout_ref[0, c, :] for c in range(N_ACC)]   # [P] cotangent rows
    # total_p = <dOut, O_total> per pixel.  Row 5 carries (gT, T_end): every
    # forward contribution AND T_end scale linearly in the incoming
    # transmittance t0, so `total` is both the suffix-sum seed (S_j =
    # total - incl_j then includes the cross-segment term gT * T_end) and
    # the t0 cotangent: dL/dt0 = total / t0.
    total = gout[0] * oraw_ref[0, 0, :]
    for c in range(1, N_ACC):
        total = total + gout[c] * oraw_ref[0, c, :]
    if has_t0:
        T0 = t0_ref[0, 0, :]
        dt0_ref[0, 0, :] = total / jnp.maximum(T0, 1e-30)
    else:
        T0 = jnp.ones((P,), jnp.float32)

    def body(carry):
        j, T, prefix = carry
        rows, valid = _load_block(inst_ref, start, count, j, blk)
        qa, qb, qc, op = rows[2:6]
        m = _block_alpha(rows, valid, px, py)
        alpha, w = m["alpha"], m["w"]
        T_before, T_new, lg = _transmittance(alpha, T)
        gate = (1.0 - T_before) < EARLY_STOP_A
        wgt = jnp.where(gate, T_before * alpha, 0.0)    # contribution weights
        u = gout[4][:, None]                            # <dOut, c_j>
        for c in range(4):
            u = u + gout[c][:, None] * rows[6 + c][None, :]
        uw = u * wgt
        incl = jnp.cumsum(uw, axis=1) + prefix[:, None]
        S = total[:, None] - incl                       # suffix over i > j
        # 1/(1-alpha) as exp(-lg): at alpha == 1 it is large but finite and
        # the a_raw < 1 mask below zeroes the lane.
        d_alpha = jnp.where(gate, u * T_before, 0.0) - S * jnp.exp(-lg)
        # chain through alpha = clip(op*w, 0, 1) * (w >= eps) * valid
        mask = (m["a_raw"] < 1.0) & (m["a_raw"] > 0.0) & m["keep"]
        d_aw = jnp.where(mask, d_alpha, 0.0)            # d(op*w)
        d_op = jnp.sum(d_aw * w, axis=0)
        # w = min(exp(lw), 1); lw <= 0, so only the upper clamp can bind
        d_lw = jnp.where(w < 1.0, w * d_aw * op[None, :], 0.0)
        dx, dy = m["dx"], m["dy"]
        ldx = d_lw * dx
        ldy = d_lw * dy
        sx = jnp.sum(ldx, axis=0)
        sy = jnp.sum(ldy, axis=0)
        # lw = dx^2 qa + dx dy qb + dy^2 qc; d lw / d x = -(2 dx qa + dy qb)
        vals = [-(2.0 * qa * sx + qb * sy),              # ROW_X
                -(2.0 * qc * sy + qb * sx),              # ROW_Y
                jnp.sum(ldx * dx, axis=0),               # ROW_QA
                jnp.sum(ldx * dy, axis=0),               # ROW_QB
                jnp.sum(ldy * dy, axis=0),               # ROW_QC
                d_op]                                    # ROW_OP
        vals += [jnp.sum(gout[c][:, None] * wgt, axis=0)  # ROW_R..ROW_DEPTH
                 for c in range(4)]
        for r in range(STREAM_ROWS):
            plgpu.store(dinst_ref.at[r, pl.ds(start + j * blk, blk)],
                        vals[r], mask=valid)
        return j + 1, T_new, prefix + jnp.sum(uw, axis=1)

    def cond(carry):
        j, T, _ = carry
        return (j < n_blocks) & _live(T)

    jax.lax.while_loop(cond, body,
                       (jnp.int32(0), T0, jnp.zeros((P,), jnp.float32)))


# ======================== pallas_call wrappers ========================

@functools.lru_cache(maxsize=64)
def _make_raster_op(tiles_x: int, tile_size: int, interpret: bool,
                    has_t0: bool = True):
    """Raster op over a [STREAM_ROWS, K] instance stream.  has_t0=False is
    the single-pass op (inst, tile_start, tile_count, tile_gid) -> [T, 8, P];
    has_t0=True (the ring route) also takes t0 [T, 1, P] and reports the
    outgoing transmittance in output row 5."""
    P = tile_size * tile_size
    assert P & (P - 1) == 0, "tile_size must be a power of two"
    statics = dict(tile_size=tile_size, tiles_x=tiles_x, has_t0=has_t0)
    params = plgpu.CompilerParams(num_warps=_num_warps(P), num_stages=1)

    def whole(x):
        return pl.BlockSpec(x.shape, lambda t: (0,) * x.ndim)

    row_spec = pl.BlockSpec((1, N_ACC, P), lambda t: (t, 0, 0))
    t0_spec = pl.BlockSpec((1, 1, P), lambda t: (t, 0, 0))

    def fwd_call(inst, ts, tc, gid, t0):
        args = (inst, ts, tc, gid) + ((t0,) if has_t0 else ())
        return pl.pallas_call(
            functools.partial(_fwd_kernel, **statics),
            out_shape=jax.ShapeDtypeStruct((ts.shape[0], N_ACC, P),
                                           jnp.float32),
            grid=(ts.shape[0],),
            in_specs=[whole(a) for a in args[:4]]
                     + ([t0_spec] if has_t0 else []),
            out_specs=row_spec,
            backend="triton", interpret=interpret, compiler_params=params,
            name="raster_fwd",
        )(*args)

    def bwd_call(inst, ts, tc, gid, t0, gout, oraw):
        args = ((inst, ts, tc, gid, gout, oraw) + ((t0,) if has_t0 else ())
                + (jnp.zeros(inst.shape, jnp.float32),))
        d_inst = jax.ShapeDtypeStruct(inst.shape, jnp.float32)
        out_shape = (d_inst,)
        out_specs = (whole(d_inst),)
        if has_t0:
            out_shape += (jax.ShapeDtypeStruct(t0.shape, jnp.float32),)
            out_specs += (t0_spec,)
        outs = pl.pallas_call(
            functools.partial(_bwd_kernel, **statics),
            out_shape=out_shape,
            grid=(ts.shape[0],),
            in_specs=[whole(a) for a in args[:4]] + [row_spec, row_spec]
                     + ([t0_spec] if has_t0 else []) + [whole(inst)],
            out_specs=out_specs,
            input_output_aliases={len(args) - 1: 0},
            backend="triton", interpret=interpret, compiler_params=params,
            name="raster_bwd",
        )(*args)
        return outs

    def int_zeros(ts):
        return np.zeros(ts.shape, jax_dtypes.float0)

    if has_t0:
        @jax.custom_vjp
        def raster_op(inst, ts, tc, gid, t0):
            return fwd_call(inst, ts, tc, gid, t0)

        def raster_fwd(inst, ts, tc, gid, t0):
            out = fwd_call(inst, ts, tc, gid, t0)
            return out, (inst, ts, tc, gid, t0, out)

        def raster_bwd(res, gout):
            inst, ts, tc, gid, t0, oraw = res
            d_inst, d_t0 = bwd_call(inst, ts, tc, gid, t0, gout, oraw)
            z = int_zeros(ts)
            return d_inst, z, z, z, d_t0
    else:
        @jax.custom_vjp
        def raster_op(inst, ts, tc, gid):
            return fwd_call(inst, ts, tc, gid, None)

        def raster_fwd(inst, ts, tc, gid):
            out = fwd_call(inst, ts, tc, gid, None)
            return out, (inst, ts, tc, gid, out)

        def raster_bwd(res, gout):
            inst, ts, tc, gid, oraw = res
            (d_inst,) = bwd_call(inst, ts, tc, gid, None, gout, oraw)
            z = int_zeros(ts)
            return d_inst, z, z, z

    raster_op.defvjp(raster_fwd, raster_bwd)
    return raster_op


def instance_attrs(proj: Projected, row0=0, col0=0) -> jnp.ndarray:
    """[C, STREAM_ROWS] per-Gaussian attribute matrix in the kernels' row
    layout (binning.ROW_*), coordinates rebased to (row0, col0).  The conic
    rows are pre-scaled (qa, qc by -0.5, qb by -1) so the kernel's quadratic
    form IS log w (see _block_alpha); the pack VJP chains the scale back."""
    return jnp.stack([
        proj.means2d[:, 0] - jnp.float32(col0),    # ROW_X
        proj.means2d[:, 1] - jnp.float32(row0),    # ROW_Y
        -0.5 * proj.conic[:, 0],
        -proj.conic[:, 1],
        -0.5 * proj.conic[:, 2],
        proj.opacity,
        proj.color[:, 0], proj.color[:, 1], proj.color[:, 2],
        proj.depth,
    ], axis=1)


def compose_tiles(acc: jnp.ndarray, tiles_y: int, tiles_x: int,
                  tile_size: int, H: int, W: int, bg: jnp.ndarray) -> dict:
    """[T, 8, P] per-tile accumulators -> image / alpha / depth (background
    composited once, expected depth D / (A + 1e-6); reference
    renderer.py:357-362), cropped to H x W."""
    img = acc.reshape(tiles_y, tiles_x, N_ACC, tile_size, tile_size)
    img = img.transpose(2, 0, 3, 1, 4).reshape(
        N_ACC, tiles_y * tile_size, tiles_x * tile_size)[:, :H, :W]
    rgb, D, A = img[0:3], img[3], img[4]
    image = jnp.clip(rgb + (1.0 - A)[None] * bg[:, None, None], 0.0, 1.0)
    return {"image": image, "alpha": jnp.clip(A, 0.0, 1.0)[None],
            "depth": (D / (A + 1e-6))[None]}


def rasterize_tiles(proj: Projected, H: int, W: int, bg: jnp.ndarray, *,
                    tile_size: int = 16, max_instances: int = 2 ** 18,
                    gaussian_chunk: int = 256, row0=0, col0=0,
                    full_height: int = None, full_width: int = None,
                    radius_max: float = 50.0, max_dup_per_axis: int = 0,
                    large_capacity: int = 0,
                    shard_axis: str = None, n_shards: int = 1,
                    exact_cull: bool = True,
                    interpret=None) -> dict:
    """Full kernel raster path: binning -> pack -> tile kernel -> epilogue.
    Differentiable w.r.t. `proj` fields (the pack is a gather with a
    hand-written backward, binning.pack_instances).

    `gaussian_chunk` is the stream's padding granule: the instance stream
    length is a multiple of it.  row0/col0 (traced OK, tile_size multiples)
    select a band of a full_height x full_width image — the tile-sharded
    path.  With `shard_axis`/`n_shards` (inside shard_map, horizontal bands,
    col0=0) the candidate sort itself is sharded over the mesh and
    instances are routed home with one all_to_all
    (binning.bin_gaussians_sharded)."""
    if interpret is None:
        interpret = _interpret()
    tiles_x = -(-W // tile_size)
    tiles_y = -(-H // tile_size)
    num_tiles = tiles_x * tiles_y
    G = gaussian_chunk
    C = proj.means2d.shape[0]
    fh = full_height if full_height is not None else H
    fw = full_width if full_width is not None else W
    gtiles = (-(-fh // tile_size)) * (-(-fw // tile_size))
    use_sharded = (shard_axis is not None and n_shards > 1
                   and C % n_shards == 0 and (gtiles + 1) * C < 2 ** 31
                   and fh == H * n_shards)
    if use_sharded:
        b = B.bin_gaussians_sharded(proj, H, W, tile_size, max_instances, G,
                                    shard_axis, n_shards,
                                    radius_max=radius_max,
                                    full_height=fh, full_width=fw,
                                    max_dup_per_axis=max_dup_per_axis,
                                    large_capacity=large_capacity,
                                    exact_cull=exact_cull)
        per_axis = B._per_axis_bound(radius_max, tile_size, max_dup_per_axis,
                                     -(-fw // tile_size), -(-fh // tile_size))
    else:
        b = B.bin_gaussians(proj, H, W, tile_size, max_instances, G,
                            radius_max=radius_max, row0=row0, col0=col0,
                            full_height=full_height, full_width=full_width,
                            max_dup_per_axis=max_dup_per_axis,
                            large_capacity=large_capacity,
                            exact_cull=exact_cull)
        per_axis = B._per_axis_bound(radius_max, tile_size, max_dup_per_axis,
                                     tiles_x, tiles_y)
    # binning rebases instance coordinates to the band, so the kernel always
    # rasterizes at local origin.  Stream rows past n_live hold stale copies
    # that no tile's [start, start + count) window reaches.
    inst = B.pack_instances(instance_attrs(proj, row0, col0), b.s_rank,
                            b.rank_perm, b.rank_key, b.seg_start_gid,
                            b.counts_gid, b.order, b.n_live,
                            per_axis * per_axis)           # [10, K]
    op = _make_raster_op(tiles_x, tile_size, interpret, has_t0=False)
    tile_gid = jnp.arange(num_tiles, dtype=jnp.int32)
    acc = op(inst, b.tile_start, b.tile_count, tile_gid)  # [T, 8, P]
    out = compose_tiles(acc, tiles_y, tiles_x, tile_size, H, W, bg)
    # n_dropped: instances lost to stream-capacity overflow (the render and
    # its gradients miss them; trainers surface it).  n_live, the live
    # stream occupancy, drives the trainer's automatic max_instances sizing.
    out.update(n_dropped=jax.lax.stop_gradient(b.n_dropped),
               n_dropped_large=jax.lax.stop_gradient(b.n_dropped_large),
               n_large=jax.lax.stop_gradient(b.n_large),
               n_live=jax.lax.stop_gradient(b.n_live))
    return out
