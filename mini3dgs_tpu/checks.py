"""Checks of the kernel raster path against the plain reference.

Shared by `chip_smoke.py` (on the card, at real widths) and the card-only
tests (`tests/test_gpu.py`, at small widths).  Each gate prints its
tolerance with the reason for it; a failed gate raises `CheckFailed`.

The reference is `ops/raster_ref.py` (every Gaussian against every pixel,
matmuls pinned to HIGHEST).  Two correct implementations still differ on
isolated entries: the early-stop gate (T < 0.005) and the W_EPS skip are
cliffs, and a last-bit difference in exp or in summation order flips them
for barely-gated instances.  `calibrate` measures that floor for a scene as
reference-on-this-device against reference-on-CPU, and the gradient gates
are set relative to it.
"""

from __future__ import annotations

import math
import time
from typing import Callable, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

GROUPS = ("xyz", "scaling", "rotation", "opacity", "features_dc",
          "features_rest")


class CheckFailed(AssertionError):
    pass


def population(capacity: int, n: int, width: int, height: int, seed: int = 0,
               aniso: bool = False):
    """The synthetic population (host-side numpy): n Gaussians uniform in a
    2-unit cube, sigma 0.02, random rotations and colors, seen from 3 units
    away with a 60 degree field of view.  `aniso` elongates the sigmas
    (x1.57, x0.33, x0.33): the AABB then overlaps tiles the ellipse misses,
    the regime of trained scenes."""
    from .core.camera import Camera
    from .core.gaussians import Gaussians

    rng = np.random.default_rng(seed)
    xyz = np.zeros((capacity, 3), np.float32)
    xyz[:n] = (rng.random((n, 3)) - 0.5) * 2.0
    fdc = np.zeros((capacity, 1, 3), np.float32)
    fdc[:n] = rng.random((n, 1, 3))
    frest = np.zeros((capacity, 15, 3), np.float32)
    scal = np.full((capacity, 3), -10.0, np.float32)
    scal[:n] = math.log(0.02)
    if aniso:
        scal[:n] += np.array([0.45, -1.1, -1.1], np.float32)
    rot = np.zeros((capacity, 4), np.float32)
    rot[:, 0] = 1.0
    q = rng.standard_normal((n, 4)).astype(np.float32)
    rot[:n] = q / np.linalg.norm(q, axis=-1, keepdims=True)
    opac = np.full((capacity, 1), -10.0, np.float32)
    opac[:n] = -2.0
    alive = np.zeros(capacity, bool)
    alive[:n] = True
    g = Gaussians(
        xyz=jnp.asarray(xyz), features_dc=jnp.asarray(fdc),
        features_rest=jnp.asarray(frest), scaling=jnp.asarray(scal),
        rotation=jnp.asarray(rot), opacity=jnp.asarray(opac),
        alive=jnp.asarray(alive),
        xyz_gradient_accum=jnp.zeros(capacity),
        denom=jnp.zeros(capacity), max_radii2D=jnp.zeros(capacity))
    cam = Camera.create(0, np.eye(3), np.array([0.0, 0.0, -3.0]),
                        math.radians(60), math.radians(60),
                        width=width, height=height)
    return g, cam


def settings(width: int, height: int, tile_size: int, use_pallas: bool,
             max_instances: int = 2 ** 18, max_dup_per_axis: int = 0,
             sh_degree: int = 3, **kw):
    from .ops.renderer import RenderSettings
    return RenderSettings(image_height=height, image_width=width,
                          tile_size=tile_size, use_pallas=use_pallas,
                          max_instances=max_instances, gaussian_chunk=256,
                          max_dup_per_axis=max_dup_per_axis,
                          color_mode="sh" if sh_degree else "dc_sigmoid",
                          sh_degree=sh_degree, **kw)


def sized_stream(g, cam, st, headroom: float = 1.25):
    """(`st` with max_instances sized to the scene, live instances): one
    projection and binning pass (no raster), growing the stream or the
    large-splat pool until nothing is dropped — the comparison with the
    reference is only valid without drops."""
    from .ops import binning as B
    from .ops.projection import project_gaussians

    proj = jax.jit(lambda gg, cc: project_gaussians(
        gg, cc, radius_min=st.radius_min, radius_max=st.radius_max,
        color_mode=st.color_mode, sh_degree=st.sh_degree))(g, cam)
    for _ in range(8):
        b = jax.jit(lambda p, s=st: B.bin_gaussians(
            p, s.image_height, s.image_width, s.tile_size, s.max_instances,
            s.gaussian_chunk, radius_max=s.radius_max,
            max_dup_per_axis=s.max_dup_per_axis,
            large_capacity=s.large_capacity,
            exact_cull=s.exact_tile_cull))(proj)
        n_live = int(b.n_live)
        if int(b.n_dropped) == 0:
            k = max(-(-int(n_live * headroom) // 256) * 256, 256)
            return st.replace(max_instances=k), n_live
        if int(b.n_dropped_large) > 0:       # the large-splat pool overflows
            st = st.replace(large_capacity=g.capacity)
        else:
            st = st.replace(max_instances=2 * st.max_instances)
    raise CheckFailed("binning still drops instances at stream "
                      f"{st.max_instances}, large pool {st.large_capacity}")


def _target(h, w):
    return jnp.asarray(np.random.default_rng(1).uniform(0, 1, (3, h, w)),
                       jnp.float32)


def step_fn(st) -> Callable:
    """Jitted fwd+bwd of the check loss (image, alpha and depth terms):
    (params, gaussians, camera, target) -> ((loss, outputs), grads)."""
    from .ops.renderer import render

    def loss(params, g, cam, target):
        out = render(g.with_params(params), cam, st)
        val = (jnp.mean((out["image"] - target) ** 2)
               + 0.1 * jnp.mean(out["alpha"])
               + 0.01 * jnp.mean(out["depth"]))
        return val, {k: out[k] for k in ("image", "alpha", "depth",
                                          "n_dropped")}
    return jax.jit(jax.value_and_grad(loss, has_aux=True))


def step_args(g, cam, st, device=None):
    args = (g.params(), g, cam, _target(st.image_height, st.image_width))
    return jax.device_put(args, device) if device is not None else args


def run(g, cam, st, device=None) -> dict:
    """Loss, outputs and gradients on the host."""
    (lv, out), grads = step_fn(st)(*step_args(g, cam, st, device))
    return jax.device_get({"loss": lv, "out": out, "grads": grads})


def grad_stats(a, b) -> dict:
    """Gradient a against reference b: rel-L2, and the max / p99.9 / count
    above 3e-3 of |a - b| normalized by max|b|."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = np.abs(b).max() + 1e-30
    d = np.abs(a - b) / scale
    return {"rel_l2": float(np.linalg.norm(a - b)
                            / (np.linalg.norm(b) + 1e-30)),
            "max": float(d.max()), "p999": float(np.quantile(d, 0.999)),
            "cliffs": int((d > 3e-3).sum()), "size": int(d.size),
            "zero_ref": bool(np.abs(b).max() == 0.0)}


def calibrate(g, cam, st, rows: int = 64, log=print) -> Dict[str, dict]:
    """Cliff floor for this population: the reference on the default device
    against the reference on the CPU, over a band of `rows` image rows in
    the middle of the frame (the full frame is too slow on the CPU)."""
    row0 = (st.image_height // 2 // st.tile_size) * st.tile_size
    band = st.replace(use_pallas=False, image_height=rows, row0=row0)
    dev = run(g, cam, band)
    cpu = run(g, cam, band, device=jax.devices("cpu")[0])
    stats = {k: grad_stats(dev["grads"][k], cpu["grads"][k])
             for k in GROUPS}
    d = np.abs(dev["out"]["image"] - cpu["out"]["image"])
    stats["image"] = {"max": float(d.max()),
                      "cliffs": int((d > 1e-3).sum()), "size": int(d.size)}
    log("calibration (reference here vs reference on CPU, rows "
        f"[{row0}, {row0 + rows})): image max={d.max():.2e} "
        f"px>1e-3={stats['image']['cliffs']}/{d.size}; grad rel-L2 "
        + ", ".join(f"{k}={stats[k]['rel_l2']:.2e}" for k in GROUPS))
    return stats


# Forward gates.  p99.9 < 1e-3: the bulk agrees to f32 accumulation noise.
# Isolated cliffs: an early-stop flip moves one pixel by up to the remaining
# transmittance, <= 5e-3, so the max gate is 5.5e-3 (that bound plus
# rounding) and pixels above 1e-3 must be isolated: at most 1 in 10^5, or 8.
FWD_P999 = 1e-3
FWD_MAX = 5.5e-3


def _forward_gate(name: str, d: np.ndarray, log) -> bool:
    """Cliff-aware gate on |kernel - reference| of a forward quantity."""
    p999 = float(np.quantile(d, 0.999))
    big = int((d > 1e-3).sum())
    cap = max(8, d.size // 100_000)
    ok = p999 < FWD_P999 and big <= cap and d.max() < FWD_MAX
    log(f"  {name} max={d.max():.2e} (< {FWD_MAX:.1e}: early-stop T "
        f"+ rounding) p99.9={p999:.2e} (< {FWD_P999:.0e}: bulk) "
        f"px>1e-3={big}/{d.size} (<= {cap}: isolated) "
        f"{'ok' if ok else 'FAIL'}")
    return ok


def check_forward(kern: dict, ref: dict, log=print) -> None:
    fails = [field for field in ("image", "alpha") if not _forward_gate(
        f"{field:5s}", np.abs(np.asarray(kern[field])
                              - np.asarray(ref[field])), log)]
    # depth = D / (A + 1e-6) is ill-conditioned where A is small: compare
    # it relative to itself where the reference alpha exceeds 0.5, where a
    # cliff moves D and A each by <= 5e-3, so depth by <= ~1.5e-2.
    a = np.asarray(ref["alpha"]) > 0.5
    dk, dr = np.asarray(kern["depth"])[a], np.asarray(ref["depth"])[a]
    d = np.abs(dk - dr) / np.maximum(np.abs(dr), 1e-6)
    p999 = float(np.quantile(d, 0.999)) if d.size else 0.0
    dmax = float(d.max()) if d.size else 0.0
    ok = p999 < FWD_P999 and dmax < 1.5e-2
    log(f"  depth rel (alpha > 0.5, {d.size} px) max={dmax:.2e} (< 1.5e-2: "
        f"cliff on D and A) p99.9={p999:.2e} (< {FWD_P999:.0e}: bulk) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        fails.append("depth")
    if fails:
        raise CheckFailed(f"forward mismatch: {fails}")


# Gradient gates.  rel-L2 < max(3e-3, 2 x calibrated floor): the kernel may
# sit on the cliff floor two correct implementations show, not above it.
# p99.9 of the normalized difference < 3e-3: cliffs stay isolated.
GRAD_L2 = 3e-3
GRAD_P999 = 3e-3


def check_grads(kern: dict, ref: dict, calib: Optional[dict] = None,
                log=print, skip=()) -> Dict[str, dict]:
    fails = []
    report = {}
    for k in GROUPS:
        if k in skip:
            log(f"  grad {k:13s} not gated: {skip[k]}")
            continue
        s = grad_stats(kern[k], ref[k])
        report[k] = s
        if s["zero_ref"]:
            log(f"  grad {k:13s} reference is all zero; kernel max "
                f"{np.abs(np.asarray(kern[k])).max():.2e}")
            if np.abs(np.asarray(kern[k])).max() > 0:
                fails.append(k)
            continue
        floor = calib[k]["rel_l2"] if calib else 0.0
        gate = max(GRAD_L2, 2.0 * floor)
        ok = s["rel_l2"] < gate and s["p999"] < GRAD_P999
        log(f"  grad {k:13s} rel-L2={s['rel_l2']:.2e} (< {gate:.1e}: "
            f"max(3e-3, 2 x floor {floor:.1e})) p99.9={s['p999']:.2e} "
            f"(< {GRAD_P999:.0e}) max={s['max']:.2e} "
            f"cliffs>3e-3={s['cliffs']}/{s['size']} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            fails.append(k)
    if fails:
        raise CheckFailed(f"gradient mismatch: {fails}")
    return report


ISOTROPIC_SKIP = {"rotation": "isotropic splats have a zero true rotation "
                               "gradient, so both sides are rounding noise"}


def kernel_parity(g, cam, st, calib=None, log=print, skip=()) -> dict:
    """Kernel path against the reference at `st`'s frame and tile size:
    forward image / alpha / depth and the gradients of every group (but the
    ones in `skip`, a {group: reason} map)."""
    kern = run(g, cam, st.replace(use_pallas=True))
    ref = run(g, cam, st.replace(use_pallas=False))
    if int(kern["out"]["n_dropped"]) != 0:
        raise CheckFailed(f"{int(kern['out']['n_dropped'])} stream drops: "
                          "the comparison needs a stream sized to the scene")
    log(f"  loss kernel={float(kern['loss']):.7f} "
        f"reference={float(ref['loss']):.7f}")
    check_forward(kern["out"], ref["out"], log)
    return check_grads(kern["grads"], ref["grads"], calib, log, skip)


def t0_split_parity(g, cam, st, log=print) -> None:
    """The t0 op (ring route) against itself unsplit: every tile's instance
    list is cut in two at a kernel-block boundary and the second part
    resumes from the first's outgoing transmittance (output row 5).  The
    cut being block-aligned, T follows the same arithmetic as in one pass,
    so the accumulators, T_out and the stream gradient may differ only by
    the association of the two partial sums."""
    from .ops import binning as B
    from .ops import raster_pallas as RP
    from .ops.projection import project_gaussians

    H, W, ts = st.image_height, st.image_width, st.tile_size
    tiles_x, tiles_y = -(-W // ts), -(-H // ts)
    P = ts * ts
    proj = project_gaussians(g, cam, radius_min=st.radius_min,
                             radius_max=st.radius_max,
                             color_mode=st.color_mode,
                             sh_degree=st.sh_degree)
    b = B.bin_gaussians(proj, H, W, ts, st.max_instances, st.gaussian_chunk,
                        radius_max=st.radius_max,
                        max_dup_per_axis=st.max_dup_per_axis)
    per_axis = B._per_axis_bound(st.radius_max, ts, st.max_dup_per_axis,
                                 tiles_x, tiles_y)
    inst = B.pack_instances(RP.instance_attrs(proj), b.s_rank, b.rank_perm,
                            b.rank_key, b.seg_start_gid, b.counts_gid,
                            b.order, b.n_live, per_axis * per_axis)
    op = RP._make_raster_op(tiles_x, ts, RP._interpret(), has_t0=True)
    gid = jnp.arange(tiles_x * tiles_y, dtype=jnp.int32)
    ones = jnp.ones((gid.shape[0], 1, P), jnp.float32)
    wts = jnp.asarray(np.random.default_rng(2).uniform(
        0, 1, (gid.shape[0], 6, P)), jnp.float32)
    tstart, tcount = b.tile_start, b.tile_count
    blk = RP._block(P)
    cut = (tcount // 2) // blk * blk

    def single(x):
        return op(x, tstart, tcount, gid, ones)

    def split(x):
        first = op(x, tstart, cut, gid, ones)
        second = op(x, tstart + cut, tcount - cut, gid, first[:, 5:6])
        return first.at[:, 5].set(0.0) + second

    def loss(f):
        return lambda x: jnp.sum(f(x)[:, :6] * wts)

    o1, o2 = jax.jit(single)(inst), jax.jit(split)(inst)
    d1 = jax.jit(jax.grad(loss(single)))(inst)
    d2 = jax.jit(jax.grad(loss(split)))(inst)
    out_d = float(jnp.max(jnp.abs(o1[:, :6] - o2[:, :6])))
    s = grad_stats(d2, d1)
    ok = out_d < 1e-4 and s["rel_l2"] < 1e-4
    log(f"  t0 split: accumulators + T_out max|diff|={out_d:.2e} (< 1e-4: "
        f"f32 association of the partial sums) stream grad "
        f"rel-L2={s['rel_l2']:.2e} (< 1e-4) max={s['max']:.2e} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise CheckFailed("t0 split mismatch")


def time_step(fn: Callable, args, reps: int = 10) -> dict:
    """Host-clock ms per call of a warm `fn`, each call ending in
    block_until_ready (JAX returns before the device finishes)."""
    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append((time.perf_counter() - t0) * 1e3)
    return {"mean_ms": float(np.mean(times)),
            "min_ms": float(np.min(times)), "reps": reps}


def sharded_parity(g, cams, st, meshes=((1, 4), (2, 2)), gate=1e-3,
                   log=print) -> Dict[str, dict]:
    """Every sharded training route's loss and gradients against the
    single-device step on the first device, per (data, tile) mesh.  `cams`
    holds one target-carrying camera per data shard of the widest data
    axis; the single-device reference (on the default device) is their
    mean.

    Gate: rel-L2 < `gate` per group — the routes change only the order of
    f32 sums (band cuts, ring segments, collective reductions), and an
    order change can flip an isolated early-stop cliff."""
    from .config import TrainingConfig
    from .core.loss import gaussian_loss
    from .ops.renderer import render
    from .parallel.mesh import make_mesh
    from .parallel.sharded import (make_gauss_sharded_train_step,
                                   make_sharded_train_step,
                                   shard_train_state)
    from .train.trainer import create_train_state

    cfg = TrainingConfig(capacity=g.capacity, image_height=st.image_height,
                         image_width=st.image_width, use_pallas=True,
                         tile_size=st.tile_size,
                         max_instances=st.max_instances,
                         gaussian_chunk=st.gaussian_chunk)
    def ref_loss(params, cam):
        out = render(g.with_params(params), cam, st)
        return gaussian_loss(out["image"], cam.image, cfg.lambda_dssim)[0]

    ref_step = jax.jit(jax.value_and_grad(ref_loss))   # default device
    alive = np.asarray(g.alive)
    routes = {
        "all_to_all": lambda mesh, s: make_sharded_train_step(
            cfg, st, mesh, grads_only=True),
        "ring": lambda mesh, s: make_sharded_train_step(
            cfg, st.replace(ring=True), mesh, grads_only=True),
        "gauss_all_to_all": lambda mesh, s: make_gauss_sharded_train_step(
            cfg, st, mesh, s, grads_only=True),
        "gauss_ring_local": lambda mesh, s: make_gauss_sharded_train_step(
            cfg, st.replace(ring=True, ring_local=True), mesh, s,
            grads_only=True),
    }
    report = {}
    for data, tile in meshes:
        ref_l, ref_g = 0.0, None
        for c in cams[:data]:
            lv, gr = ref_step(g.params(), c)
            gr = jax.device_get(gr)
            ref_l += float(lv) / data
            ref_g = gr if ref_g is None else jax.tree.map(np.add, ref_g, gr)
        ref_g = {k: np.where(alive.reshape((-1,) + (1,) * (v.ndim - 1)),
                             v / data, 0.0) for k, v in ref_g.items()}
        mesh = make_mesh(data=data, tile=tile)
        batch = jax.tree.map(lambda *x: jnp.stack(x), *cams[:data])
        for name, make in routes.items():
            state = create_train_state(g, cfg)
            if name.startswith("gauss"):
                state = shard_train_state(state, mesh)
            grads, metrics = make(mesh, state)(state, batch)
            grads = jax.device_get(grads)
            loss = float(metrics["total_loss"])
            stats = {k: grad_stats(grads[k], ref_g[k]) for k in GROUPS
                     if np.abs(ref_g[k]).max() > 0}
            worst = max(s["rel_l2"] for s in stats.values())
            ok = abs(loss - ref_l) <= 1e-5 * max(1.0, abs(ref_l)) \
                and worst < gate
            log(f"  mesh (data={data}, tile={tile}) {name:16s} "
                f"loss={loss:.7f} ref={ref_l:.7f} worst grad rel-L2="
                f"{worst:.2e} (< {gate:.0e}) "
                + " ".join(f"{k}={s['rel_l2']:.1e}"
                           for k, s in stats.items())
                + f" {'ok' if ok else 'FAIL'}")
            report[f"{data}x{tile}/{name}"] = {"loss": loss, "ref": ref_l,
                                               "worst_rel_l2": worst}
            if not ok:
                raise CheckFailed(f"sharded route {name} on mesh "
                                  f"({data}, {tile}) mismatch")
    return report
