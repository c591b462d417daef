"""Raster kernels vs golden renderer: forward images AND pixel gradients
must be allclose (BASELINE.md correctness gate).  Runs in Pallas interpret
mode on CPU (SURVEY §4(c)); the same kernels compile through Triton on a
GPU (tests/test_gpu.py, chip_smoke.py)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mini3dgs_tpu.core.camera import Camera
from mini3dgs_tpu.ops import binning
from mini3dgs_tpu.ops.projection import project_gaussians
from mini3dgs_tpu.ops.renderer import RenderSettings, render
from tests.test_render_golden import identity_camera, make_gaussians


def random_scene(n=80, seed=0, spread=0.6, zmin=0.5, zmax=4.0):
    rng = np.random.default_rng(seed)
    xyz = np.concatenate([rng.uniform(-spread, spread, (n, 2)),
                          rng.uniform(zmin, zmax, (n, 1))], axis=1)
    sig = rng.uniform(0.01, 0.12, (n, 3))
    col = rng.uniform(0, 1, (n, 3))
    op = rng.uniform(0.2, 0.95, n)
    return make_gaussians(xyz, sig, col, op)


def settings_pair(cam, **kw):
    golden = RenderSettings(image_height=cam.height, image_width=cam.width,
                            use_pallas=False, **kw)
    pallas = RenderSettings(image_height=cam.height, image_width=cam.width,
                            use_pallas=True, max_instances=4096,
                            gaussian_chunk=32, **kw)
    return golden, pallas


def test_binning_ranges_consistent():
    cam = identity_camera(64, 64)
    gs = random_scene(50)
    proj = project_gaussians(gs, cam)
    b = binning.bin_gaussians(proj, 64, 64, 16, 4096, 32)
    start = np.asarray(b.tile_start)
    count = np.asarray(b.tile_count)
    gid = np.asarray(b.gauss_id)
    live = np.asarray(b.live)
    depth = np.asarray(proj.depth)
    assert int(b.n_dropped) == 0
    # tiles tile the compact stream contiguously; depths ascend within each
    assert np.all(start[1:] == start[:-1] + count[:-1])
    assert int(b.n_live) == start[-1] + count[-1]
    for t in range(16):
        c = count[t]
        seg = slice(start[t], start[t] + c)
        assert np.all(live[seg])
        if c == 0:
            continue
        d = depth[gid[seg]]
        assert np.all(np.diff(d) >= 0), t
    assert not np.any(live[int(b.n_live):])


@pytest.mark.parametrize("bg", [[0.0, 0.0, 0.0], [0.3, 0.6, 0.9]])
def test_pallas_forward_matches_golden(bg):
    cam = identity_camera(48, 48, 70.0)
    gs = random_scene(70, seed=1)
    g_set, p_set = settings_pair(cam, bg_color=jnp.asarray(bg, jnp.float32))
    out_g = render(gs, cam, g_set)
    out_p = render(gs, cam, p_set)
    np.testing.assert_allclose(np.asarray(out_p["image"]),
                               np.asarray(out_g["image"]), atol=3e-5)
    np.testing.assert_allclose(np.asarray(out_p["alpha"]),
                               np.asarray(out_g["alpha"]), atol=3e-5)
    np.testing.assert_allclose(np.asarray(out_p["depth"]),
                               np.asarray(out_g["depth"]), atol=1e-3)


def test_pallas_forward_analytic_oracle():
    """The reference's analytic compositing test through the Pallas path
    (reference tests/test_renderer.py:127-161)."""
    cam = identity_camera()
    gs = make_gaussians([[0, 0, 1.0], [0, 0, 2.0]], [[0.01] * 3] * 2,
                        [[1, 0, 0], [0, 1, 0]], [0.5, 0.5])
    _, p_set = settings_pair(cam)
    out = render(gs, cam, p_set)
    a = float(out["alpha"][0, 32, 32])
    rgb = np.asarray(out["image"][:, 32, 32])
    d = float(out["depth"][0, 32, 32])
    np.testing.assert_allclose(a, 0.75, atol=1e-3)
    s0 = 1 / (1 + np.exp(-np.array([1.0, 0, 0])))
    s1 = 1 / (1 + np.exp(-np.array([0, 1.0, 0])))
    np.testing.assert_allclose(rgb, 0.5 * s0 + 0.25 * s1, atol=1e-3)
    np.testing.assert_allclose(d, 4 / 3, atol=2e-2)


def test_pallas_gradients_match_golden():
    """Hand-written VJP vs XLA autodiff of the golden renderer: gradients of a
    scalar loss w.r.t. every Gaussian parameter group must match."""
    cam = identity_camera(32, 32, 70.0)
    gs = random_scene(40, seed=2, spread=0.35, zmin=0.6, zmax=3.0)
    target = jnp.asarray(np.random.default_rng(0).uniform(0, 1, (3, 32, 32)),
                         jnp.float32)
    g_set, p_set = settings_pair(cam)

    def loss(params, settings):
        g = gs.with_params(params)
        out = render(g, cam, settings)
        return (jnp.mean((out["image"] - target) ** 2)
                + 0.1 * jnp.mean(out["alpha"])
                + 0.01 * jnp.mean(out["depth"]))

    lg, grads_g = jax.value_and_grad(lambda p: loss(p, g_set))(gs.params())
    lp, grads_p = jax.value_and_grad(lambda p: loss(p, p_set))(gs.params())
    np.testing.assert_allclose(float(lp), float(lg), rtol=1e-4)
    for name in ("xyz", "scaling", "rotation", "opacity", "features_dc"):
        a = np.asarray(grads_p[name])
        b = np.asarray(grads_g[name])
        scale = np.abs(b).max() + 1e-8
        # 1e-3 normalized: float32 association noise — the kernel groups a
        # tile's instances into blocks, so its transmittance scans and the
        # pack backward's segment sums round differently than the golden
        # autodiff.
        np.testing.assert_allclose(a / scale, b / scale, atol=1e-3,
                                   err_msg=name)


def test_pallas_early_stop_consistency():
    """Opaque front Gaussian saturates pixels; kernel's early exit must not
    change results or gradients."""
    cam = identity_camera(32, 32)
    n = 30
    rng = np.random.default_rng(5)
    xyz = [[0, 0, 0.5]] + np.concatenate(
        [rng.uniform(-0.2, 0.2, (n, 2)), rng.uniform(1.0, 3.0, (n, 1))],
        axis=1).tolist()
    sig = [[0.3, 0.3, 0.3]] + [[0.05] * 3] * n
    col = rng.uniform(0, 1, (n + 1, 3))
    op = [0.999] + [0.8] * n
    gs = make_gaussians(xyz, sig, col, op)
    g_set, p_set = settings_pair(cam)
    out_g = render(gs, cam, g_set)
    out_p = render(gs, cam, p_set)
    np.testing.assert_allclose(np.asarray(out_p["image"]),
                               np.asarray(out_g["image"]), atol=3e-5)

    def loss(params, settings):
        g = gs.with_params(params)
        return jnp.mean(render(g, cam, settings)["image"] ** 2)

    gg = jax.grad(lambda p: loss(p, g_set))(gs.params())
    gp = jax.grad(lambda p: loss(p, p_set))(gs.params())
    for name in ("xyz", "opacity"):
        a, b = np.asarray(gp[name]), np.asarray(gg[name])
        scale = np.abs(b).max() + 1e-8
        np.testing.assert_allclose(a / scale, b / scale, atol=2e-4,
                                   err_msg=name)


def test_max_dup_tight_bound_exact():
    """When max_dup_per_axis covers every AABB span, results are identical to
    the exact default bound and nothing is dropped."""
    cam = identity_camera(48, 48, 70.0)
    gs = random_scene(50, seed=9)
    from mini3dgs_tpu.ops.projection import project_gaussians
    proj = project_gaussians(gs, cam)
    import numpy as _np
    r = _np.asarray(proj.radius)[_np.asarray(proj.visible)]
    max_span = int(_np.ceil((2 * r.max() + 1) / 16)) + 1
    st_exact = RenderSettings(image_height=48, image_width=48, use_pallas=True,
                              max_instances=4096, gaussian_chunk=32)
    st_tight = st_exact.replace(max_dup_per_axis=max_span)
    out_a = render(gs, cam, st_exact)
    out_b = render(gs, cam, st_tight)
    np.testing.assert_allclose(np.asarray(out_b["image"]),
                               np.asarray(out_a["image"]), atol=1e-6)


def test_max_dup_clamp_counts_drops():
    """A too-small bound drops instances and reports the count."""
    cam = identity_camera(64, 64, 70.0)
    # one huge gaussian covering many tiles
    gs = make_gaussians([[0, 0, 1.0]], [[0.5, 0.5, 0.5]], [[1, 1, 1]], [0.9])
    from mini3dgs_tpu.ops import binning
    from mini3dgs_tpu.ops.projection import project_gaussians
    proj = project_gaussians(gs, cam)
    b_full = binning.bin_gaussians(proj, 64, 64, 16, 4096, 32)
    b_tight = binning.bin_gaussians(proj, 64, 64, 16, 4096, 32,
                                    max_dup_per_axis=1)
    assert int(b_full.n_dropped) == 0
    n_inst_full = int(np.asarray(b_full.tile_count).sum())
    n_inst_tight = int(np.asarray(b_tight.tile_count).sum())
    assert n_inst_tight < n_inst_full
    assert int(b_tight.n_dropped) == n_inst_full - n_inst_tight


def test_overflow_gradients_finite():
    """Under instance-capacity overflow (n_dropped > 0) gradients are
    approximate (documented in pack_instances) but must stay FINITE — the
    count-derived segment boundaries may reach d_inst tail chunks the kernel
    never wrote, which the pack backward hard-masks."""
    from mini3dgs_tpu.checks import population
    from mini3dgs_tpu.ops import binning
    from mini3dgs_tpu.ops.projection import project_gaussians

    g, cam = population(512, 400, 64, 64)
    st = RenderSettings(image_height=64, image_width=64, use_pallas=True,
                        max_instances=128, gaussian_chunk=32)
    b = binning.bin_gaussians(project_gaussians(g, cam), 64, 64, 16, 128, 32)
    assert int(b.n_dropped) > 0  # the probe must actually overflow
    target = jnp.zeros((3, 64, 64), jnp.float32)

    def loss(params):
        out = render(g.with_params(params), cam, st)
        return jnp.abs(out["image"] - target).mean()

    val, grads = jax.jit(jax.value_and_grad(loss))(g.params())
    assert np.isfinite(float(val))
    for leaf in jax.tree.leaves(grads):
        assert bool(jnp.all(jnp.isfinite(leaf)))


@pytest.mark.parametrize("ts", [8, 32])
def test_pallas_matches_golden_other_tile_sizes(ts):
    """tile_size is a perf knob: the tile-AABB cutoff semantics are
    parametrized identically in the golden and Pallas paths, so they must
    agree at any tile size."""
    cam = identity_camera(64, 64, 70.0)
    gs = random_scene(60, seed=7)
    g_set = RenderSettings(image_height=64, image_width=64, use_pallas=False,
                           tile_size=ts)
    p_set = RenderSettings(image_height=64, image_width=64, use_pallas=True,
                           tile_size=ts, max_instances=8192,
                           gaussian_chunk=32)
    out_g = render(gs, cam, g_set)
    out_p = render(gs, cam, p_set)
    np.testing.assert_allclose(np.asarray(out_p["image"]),
                               np.asarray(out_g["image"]), atol=3e-5)

    def loss(params, settings):
        return jnp.mean(render(gs.with_params(params), cam,
                               settings)["image"] ** 2)

    gg = jax.grad(lambda p: loss(p, g_set))(gs.params())
    gp = jax.grad(lambda p: loss(p, p_set))(gs.params())
    for name in ("xyz", "opacity", "scaling"):
        a, b = np.asarray(gp[name]), np.asarray(gg[name])
        scale = np.abs(b).max() + 1e-8
        np.testing.assert_allclose(a / scale, b / scale, atol=1e-3,
                                   err_msg=name)


def _mixed_span_scene(capacity=2048, n=300, seed=9):
    """Scene with both small (span <= 2x2) and large (span >= 3) gaussians at
    a capacity big enough to activate two-level candidate emission."""
    rng = np.random.default_rng(seed)
    xyz = np.concatenate([rng.uniform(-0.5, 0.5, (n, 2)),
                          rng.uniform(0.6, 3.0, (n, 1))], axis=1)
    sig = rng.uniform(0.005, 0.05, (n, 3))
    sig[: n // 8] = rng.uniform(0.15, 0.4, (n // 8, 3))  # big splats
    col = rng.uniform(0, 1, (n, 3))
    op = rng.uniform(0.2, 0.95, n)
    return make_gaussians(xyz, sig, col, op, capacity=capacity)


def test_two_level_binning_matches_single_grid():
    """Two-level (small-grid + compacted-large-grid) emission must produce
    the identical sorted stream as single-grid emission: the candidate key
    multiset is the same, only the emission layout differs.
    large_capacity=C degenerates the plan to single-grid (no shrink)."""
    from mini3dgs_tpu.ops import binning
    from mini3dgs_tpu.ops.projection import project_gaussians

    cam = identity_camera(64, 64, 70.0)
    gs = _mixed_span_scene()
    proj = project_gaussians(gs, cam)
    C = proj.means2d.shape[0]
    assert binning._emission_plan(C, 4, 4, 16, 0)[0]          # two-level on
    assert not binning._emission_plan(C, 4, 4, 16, C)[0]      # forced off
    b2 = binning.bin_gaussians(proj, 64, 64, 16, 8192, 32)
    b1 = binning.bin_gaussians(proj, 64, 64, 16, 8192, 32, large_capacity=C)
    assert int(b2.n_dropped) == 0 and int(b1.n_dropped) == 0
    assert int(b2.n_live) == int(b1.n_live)
    L = min(b1.s_rank.shape[0], b2.s_rank.shape[0])
    np.testing.assert_array_equal(np.asarray(b2.s_rank)[:L],
                                  np.asarray(b1.s_rank)[:L])
    np.testing.assert_array_equal(np.asarray(b2.tile_start),
                                  np.asarray(b1.tile_start))
    np.testing.assert_array_equal(np.asarray(b2.tile_count),
                                  np.asarray(b1.tile_count))


def test_two_level_large_overflow_counts_drops():
    """Large gaussians beyond large_capacity are dropped and counted."""
    from mini3dgs_tpu.ops import binning
    from mini3dgs_tpu.ops.projection import project_gaussians

    cam = identity_camera(64, 64, 70.0)
    gs = _mixed_span_scene()
    proj = project_gaussians(gs, cam)
    b_full = binning.bin_gaussians(proj, 64, 64, 16, 8192, 32)
    # 37 large gaussians in the scene; cap the pool at 128 slots via the
    # rounding floor (128 is the minimum nonzero capacity)
    b_cap = binning.bin_gaussians(proj, 64, 64, 16, 8192, 32,
                                  large_capacity=128)
    n_full = int(b_full.n_live)
    n_cap = int(b_cap.n_live)
    if n_cap < n_full:  # overflow occurred
        assert int(b_cap.n_dropped) == n_full - n_cap
    else:
        assert int(b_cap.n_dropped) == 0


def test_two_level_render_matches_golden():
    """Full render parity on a mixed-span scene through the two-level path."""
    cam = identity_camera(64, 64, 70.0)
    gs = _mixed_span_scene()
    g_set = RenderSettings(image_height=64, image_width=64, use_pallas=False)
    p_set = RenderSettings(image_height=64, image_width=64, use_pallas=True,
                           max_instances=8192, gaussian_chunk=32)
    out_g = render(gs, cam, g_set)
    out_p = render(gs, cam, p_set)
    np.testing.assert_allclose(np.asarray(out_p["image"]),
                               np.asarray(out_g["image"]), atol=3e-5)

    def loss(params, settings):
        return jnp.mean(render(gs.with_params(params), cam,
                               settings)["image"] ** 2)

    gg = jax.grad(lambda p: loss(p, g_set))(gs.params())
    gp = jax.grad(lambda p: loss(p, p_set))(gs.params())
    for name in ("xyz", "opacity", "scaling"):
        a, b = np.asarray(gp[name]), np.asarray(gg[name])
        scale = np.abs(b).max() + 1e-8
        np.testing.assert_allclose(a / scale, b / scale, atol=1e-3,
                                   err_msg=name)


def test_early_exit_skipped_chunks_zero_grads():
    """Tiles that saturate (A >= 0.995) mid-stream skip whole chunks; the
    epilogue must mask their unwritten d_inst slots (NaN garbage otherwise)
    and the gradients must still match the golden renderer, whose autodiff
    sees the same early-stop gating."""
    rng = np.random.default_rng(4)
    n = 120
    # all gaussians stacked on one spot, high opacity: the center tile
    # saturates within the first chunk, leaving several whole chunks skipped
    xyz = np.concatenate([rng.normal(0, 0.02, (n, 2)),
                          rng.uniform(0.5, 4.0, (n, 1))], axis=1)
    sig = np.full((n, 3), 0.08)
    col = rng.uniform(0, 1, (n, 3))
    op = np.full(n, 0.95)
    gs = make_gaussians(xyz, sig, col, op)
    cam = identity_camera(32, 32, 70.0)
    g_set = RenderSettings(image_height=32, image_width=32, use_pallas=False)
    p_set = RenderSettings(image_height=32, image_width=32, use_pallas=True,
                           max_instances=2048, gaussian_chunk=16,
                           tile_size=16)
    target = jnp.asarray(rng.uniform(0, 1, (3, 32, 32)), jnp.float32)

    def loss(params, settings):
        out = render(gs.with_params(params), cam, settings)
        return jnp.mean((out["image"] - target) ** 2)

    gg = jax.grad(lambda p: loss(p, g_set))(gs.params())
    gp = jax.grad(lambda p: loss(p, p_set))(gs.params())
    for name in ("xyz", "opacity", "scaling", "features_dc"):
        a, b = np.asarray(gp[name]), np.asarray(gg[name])
        assert np.isfinite(a).all(), name
        scale = np.abs(b).max() + 1e-8
        np.testing.assert_allclose(a / scale, b / scale, atol=1e-3,
                                   err_msg=name)


def rotated_scene(n=60, seed=3):
    """Strongly anisotropic splats with random rotations: the AABB (and the
    per-axis exact-cull box) overlaps many tiles the 2-sigma-thin rotated
    ellipse misses — the exact ellipse-vs-tile cull's target case."""
    rng = np.random.default_rng(seed)
    xyz = np.concatenate([rng.uniform(-0.6, 0.6, (n, 2)),
                          rng.uniform(0.8, 3.0, (n, 1))], axis=1)
    sig = np.stack([rng.uniform(0.15, 0.3, n),
                    rng.uniform(0.004, 0.01, n),
                    rng.uniform(0.004, 0.01, n)], axis=1)
    col = rng.uniform(0, 1, (n, 3))
    op = rng.uniform(0.3, 0.9, n)
    g = make_gaussians(xyz, sig, col, op)
    q = rng.standard_normal((n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return g.replace(rotation=g.rotation.at[:n].set(q))


def test_exact_tile_cull_prunes_and_matches_golden():
    """exact_cull drops whole below-W_EPS tiles of rotated anisotropic
    splats (fewer live instances) while forward AND gradients stay
    golden-identical (the reference's own skip zeroes those pixels)."""
    cam = identity_camera(64, 64)
    gs = rotated_scene()
    proj = project_gaussians(gs, cam)
    b_on = binning.bin_gaussians(proj, 64, 64, 16, 8192, 32,
                                 exact_cull=True)
    b_off = binning.bin_gaussians(proj, 64, 64, 16, 8192, 32,
                                  exact_cull=False)
    assert int(b_on.n_dropped) == 0 and int(b_off.n_dropped) == 0
    assert int(b_on.n_live) < int(b_off.n_live) * 0.8, (
        int(b_on.n_live), int(b_off.n_live))
    # counts_gid is the exact emitted multiset size
    assert int(jnp.sum(b_on.counts_gid)) == int(b_on.n_live)

    golden_s, pallas_s = settings_pair(cam)
    target = jnp.linspace(0, 1, 3 * 64 * 64).reshape(3, 64, 64)

    def loss(params, s):
        out = render(gs.with_params(params), cam, s)
        return jnp.abs(out["image"] - target).mean(), out

    (lg, og), dg = jax.value_and_grad(loss, has_aux=True)(gs.params(),
                                                          golden_s)
    (lp, op_), dp = jax.value_and_grad(loss, has_aux=True)(gs.params(),
                                                           pallas_s)
    np.testing.assert_allclose(np.asarray(og["image"]),
                               np.asarray(op_["image"]), atol=2e-5)
    np.testing.assert_allclose(np.asarray(og["alpha"]),
                               np.asarray(op_["alpha"]), atol=2e-5)
    for f in ("xyz", "scaling", "rotation", "opacity", "features_dc"):
        a = np.asarray(dg[f])
        b = np.asarray(dp[f])
        denom = np.abs(a).max() + 1e-8
        np.testing.assert_allclose(b / denom, a / denom, atol=1e-3,
                                   err_msg=f)
