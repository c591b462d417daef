"""The Triton-route raster kernels on the CPU: the decision point, the
lowering for CUDA, and interpret-mode parity with the golden renderer on
frame shapes and tile lists the standard scenes do not reach (non-square
frames that are not tile multiples, empty tiles, the t0 op split in two)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mini3dgs_tpu import checks
from mini3dgs_tpu.ops import binning
from mini3dgs_tpu.ops import raster_pallas as RP
from mini3dgs_tpu.ops.projection import project_gaussians
from mini3dgs_tpu.ops.renderer import RenderSettings, render
from tests.test_raster_pallas import random_scene, rotated_scene
from tests.test_render_golden import identity_camera, make_gaussians


@pytest.mark.parametrize("platform,interpret", [("gpu", False),
                                                ("cpu", True)])
def test_kernel_mode_gpu_compiles_cpu_interprets(platform, interpret):
    assert RP.kernel_mode(platform) is interpret


@pytest.mark.parametrize("platform", ["tpu", "rocm", "metal"])
def test_kernel_mode_other_platforms_raise(platform):
    with pytest.raises(NotImplementedError, match="no raster kernel"):
        RP.kernel_mode(platform)


@pytest.mark.parametrize("tile", [16, 32])
def test_kernels_lower_through_triton_for_cuda(tile, monkeypatch):
    """The compiled route (interpret=False) lowers for CUDA here: the fwd
    and bwd kernels become Triton custom calls, not an interpreter loop."""
    monkeypatch.setattr(RP, "_interpret", lambda: False)
    RP._make_raster_op.cache_clear()
    try:
        g, cam = checks.population(1024, 500, 64, 64)
        st = checks.settings(64, 64, tile, True, max_instances=8192)
        lowered = checks.step_fn(st).trace(
            *checks.step_args(g, cam, st)).lower(
                lowering_platforms=("cuda",))
        text = lowered.as_text()
    finally:
        RP._make_raster_op.cache_clear()
    assert text.count("__gpu$xla.gpu.triton") == 2
    assert "raster_fwd" in text and "raster_bwd" in text


def test_t0_op_lowers_for_cuda(monkeypatch):
    """The ring route's t0 op (extra t0 input, T_out row, dt0 output) lowers
    through Triton too."""
    monkeypatch.setattr(RP, "_interpret", lambda: False)
    op = RP._make_raster_op(2, 16, False, has_t0=True)
    inst = jnp.zeros((binning.STREAM_ROWS, 512), jnp.float32)
    ts = jnp.zeros((4,), jnp.int32)
    t0 = jnp.ones((4, 1, 256), jnp.float32)

    def loss(x, t):
        return jnp.sum(op(x, ts, ts, jnp.arange(4, dtype=jnp.int32), t))

    text = jax.jit(jax.grad(loss, argnums=(0, 1))).trace(inst, t0).lower(
        lowering_platforms=("cuda",)).as_text()
    assert text.count("__gpu$xla.gpu.triton") == 2


def _parity(gs, cam, tile, max_instances=8192):
    g_set = RenderSettings(image_height=cam.height, image_width=cam.width,
                           use_pallas=False, tile_size=tile)
    p_set = g_set.replace(use_pallas=True, max_instances=max_instances,
                          gaussian_chunk=32)
    target = jnp.asarray(np.random.default_rng(0).uniform(
        0, 1, (3, cam.height, cam.width)), jnp.float32)

    def loss(params, s):
        out = render(gs.with_params(params), cam, s)
        return (jnp.mean((out["image"] - target) ** 2)
                + 0.01 * jnp.mean(out["depth"])), out

    (lg, og), dg = jax.value_and_grad(loss, has_aux=True)(gs.params(), g_set)
    (lp, op), dp = jax.value_and_grad(loss, has_aux=True)(gs.params(), p_set)
    assert int(op["n_dropped"]) == 0
    for k in ("image", "alpha"):
        np.testing.assert_allclose(np.asarray(op[k]), np.asarray(og[k]),
                                   atol=3e-5, err_msg=k)
    for k in ("xyz", "scaling", "rotation", "opacity", "features_dc"):
        a, b = np.asarray(dp[k]), np.asarray(dg[k])
        scale = np.abs(b).max() + 1e-8
        np.testing.assert_allclose(a / scale, b / scale, atol=1e-3,
                                   err_msg=k)
    return op


@pytest.mark.parametrize("w,h,tile", [(56, 40, 16), (72, 48, 32)])
def test_nonsquare_frame_not_tile_multiple_matches_golden(w, h, tile):
    """Frames that are neither square nor tile multiples: the kernels
    render whole tiles and the epilogue crops; forward and gradients must
    match the golden renderer."""
    cam = identity_camera(w, h, 70.0)
    _parity(rotated_scene(50, seed=5), cam, tile)


def test_empty_tiles_render_background():
    """Tiles with tile_count == 0 run zero loop steps: they show the
    background and take no gradient, beside populated tiles that match the
    golden renderer."""
    rng = np.random.default_rng(6)
    n = 24
    # all splats in the upper-left quadrant of a 64x64 frame
    xyz = np.concatenate([rng.uniform(-0.55, -0.35, (n, 2)),
                          rng.uniform(1.5, 2.5, (n, 1))], axis=1)
    gs = make_gaussians(xyz, np.full((n, 3), 0.03),
                        rng.uniform(0, 1, (n, 3)), np.full(n, 0.7))
    cam = identity_camera(64, 64, 70.0)
    b = binning.bin_gaussians(project_gaussians(gs, cam), 64, 64, 16, 4096,
                              32)
    counts = np.asarray(b.tile_count)
    assert (counts == 0).sum() >= 8 and counts.max() > 0
    out = _parity(gs, cam, 16)
    img = np.asarray(out["image"]).reshape(3, 4, 16, 4, 16)
    empty = counts.reshape(4, 4) == 0
    np.testing.assert_array_equal(img[:, empty.nonzero()[0], :,
                                      empty.nonzero()[1], :], 0.0)


def test_t0_split_matches_single_pass():
    """The t0 op chained over each tile's list cut in two halves gives the
    single pass's accumulators, outgoing transmittance and stream
    gradient (the check chip_smoke.py runs on the card)."""
    g, cam = checks.population(2048, 1500, 64, 64)
    st, _ = checks.sized_stream(g, cam, checks.settings(64, 64, 16, True))
    checks.t0_split_parity(g, cam, st, log=lambda *a: None)


def test_checks_kernel_parity_small():
    """checks.kernel_parity (the card's gate) passes in interpret mode on an
    anisotropic population at a small width."""
    g, cam = checks.population(2048, 1200, 48, 40, aniso=True)
    st, _ = checks.sized_stream(g, cam, checks.settings(48, 40, 16, True))
    checks.kernel_parity(g, cam, st, log=lambda *a: None)
