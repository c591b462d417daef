"""Simple scene example (reference `examples/simple_scene.py`, a 0-byte stub;
intended content per BASELINE config #1): random-init Gaussians, a single
256x256 camera, render + one L1+D-SSIM training step — then a short
optimization loop that fits a target render.
"""

import math
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax
import jax.numpy as jnp
import numpy as np


def main():
    from mini3dgs_tpu.config import TrainingConfig
    from mini3dgs_tpu.core.camera import Camera
    from mini3dgs_tpu.core.gaussians import create_from_random
    from mini3dgs_tpu.ops.renderer import RenderSettings, render
    from mini3dgs_tpu.train.trainer import create_train_state, make_train_step
    from mini3dgs_tpu.utils.compile_cache import enable_compile_cache
    from mini3dgs_tpu.utils.io import save_image

    enable_compile_cache()
    use_pallas = True   # raster kernels (interpreted on a CPU)
    cfg = TrainingConfig(capacity=4096, image_height=256, image_width=256,
                         use_pallas=use_pallas, max_instances=2 ** 16)
    settings = RenderSettings(image_height=256, image_width=256,
                              use_pallas=use_pallas, max_instances=2 ** 16)

    cam = Camera.create(0, np.eye(3), np.array([0, 0, -3.0]),
                        math.radians(60), math.radians(60),
                        width=256, height=256)

    # target: a render of a hidden Gaussian configuration
    g_target = create_from_random(jax.random.PRNGKey(42), 512,
                                  scene_extent=0.8, capacity=4096)
    target = render(g_target, cam, settings)["image"]
    cam = cam.replace(image=target)

    g = create_from_random(jax.random.PRNGKey(0), 2048, scene_extent=0.8,
                           capacity=4096)
    state = create_train_state(g, cfg)
    step = make_train_step(cfg, settings)

    for it in range(200):
        state, metrics = step(state, cam)
        if (it + 1) % 20 == 0:
            print(f"[{it + 1:4d}] loss={float(metrics['total_loss']):.5f} "
                  f"l1={float(metrics['l1']):.5f}")

    out = render(state.gaussians, cam, settings)
    save_image(target, "output/simple_scene_target.png")
    save_image(out["image"], "output/simple_scene_fit.png")
    print("wrote output/simple_scene_{target,fit}.png")


if __name__ == "__main__":
    main()
