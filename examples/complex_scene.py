"""Complex scene example (reference `examples/complex_scene.py`, a 0-byte
stub): multi-camera training with full adaptive density control (split /
clone / prune / opacity reset) on a synthetic scene, demonstrating the
trainer orchestration end to end.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax
import jax.numpy as jnp
import numpy as np


def main():
    from mini3dgs_tpu.config import TrainingConfig
    from mini3dgs_tpu.core.gaussians import create_from_random
    from mini3dgs_tpu.data.dataset import RandomDataset
    from mini3dgs_tpu.ops.renderer import RenderSettings, render
    from mini3dgs_tpu.train.trainer import GaussianTrainer
    from mini3dgs_tpu.utils.compile_cache import enable_compile_cache
    from mini3dgs_tpu.utils.io import save_image

    enable_compile_cache()
    use_pallas = True   # raster kernels (interpreted on a CPU)
    size = 128
    cfg = TrainingConfig(
        capacity=8192, image_height=size, image_width=size,
        use_pallas=use_pallas, max_instances=2 ** 16,
        iterations=300, densify_from_iter=50, densify_until_iter=250,
        densify_interval=50, opacity_reset_interval=0,
        log_interval=50, eval_interval=10 ** 9, save_interval=10 ** 9)

    # Scene: cameras on a ring; GT images rendered from a hidden model.
    ds = RandomDataset(n_cameras=6, width=size, height=size)
    ds.load_cameras()
    settings = RenderSettings(image_height=size, image_width=size,
                              use_pallas=use_pallas, max_instances=2 ** 16)
    hidden = create_from_random(jax.random.PRNGKey(99), 800, scene_extent=0.8,
                                capacity=8192)
    ds.train_cameras = [
        cam.replace(image=render(hidden, cam, settings)["image"])
        for cam in ds.train_cameras]
    ds.test_cameras = ds.train_cameras[:1]

    trainer = GaussianTrainer(cfg, settings)
    init = create_from_random(jax.random.PRNGKey(0), 1000, scene_extent=0.8,
                              capacity=8192)
    trainer.setup(dataset=ds, gaussians=init)

    def log(it, metrics):
        n = metrics.get("n_alive", "")
        print(f"[{it:4d}] loss={metrics['total_loss']:.5f} alive={n}")

    trainer.train(log_fn=log)
    val = trainer.validate()
    print(f"final: {val}")
    out = render(trainer.state.gaussians, ds.train_cameras[0], settings)
    save_image(out["image"], "output/complex_scene_fit.png")
    print("wrote output/complex_scene_fit.png")


if __name__ == "__main__":
    main()
