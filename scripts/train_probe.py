"""End-to-end training probe on a GPU: random-init Gaussians fit a target
image with the FULL training machinery — L1+D-SSIM loss, 5-group Adam with
cosine LR, densify/clone/prune cadence, opacity reset, occupancy-triggered
capacity growth.  Prints the PSNR trajectory and
steps/s (the CPU smoke config exercises the same path at toy scale)."""

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax
import jax.numpy as jnp
import numpy as np


def main(steps=1200, width=256, height=256):
    from mini3dgs_tpu.checks import population
    from mini3dgs_tpu.config import TrainingConfig
    from mini3dgs_tpu.core.gaussians import create_from_random
    from mini3dgs_tpu.ops.renderer import RenderSettings, render
    from mini3dgs_tpu.train.trainer import GaussianTrainer
    from mini3dgs_tpu.utils.metrics import psnr

    # Target: a render of a rich random scene (8K anisotropic gaussians).
    gt, cam = population(2 ** 13, 8000, width, height, seed=23)
    gt = gt.replace(scaling=gt.scaling
                    + jnp.asarray(np.array([0.3, 0.0, -0.4], np.float32)))
    st_t = RenderSettings(image_height=height, image_width=width,
                          use_pallas=True, max_instances=2 ** 17,
                          gaussian_chunk=256, tile_size=32)
    target = render(gt, cam, st_t)["image"]
    cam = cam.replace(image=target)

    config = TrainingConfig(
        iterations=steps, capacity=2 ** 12,
        densify_from_iter=100, densify_until_iter=steps - 200,
        densify_interval=100, densify_grad_threshold=5e-5,
        opacity_reset_interval=0, log_interval=100,
        eval_interval=10 ** 9, save_interval=10 ** 9,
        max_instances=2 ** 17, gaussian_chunk=256, tile_size=32,
        use_pallas=True)
    g0 = create_from_random(jax.random.PRNGKey(1), num_points=2000,
                            scene_extent=1.0, capacity=config.capacity)
    trainer = GaussianTrainer(config, RenderSettings(
        image_height=height, image_width=width, use_pallas=True,
        max_instances=config.max_instances, gaussian_chunk=256,
        tile_size=32))
    trainer.setup(dataset=None, gaussians=g0)

    t0 = time.perf_counter()
    logs = []

    def log_fn(it, m):
        img = render(trainer.state.gaussians, cam, trainer.settings)["image"]
        p = float(psnr(img, target))
        logs.append((it, m["total_loss"], p,
                     int(trainer.state.gaussians.num_alive())))
        print(f"[{it:5d}] loss={m['total_loss']:.4f} psnr={p:5.2f} dB "
              f"alive={logs[-1][3]}", flush=True)

    # drive the trainer loop manually with the single camera
    for _ in range(steps):
        it = trainer.iteration + 1
        m = trainer.train_step(cam, 0)
        from mini3dgs_tpu.train import density
        if density.should_densify(it, config):
            trainer._key, sub = jax.random.split(trainer._key)
            trainer.state, dstats = trainer._densify_step(
                trainer.state, sub, jnp.float32(trainer.scene_extent))
            if (int(dstats["n_alive"])
                    > 0.85 * trainer.state.gaussians.capacity):
                from mini3dgs_tpu.train.trainer import grow_capacity
                trainer.state = grow_capacity(
                    trainer.state, 2 * trainer.state.gaussians.capacity)
                trainer._train_steps = {}
                print(f"[{it:5d}] capacity -> "
                      f"{trainer.state.gaussians.capacity}", flush=True)
        trainer.iteration = it
        if it % config.log_interval == 0:
            log_fn(it, {k: float(v) for k, v in m.items()})

    dt = time.perf_counter() - t0
    final_psnr = logs[-1][2] if logs else 0.0
    print(f"\n{steps} steps in {dt:.1f}s = {steps / dt:.1f} it/s "
          f"(incl. dispatch + densify + recompiles)")
    print(f"final: psnr={final_psnr:.2f} dB, "
          f"alive={int(trainer.state.gaussians.num_alive())}, "
          f"capacity={trainer.state.gaussians.capacity}")
    print("TRAIN PROBE", "OK" if final_psnr > 28.0 else "WEAK")


if __name__ == "__main__":
    main()
