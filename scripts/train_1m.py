"""BASELINE #4 single-card proxy: a REAL optimization run at >= 1M Gaussians.

The reference's eager unbounded-N model
(`/root/reference/src/core/gaussian_model.py:15-31`) cannot approach this
scale; here a 2^20-slot pool seeded with 1M analytic surface samples of the
procedural SDF scene trains the full L1+D-SSIM / 5-group-Adam step (densify
off — the pool starts full) at 800^2 on one card, recording steady-state
it/s and device-memory headroom.

Usage:  python scripts/train_1m.py [--iters 500] [--scene data/sdf_scene]
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", type=str, default="data/sdf_scene")
    ap.add_argument("--iters", type=int, default=500)
    ap.add_argument("--n-points", type=int, default=1_000_000)
    ap.add_argument("--capacity", type=int, default=2 ** 20)
    ap.add_argument("--max-instances", type=int, default=2 ** 22)
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp

    from make_synthetic_scene import sample_surface_points
    from mini3dgs_tpu.config import TrainingConfig
    from mini3dgs_tpu.core.gaussians import create_from_pcd
    from mini3dgs_tpu.core.sh import C0
    from mini3dgs_tpu.data.dataset import BlenderDataset
    from mini3dgs_tpu.train.trainer import GaussianTrainer

    cfg = TrainingConfig(
        data_path=args.scene, output_path="runs/sdf_1m",
        iterations=args.iters, eval_interval=args.iters,
        save_interval=10 ** 9, log_interval=50,
        densify_from_iter=10 ** 9, densify_until_iter=0,
        opacity_reset_interval=0, prune_interval=10 ** 9,
        image_height=800, image_width=800,
        background_color=[1.0, 1.0, 1.0],
        tile_size=32, sh_degree=0, color_mode="sh",
        sh_increase_interval=0,
        capacity=args.capacity, max_instances=args.max_instances,
        gaussian_chunk=256, use_pallas=True)

    ds = BlenderDataset(args.scene, white_background=True)
    ds.load_cameras()
    print(f"{len(ds.get_train_cameras())} train cameras", flush=True)

    pts, cols = sample_surface_points(n=args.n_points)
    colors = (np.asarray(cols, np.float32) - 0.5) / C0
    g = create_from_pcd(pts, colors, capacity=args.capacity)
    print(f"{args.n_points} seed points in a {args.capacity}-slot pool",
          flush=True)

    tr = GaussianTrainer(cfg)
    tr.setup(dataset=ds, gaussians=g)

    t_first = time.perf_counter()
    tr.train(iterations=1, log_fn=None)      # compile + first step
    print(f"first step (compile): {time.perf_counter() - t_first:.1f}s",
          flush=True)

    def log(it, m):
        print(f"[{it:5d}] loss={m['total_loss']:.5f} l1={m['l1']:.5f}",
              flush=True)

    t0 = time.perf_counter()
    tr.train(iterations=args.iters - 1, log_fn=log)
    jax.block_until_ready(tr.state.gaussians.xyz)
    dt = time.perf_counter() - t0
    its = (args.iters - 1) / dt
    print(f"window 1: {dt:.1f}s for {args.iters - 1} it "
          f"-> {its:.2f} it/s ({1e3 / its:.1f} ms/it incl. dispatch; may "
          f"include auto_max_instances resize recompiles)", flush=True)
    # steady-state window AFTER any auto-resize recompiles have settled
    t1 = time.perf_counter()
    tr.train(iterations=200, log_fn=None)
    jax.block_until_ready(tr.state.gaussians.xyz)
    dt1 = time.perf_counter() - t1
    print(f"steady-state: {dt1:.1f}s for 200 it -> {200 / dt1:.2f} it/s "
          f"({dt1 * 5:.1f} ms/it incl. dispatch; "
          f"max_instances={tr.settings.max_instances})", flush=True)

    try:
        stats = jax.local_devices()[0].memory_stats() or {}
        used = stats.get("bytes_in_use", 0) / 2 ** 30
        lim = stats.get("bytes_limit", 0) / 2 ** 30
        print(f"device memory: {used:.2f} GiB in use / {lim:.2f} GiB limit",
              flush=True)
    except Exception as e:
        print(f"memory stats unavailable: {e}", flush=True)

    m = tr.validate()
    print(f"eval after {args.iters} it: psnr={m.get('psnr', 0):.2f} "
          f"ssim={m.get('ssim', 0):.4f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
