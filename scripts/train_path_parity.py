"""Training-quality parity gate: raster kernels vs the golden XLA oracle
over a REAL (short) optimization run, same seed.

The per-step gradient parity gates (mini3dgs_tpu/checks.py) bound one step;
this closes the loop end-to-end: two identical training runs — same scene,
same camera schedule, same init — one through the raster kernel
path, one through the reference-semantics golden XLA path, must land at
the same reconstruction quality.  Per-step f32 deviations (exp
implementation gate flips, block association) random-walk
under Adam, so the gate is on the FINAL metric, not the trajectory.

Usage:  python scripts/train_path_parity.py [--iters 1000] [--size 256]
Prints both PSNRs and PASS/FAIL against --gate-db (default 0.5 dB).
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np


def run_path(use_pallas: bool, args) -> dict:
    import jax
    from mini3dgs_tpu.config import TrainingConfig
    from mini3dgs_tpu.data.dataset import RandomDataset
    from mini3dgs_tpu.train.trainer import GaussianTrainer

    cfg = TrainingConfig(
        capacity=args.capacity, iterations=args.iters,
        image_height=args.size, image_width=args.size,
        eval_interval=10 ** 9, save_interval=10 ** 9, log_interval=200,
        densify_from_iter=500, densify_until_iter=args.iters // 2,
        densify_interval=100, opacity_reset_interval=0,
        prune_interval=1000,
        position_lr_max_steps=args.iters,
        tile_size=32, sh_degree=0, color_mode="dc_sigmoid",
        use_pallas=use_pallas, max_instances=args.max_instances,
        gaussian_chunk=256, seed=7)
    ds = RandomDataset(n_cameras=6, width=args.size, height=args.size,
                       seed=3)
    ds.load_cameras()
    tr = GaussianTrainer(cfg)
    tr.setup(dataset=ds)
    t0 = time.perf_counter()
    tr.train(log_fn=lambda it, m: print(
        f"  [{'pallas' if use_pallas else 'golden'} {it:5d}] "
        f"loss={m['total_loss']:.5f}", flush=True))
    jax.block_until_ready(tr.state.gaussians.xyz)
    dt = time.perf_counter() - t0
    m = tr.validate()
    m["seconds"] = dt
    m["n_alive"] = int(tr.state.gaussians.num_alive())
    return m


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=1000)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--capacity", type=int, default=4096)
    ap.add_argument("--max-instances", type=int, default=2 ** 17)
    ap.add_argument("--gate-db", type=float, default=0.5)
    args = ap.parse_args(argv)

    res = {}
    for use_pallas in (True, False):
        name = "pallas" if use_pallas else "golden"
        print(f"--- training {name} path ({args.iters} it, "
              f"{args.size}^2) ---", flush=True)
        res[name] = run_path(use_pallas, args)
        print(f"{name}: psnr={res[name]['psnr']:.2f} "
              f"ssim={res[name]['ssim']:.4f} "
              f"alive={res[name]['n_alive']} "
              f"({res[name]['seconds']:.0f}s)", flush=True)

    d = abs(res["pallas"]["psnr"] - res["golden"]["psnr"])
    ok = d <= args.gate_db
    print(f"PSNR delta {d:.3f} dB (gate {args.gate_db}) -> "
          f"{'PASS' if ok else 'FAIL'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
