"""CLI entry point (reference `main.py` intent: load config -> trainer -> train).

Usage:
    python main.py --config configs/default.yaml [--data PATH] [--iterations N]
"""

from __future__ import annotations

import argparse
import dataclasses
import sys


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="3D Gaussian Splatting in JAX")
    p.add_argument("--config", type=str, default=None, help="YAML config path")
    p.add_argument("--data", type=str, default=None, help="dataset root")
    p.add_argument("--output", type=str, default=None, help="output dir")
    p.add_argument("--iterations", type=int, default=None)
    p.add_argument("--resume", type=int, default=None,
                   help="checkpoint iteration to resume from")
    p.add_argument("--no-pallas", action="store_true",
                   help="use the pure-XLA golden raster path")
    p.add_argument("--mesh-data", type=int, default=None)
    p.add_argument("--mesh-tile", type=int, default=None)
    return p


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    from mini3dgs_tpu.config import ConfigManager, TrainingConfig

    if args.config:
        config = ConfigManager.load_from_yaml(args.config)
    else:
        config = TrainingConfig()
    overrides = {}
    if args.data:
        overrides["data_path"] = args.data
    if args.output:
        overrides["output_path"] = args.output
    if args.iterations:
        overrides["iterations"] = args.iterations
    if args.no_pallas:
        overrides["use_pallas"] = False
    if args.mesh_data:
        overrides["mesh_data"] = args.mesh_data
    if args.mesh_tile:
        overrides["mesh_tile"] = args.mesh_tile
    config = dataclasses.replace(config, **overrides)

    import jax
    if config.device == "cpu":
        # honor `system: device: cpu`: backends are cached after the first
        # query, so switch via config and drop the cache
        jax.config.update("jax_platforms", "cpu")
        import jax.extend.backend as jeb
        jeb.clear_backends()
    from mini3dgs_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()

    from mini3dgs_tpu.train.trainer import GaussianTrainer

    trainer = GaussianTrainer(config)
    trainer.setup()
    if args.resume is not None:
        trainer.load_checkpoint(args.resume)

    def log(it, metrics):
        parts = " ".join(f"{k}={v:.5f}" if isinstance(v, float) else f"{k}={v}"
                         for k, v in metrics.items())
        print(f"[{it:6d}] {parts}", flush=True)

    trainer.train(log_fn=log)
    final = trainer.validate()
    if final:
        print(f"final: psnr={final['psnr']:.2f} ssim={final['ssim']:.4f}")
    trainer.save_checkpoint(trainer.iteration)
    return 0


if __name__ == "__main__":
    sys.exit(main())
