"""Smoke run of the render and train path on a GPU.

    python chip_smoke.py          # one card: every phase below, in order
    python chip_smoke.py --four   # four cards: the sharded training routes
                                  # against the single-card step, and nothing
                                  # else

Phases (one card), each of which must pass:
  device   platform gpu, device kind, JAX version, the card's name and
           power limit (nvidia-smi), the compile-cache directory;
  compile  lower and compile the flagship fwd+bwd step (100K Gaussians,
           800x800, tile 32) and print its memory analysis;
  parity   the Triton raster kernels against the plain reference
           (ops/raster_ref.py, matmuls at HIGHEST) at real widths:
           isotropic and anisotropic populations, tiles 32 and 16, one
           non-square frame that is not a tile multiple; forward image /
           alpha / depth and the gradients of every parameter group, gated
           against a cliff floor calibrated in this process (reference here
           against reference on the CPU); and the t0 (ring) op against
           itself split in two;
  timing   warm fwd+bwd ms/step of the kernel path and of the reference path
           at the flagship size;
  trainer  GaussianTrainer through the calls main.py makes (setup, train
           with the initial stream probe, densify events and a pool
           compaction, validate, save / load checkpoint), then main.main().

The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Without a GPU the script exits 1 and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def log(*args):
    print(*args, flush=True)


@contextlib.contextmanager
def phase(name):
    log(f"== {name}")
    t0 = time.perf_counter()
    yield
    log(f"== {name} passed in {time.perf_counter() - t0:.1f} s")


def card_info() -> str:
    """The card's name and power limit, read by nvidia-smi (off JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def device_phase(jax):
    from mini3dgs_tpu.utils.compile_cache import enable_compile_cache
    cache = enable_compile_cache()
    dev = jax.devices()[0]
    log(f"platform={dev.platform} device_kind={dev.device_kind} "
        f"count={len(jax.devices())} jax={jax.__version__}")
    card = card_info()
    log(f"nvidia-smi: {card}")
    log(f"compile cache: {cache}")
    return card


FLAGSHIP = dict(n=100_000, capacity=2 ** 17, width=800, height=800)


def flagship_settings(C, use_pallas=True):
    # the flagship population's exact-fit stream (n_dropped == 0) and
    # duplication bound; dc_sigmoid colors as in the benchmark step
    return C.settings(800, 800, 32, use_pallas, max_instances=1536 * 256,
                      max_dup_per_axis=3, sh_degree=0)


def compile_phase(C):
    g, cam = C.population(**FLAGSHIP)
    st = flagship_settings(C)
    args = C.step_args(g, cam, st)
    t0 = time.perf_counter()
    compiled = C.step_fn(st).lower(*args).compile()
    log(f"flagship fwd+bwd step compiled in {time.perf_counter() - t0:.1f} s")
    log(f"memory_analysis: {compiled.memory_analysis()}")


PARITY_CASES = (
    # (name, aniso, width, height, tile)
    ("iso 800x800 tile 32", False, 800, 800, 32),
    ("aniso 800x800 tile 32", True, 800, 800, 32),
    ("iso 800x800 tile 16", False, 800, 800, 16),
    ("aniso 1000x664 tile 16 (non-square, not a tile multiple)", True,
     1000, 664, 16),
)


def parity_phase(C, n=100_000, capacity=2 ** 17, cases=PARITY_CASES,
                 calib_rows=16):
    calib = {}
    for aniso in (False, True):
        g, cam = C.population(capacity, n, 800, 800, aniso=aniso)
        st = C.settings(800, 800, 32, False)
        log(f"{'aniso' if aniso else 'iso'} population:")
        calib[aniso] = C.calibrate(g, cam, st, rows=calib_rows, log=log)
    for name, aniso, w, h, ts in cases:
        g, cam = C.population(capacity, n, w, h, aniso=aniso)
        st, n_live = C.sized_stream(g, cam, C.settings(w, h, ts, True))
        log(f"{name}: {n_live} instances, stream {st.max_instances}")
        C.kernel_parity(g, cam, st, calib[aniso], log=log,
                        skip={} if aniso else C.ISOTROPIC_SKIP)
    g, cam = C.population(capacity, n, 800, 800)
    st, _ = C.sized_stream(g, cam, C.settings(800, 800, 32, True))
    C.t0_split_parity(g, cam, st, log=log)


def timing_phase(C, card, reps=(20, 5)):
    g, cam = C.population(**FLAGSHIP)
    res = {}
    for name, use_pallas, r in (("triton kernels", True, reps[0]),
                                ("reference (XLA)", False, reps[1])):
        st = flagship_settings(C, use_pallas)
        res[name] = C.time_step(C.step_fn(st), C.step_args(g, cam, st), r)
        log(f"fwd+bwd 800x800 / 100K, tile 32, {name}: "
            f"{res[name]['mean_ms']:.3f} ms/step mean, "
            f"{res[name]['min_ms']:.3f} min over {r} warm steps "
            f"[{card}]")
    k, x = res["triton kernels"], res["reference (XLA)"]
    log(f"kernel vs reference: {x['mean_ms'] / k['mean_ms']:.1f}x "
        f"({'kernel faster' if k['mean_ms'] < x['mean_ms'] else 'KERNEL SLOWER'})")
    if k["mean_ms"] >= x["mean_ms"]:
        raise RuntimeError("the raster kernels lose to the reference path")


def trainer_phase(C, n=100_000, width=800, height=800, steps=30,
                  out_dir=ROOT / "output" / "chip_smoke"):
    import math

    import numpy as np

    from mini3dgs_tpu.config import TrainingConfig
    from mini3dgs_tpu.data.dataset import RandomDataset
    from mini3dgs_tpu.train.trainer import GaussianTrainer

    cap = 2 ** math.ceil(math.log2(n) + 1)     # room the compaction reclaims
    g, _ = C.population(cap, n, width, height)
    cfg = TrainingConfig(
        capacity=cap, image_height=height, image_width=width, tile_size=32,
        color_mode="sh", sh_degree=3, sh_increase_interval=0,
        max_instances=2 ** 20, iterations=steps, log_interval=1,
        eval_interval=steps, save_interval=10 ** 9,
        densify_from_iter=10, densify_until_iter=20, densify_interval=10,
        opacity_reset_interval=0, output_path=str(out_dir))
    ds = RandomDataset(width=width, height=height)
    ds.load_cameras()
    trainer = GaussianTrainer(cfg)
    trainer.setup(dataset=ds, gaussians=g)
    losses, pools = [], []
    events = []

    def record(it, metrics):
        losses.append(metrics["total_loss"])
        pool = trainer.state.gaussians.capacity
        if not pools or pools[-1] != pool:
            pools.append(pool)
        if "n_alive" in metrics:
            events.append(f"densify@{it}: {int(metrics['n_alive'])} alive")

    trainer.train(log_fn=record)
    log(f"losses: first {losses[0]:.6f} last {losses[-1]:.6f} "
        f"({len(losses)} steps); {'; '.join(events)}; stream "
        f"{cfg.max_instances} -> {trainer.settings.max_instances}; pool "
        f"{' -> '.join(str(p) for p in pools)}")
    if not np.all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise RuntimeError(f"training did not converge: {losses}")
    if not events or trainer.settings.max_instances == cfg.max_instances:
        raise RuntimeError("no densify event or no stream probe resize")
    if len(pools) < 2:
        raise RuntimeError("the pool was never resized")
    metrics = trainer.validate()
    log(f"validate: psnr={metrics['psnr']:.3f} ssim={metrics['ssim']:.4f}")
    trainer.save_checkpoint(trainer.iteration)
    xyz = np.asarray(trainer.state.gaussians.xyz)
    trainer.load_checkpoint(trainer.iteration)
    if not np.array_equal(np.asarray(trainer.state.gaussians.xyz), xyz):
        raise RuntimeError("checkpoint round trip changed the state")
    log(f"checkpoint round trip at iteration {trainer.iteration}: exact")

    import main
    rc = main.main(["--config", str(ROOT / "configs" / "default.yaml"),
                    "--iterations", "3",
                    "--output", str(out_dir / "main")])
    if rc != 0:
        raise RuntimeError(f"main.main returned {rc}")


def four_phase(C, n=1_000_000, size=1024, tile=32, meshes=((1, 4), (2, 2))):
    """Sharded training routes on four cards against card 0."""
    import math

    import numpy as np

    from mini3dgs_tpu.core.camera import Camera

    # anisotropic: isotropic splats have no rotation gradient to compare
    g, cam = C.population(2 ** math.ceil(math.log2(n)), n, size, size,
                          aniso=True)
    st, n_live = C.sized_stream(
        g, cam, C.settings(size, size, tile, True, sh_degree=0))
    log(f"{n} Gaussians at {size}x{size}, tile {tile}: {n_live} instances, "
        f"stream {st.max_instances} per device")
    targets = np.random.default_rng(3).uniform(0, 1, (2, 3, size, size))
    # a second view for the data axis (static metadata equal to the first)
    cam2 = Camera.create(0, np.eye(3), np.array([0.1, 0.0, -3.0]),
                         math.radians(60), math.radians(60), width=size,
                         height=size)
    cams = [cam.replace(image=targets[0].astype(np.float32)),
            cam2.replace(image=targets[1].astype(np.float32))]
    C.sharded_parity(g, cams, st, meshes=meshes, log=log)
    import jax
    for d in jax.devices():   # every card must have held its share
        stats = d.memory_stats() or {}
        log(f"  {d}: peak {stats.get('peak_bytes_in_use', 0) / 2**30:.2f} "
            "GiB in use")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="four cards: sharded routes against one card only")
    args = ap.parse_args(argv)

    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"no GPU: JAX found platform {dev.platform!r}",
              file=sys.stderr)
        return 1
    need = 4 if args.four else 1
    if len(jax.devices()) < need:
        print(f"need {need} GPUs, found {len(jax.devices())}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from mini3dgs_tpu import checks as C

    with phase("device"):
        card = device_phase(jax)
    if args.four:
        with phase("four cards: sharded routes vs card 0"):
            four_phase(C)
    else:
        with phase("compile"):
            compile_phase(C)
        with phase("parity"):
            parity_phase(C)
        with phase("timing"):
            timing_phase(C, card)
        with phase("trainer"):
            trainer_phase(C)
    log(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
