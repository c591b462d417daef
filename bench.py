"""Benchmark: fwd+bwd render step on the flagship scene, on a GPU.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...}.

Metric: Mpixels/s of a full differentiable render step (projection ->
binning/sort -> pack -> Triton tile raster -> loss -> hand-written VJP
backward -> pack backward) at 800x800 with 100K Gaussians, tile 32.  Each
step is timed on the host clock and ends in block_until_ready.  vs_baseline
is the plain reference path (ops/raster_ref.py) timed in the same process,
divided by the kernel path's time.  The device is named in the output; the
script fails without a GPU instead of measuring something else.
"""

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import jax


def measure(C, aniso: bool, use_pallas: bool, reps: int) -> dict:
    g, cam = C.population(2 ** 17, 100_000, 800, 800, aniso=aniso)
    st = C.settings(800, 800, 32, use_pallas, max_instances=1536 * 256,
                    max_dup_per_axis=3, sh_degree=0)
    return C.time_step(C.step_fn(st), C.step_args(g, cam, st), reps)


def main() -> int:
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench.py measures a GPU; JAX found {dev.platform!r}",
              file=sys.stderr)
        return 1
    from mini3dgs_tpu import checks as C
    from mini3dgs_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()

    iso = measure(C, False, True, 20)
    aniso = measure(C, True, True, 20)
    ref = measure(C, False, False, 2)
    mpix = lambda r: 800 * 800 / r["mean_ms"] / 1e3
    print(json.dumps({
        "metric": "fwd+bwd render Mpixels/s (800x800, 100K gaussians, "
                  "tile 32)",
        "value": round(mpix(iso), 3),
        "unit": "Mpix/s",
        "vs_baseline": round(ref["mean_ms"] / iso["mean_ms"], 3),
        "ms_per_step": iso["mean_ms"],
        "min_ms_per_step": iso["min_ms"],
        "reps": iso["reps"],
        "aniso_rotated_mpix_s": round(mpix(aniso), 3),
        "reference_ms_per_step": ref["mean_ms"],
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
