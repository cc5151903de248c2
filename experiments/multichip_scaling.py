"""Multi-chip scaling evidence on the virtual CPU mesh.

The framework's multi-chip story is data parallelism over the Monte-Carlo
trial axis (SURVEY §2.10): trials shard over the mesh ``data`` axis and only
summary statistics cross devices.  The dev host has few physical cores,
so wall-clock speedup from 8 virtual CPU devices is physically
impossible to demonstrate here; the honest, machine-checkable evidence that
the program *scales* is structural, taken from the compiled SPMD module:

* the per-device parameter block of the trial batch is ``num_sims / n`` —
  each device compiles 1/n of the work;
* the only cross-device collective is the scalar error-statistics reduction
  (no all-gather of trial data ever appears).

Wall-clock trials/sec on both mesh sizes is printed too, with the single-core
caveat (expect ~1x here; on n real chips the per-device block is what runs).
"""
import json
import os
import re
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import numpy as np
import jax
import jax.numpy as jnp

jax.config.update("jax_platforms", "cpu")

from jax.sharding import NamedSharding, PartitionSpec as P

from haghighatshoarmuir2024 import CenterCircularArray
from haghighatshoarmuir2024.models.xylo import Demo
from haghighatshoarmuir2024.parallel import make_mesh, make_trial_fn
from haghighatshoarmuir2024.parallel.montecarlo import folded_angle_error

FS = 48_000


def build_step(n_devices: int, num_sims: int, duration=0.05, num_grid=32):
    mesh = make_mesh(n_devices=n_devices, shape=(n_devices, 1))
    geometry = CenterCircularArray(radius=4.5e-2, num_mic=7)
    demo = Demo(
        geometry=geometry,
        freq_bands=[[1600, 1900]],
        doa_list=np.linspace(-np.pi, np.pi, num_grid),
        recording_duration=duration,
        kernel_duration=2e-3,
        bipolar_spikes=True,
        fs=FS,
        use_cache=False,
    )
    t = np.arange(0, duration, 1 / FS)
    sig = np.sin(2 * np.pi * 1750 * t)
    fwd = demo._forward_jit
    trial = make_trial_fn(geometry, t, sig, lambda s: fwd(s)[0], FS)

    def step(keys):
        true, est = jax.vmap(lambda k: trial(k, 10.0))(keys)
        return jnp.mean(folded_angle_error(est, true))

    keys = jax.random.split(jax.random.PRNGKey(0), num_sims)
    sh = NamedSharding(mesh, P("data", None))
    jitted = jax.jit(step, in_shardings=sh, out_shardings=NamedSharding(mesh, P()))
    keys = jax.device_put(keys, sh)
    return jitted, keys


def analyze(n_devices: int, num_sims: int = 64):
    jitted, keys = build_step(n_devices, num_sims)
    compiled = jitted.lower(keys).compile()
    txt = compiled.as_text()

    # per-device block of the trial-key batch (entry parameter shape)
    m = re.search(r"%param[\w.]* = u32\[(\d+),2\]", txt)
    per_device_block = int(m.group(1)) if m else None

    collectives = {
        "all-reduce": len(re.findall(r" all-reduce\(", txt)),
        "all-gather": len(re.findall(r" all-gather\(", txt)),
        "all-to-all": len(re.findall(r" all-to-all\(", txt)),
    }
    # every all-reduce must be scalar (f32[]) — statistics only
    scalar_ar = len(re.findall(r"f32\[\] all-reduce\(", txt))
    # shapes crossing the mesh in gathers (must stay tiny — no trial data)
    gather_shapes = re.findall(r"(\w+\[[\d,]*\]) all-gather\(", txt)

    out = jitted(keys)
    out.block_until_ready()
    t0 = time.perf_counter()
    reps = 3
    for _ in range(reps):
        out = jitted(keys)
    out.block_until_ready()
    dt = (time.perf_counter() - t0) / reps

    return {
        "n_devices": n_devices,
        "num_sims": num_sims,
        "per_device_key_block": per_device_block,
        "collectives": collectives,
        "scalar_all_reduces": scalar_ar,
        "all_gather_shapes": gather_shapes,
        "trials_per_sec_wall": num_sims / dt,
        "mae_rad": float(out),
    }


def main():
    quick = "--quick" in sys.argv
    sims = 32 if quick else 64
    r1 = analyze(1, sims)
    r8 = analyze(8, sims)
    result = {
        "experiment": "multichip_scaling",
        "host_physical_cores": os.cpu_count(),
        "mesh1": r1,
        "mesh8": r8,
        "per_device_work_ratio": (
            r1["per_device_key_block"] / r8["per_device_key_block"]
            if r1["per_device_key_block"] and r8["per_device_key_block"]
            else None
        ),
        "wall_ratio_8_over_1": r8["trials_per_sec_wall"] / r1["trials_per_sec_wall"],
        "note": "single-core host: wall ratio ~1 expected; the scaling claim "
        "rests on the 8x smaller per-device block + scalar-only collectives",
    }
    print(json.dumps(result, indent=2))
    return result


if __name__ == "__main__":
    main()
