"""Flagship step on the GPU: formulation choices and stage attribution.

Times the jitted flagship program (``Demo.forward_batch(method="matched")``,
B frames of 0.25 s at 48 kHz, 449-point grid) under each formulation the
pipeline chooses between on an accelerator, all inside the same jitted
step:

    lif    kernel   the Pallas (Triton) LIF kernel      (ops/pallas/lif_kernel.py)
           scan     the lax.scan simulator              (models/xylo/sim.py)
    iir    blocked  lifted block form of bandpass+cumsum (ops/iir._iir_cumsum_blocked)
           scan     sequential scan of the folded filter

and attributes the default step to its stages by timing jitted prefixes of
the same program on device-resident inputs:

    encode = t(encode)
    rzcc   = t(encode + rzcc) - t(encode)
    lif    = t(encode + rzcc + lif) - t(encode + rzcc)
    rest   = t(step) - t(encode + rzcc + lif)

Every time is the mean over ``--reps`` pipelined calls that end in
``block_until_ready``, after a warm-up call that compiles.  The script
refuses to run without an accelerator.

Usage: python experiments/flagship_attribution.py [--batch 96] [--reps 20]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from haghighatshoarmuir2024 import CenterCircularArray  # noqa: E402
from haghighatshoarmuir2024.models.xylo import Demo, pipeline  # noqa: E402
from haghighatshoarmuir2024.ops.interp import signal_from_template  # noqa: E402
from haghighatshoarmuir2024.ops.pallas import lif_kernel  # noqa: E402
from haghighatshoarmuir2024.ops.peaks import rzcc_encode_bipolar_tm  # noqa: E402

FS = 48_000


def card() -> str:
    """Card name and power limit, read by a child that stays off JAX."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()


def timeit(fn, args, reps):
    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps * 1e3, compile_s


def flagship(batch: int):
    geometry = CenterCircularArray(radius=4.5e-2, num_mic=7)
    demo = Demo(
        geometry=geometry,
        freq_bands=[[1600, 1900]],
        doa_list=np.linspace(-np.pi, np.pi, 449),
        recording_duration=0.25,
        kernel_duration=10e-3,
        bipolar_spikes=True,
        fs=FS,
    )
    demo.calibrate_profiles()
    t = np.arange(0, 0.25, 1 / FS)
    doas = np.linspace(-np.pi, np.pi, batch, endpoint=False)
    frames = jax.jit(
        jax.vmap(lambda d: signal_from_template(geometry, t, np.sin(2 * np.pi * 1750 * t), d, fs=FS))
    )(jnp.asarray(doas))
    noise = 0.1 * np.random.default_rng(0).standard_normal(frames.shape)
    return demo, frames + jnp.asarray(noise, jnp.float32), doas


def step_time(demo, frames, reps, lif="kernel", iir="blocked"):
    """Build the matched flagship step under one formulation choice and time
    it.  The choices are swapped at the module switches the pipeline reads
    while tracing, and every trace cache is dropped around the build."""
    saved = (lif_kernel.on_accelerator, pipeline.on_accelerator)
    lif_kernel.on_accelerator = lambda: lif == "kernel"
    pipeline.on_accelerator = lambda: iir == "blocked"
    try:
        jax.clear_caches()
        for name in ("_rates_batch_jit", "_forward_batch_jit", "_forward_batch_matched_jit"):
            demo.__dict__.pop(name, None)
        fn = demo._forward_batch_matched_jit
        ms, compile_s = timeit(fn, (frames,), reps)
        doa, rate = fn(frames)
        return ms, compile_s, np.asarray(doa), np.asarray(rate)
    finally:
        lif_kernel.on_accelerator, pipeline.on_accelerator = saved
        jax.clear_caches()
        for name in ("_rates_batch_jit", "_forward_batch_jit", "_forward_batch_matched_jit"):
            demo.__dict__.pop(name, None)


def stage_prefixes(demo, frames, reps):
    kernel = np.asarray(demo.beamfs[0].kernel, np.float32)
    bas, rw, cfg = demo._bas, demo.beamfs[0].robust_width, demo.xylo_config
    def encode(x):
        return jax.vmap(
            lambda s: pipeline._encode_cumsum(s, kernel, bas=bas, time_major=True),
            out_axes=1,
        )(x)

    def rzcc(x):
        cs = encode(x)
        T, B, C = cs.shape
        kp, kn = rzcc_encode_bipolar_tm(cs.reshape(T, B * C), rw, 2 * rw)
        return kp.reshape(T, B, C), kn.reshape(T, B, C)

    def lif(x):
        kp, kn = rzcc(x)
        return lif_kernel.lif_count_rates_bipolar(cfg, kp, kn, spike_bound=1)

    t_enc, _ = timeit(jax.jit(encode), (frames,), reps)
    t_rz, _ = timeit(jax.jit(rzcc), (frames,), reps)
    t_lif, _ = timeit(jax.jit(lif), (frames,), reps)
    t_all, _ = timeit(demo._forward_batch_matched_jit, (frames,), reps)
    return {
        "encode_ms": t_enc,
        "rzcc_ms": t_rz - t_enc,
        "lif_ms": t_lif - t_rz,
        "rest_ms": t_all - t_lif,
        "step_ms": t_all,
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=96)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    dev = jax.devices()[0]
    if dev.platform == "cpu":
        sys.exit("flagship_attribution: no accelerator; refusing to time the CPU")
    print(f"# device {dev.platform} {dev.device_kind} x{len(jax.devices())}; card {card()}")

    demo, frames, doas = flagship(args.batch)
    audio_s = args.batch * 0.25
    results = {}
    ref = None
    for label, kw in [
        ("default", {}),
        ("lif=scan", {"lif": "scan"}),
        ("iir=scan", {"iir": "scan"}),
        ("default-again", {}),
    ]:
        try:
            ms, compile_s, doa, rate = step_time(demo, frames, args.reps, **kw)
        except Exception as e:  # report the variant and go on with the next
            print(f"{label:>14s}: FAILED {type(e).__name__}: {str(e)[:2000]}", flush=True)
            continue
        err = np.rad2deg(np.abs(np.arcsin(np.abs(np.sin(doa - doas)))))
        same = None if ref is None else bool(np.array_equal(doa, ref[0]))
        rel = None if ref is None else float(
            np.max(np.linalg.norm(rate - ref[1], axis=-1) / np.linalg.norm(ref[1], axis=-1))
        )
        if ref is None:
            ref = (doa, rate)
        results[label] = {
            "step_ms": ms, "compile_s": compile_s, "audio_s_per_s": audio_s / ms * 1e3,
            "gate_5deg": float(np.mean(err < 5.0)), "doa_equal_default": same,
            "rate_rel_diff_vs_default": rel,
        }
        print(f"{label:>14s}: step {ms:9.3f} ms  compile {compile_s:6.1f} s  "
              f"gate@5 {np.mean(err < 5.0):.2f}  doa==default {same}  rate rel {rel}",
              flush=True)
    stages = stage_prefixes(demo, frames, args.reps)
    print("stages (default formulation): " + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()))
    print(json.dumps({"device_kind": dev.device_kind, "card": card(), "batch": args.batch,
                      "variants": results, "stages": stages}))


if __name__ == "__main__":
    main()
