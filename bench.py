"""Flagship benchmark: throughput of the full encode→SNN→DoA pipeline on one GPU.

Prints the device on one line, then ONE JSON line:
  {"metric": ..., "value": N, "unit": "audio-sec/sec", "vs_baseline": N,
   "device": {"platform", "kind", "count"}}

Metric definition (BASELINE.json): audio seconds processed per wall-clock
second per device by the complete quantized 7-mic Hilbert-SNN localization
pipeline (STHT → filterbank → RZCC encode → integer-LIF SNN → rate → DoA).
Baseline = 1x real-time (the reference's XyloSim path is slower than
real-time on a host CPU, SURVEY §6.4), so vs_baseline == value.

Config matches the reference live demo defaults
(micloc/xylo_snn_localization.py:685-741): CenterCircularArray 7 mics r=4.5cm,
one band, 0.25 s frames, 10 ms kernel, fs 48 kHz, 449-point DoA grid, with
the calibrated matched estimator.  ``HM2024_BENCH_FS=24000`` runs the
accuracy-transparent 24 kHz mode (experiments/reduced_rate.py).

Exits non-zero, with no result, when JAX finds no GPU.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np


def card() -> str:
    """``name, power.limit`` of the card, read by a child that stays off JAX."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"
    return r.stdout.strip()


def main():
    import jax
    import jax.numpy as jnp

    devs = jax.devices()
    if devs[0].platform != "gpu":
        sys.exit(f"bench.py: no GPU (JAX found {devs}); refusing to time the CPU")
    device = {"platform": devs[0].platform, "kind": devs[0].device_kind, "count": len(devs)}
    print(f"# device {device['platform']} {device['kind']} x{device['count']}; "
          f"card {card()}", flush=True)

    from haghighatshoarmuir2024 import CenterCircularArray
    from haghighatshoarmuir2024.models.xylo import Demo
    from haghighatshoarmuir2024.ops.interp import signal_from_template

    fs = int(os.environ.get("HM2024_BENCH_FS", "48000"))
    frame = 0.25
    num_grid = 64 * 7 + 1
    geometry = CenterCircularArray(radius=4.5e-2, num_mic=7)

    t0 = time.time()
    demo = Demo(
        geometry=geometry,
        freq_bands=[[1600, 1900]],
        doa_list=np.linspace(-np.pi, np.pi, num_grid),
        recording_duration=frame,
        kernel_duration=10e-3,
        bipolar_spikes=True,
        fs=fs,
    )
    design_time = time.time() - t0

    # batch of audio frames (sources at assorted DoAs + noise), synthesized
    # in one vmapped call
    t = np.arange(0, frame, 1 / fs)
    sig = np.sin(2 * np.pi * 1750 * t)
    batch_size = 96
    doas = np.linspace(-np.pi, np.pi, batch_size, endpoint=False)
    frames = np.asarray(
        jax.jit(
            jax.vmap(lambda d: signal_from_template(geometry, t, sig, d, fs=fs))
        )(jnp.asarray(doas))
    ).astype(np.float32)
    frames = frames + 0.1 * np.random.default_rng(0).standard_normal(
        frames.shape
    ).astype(np.float32)
    frames_j = jnp.asarray(frames)

    # matched-profile calibration (cached with the design)
    t0c = time.time()
    demo.calibrate_profiles()
    calib_time = time.time() - t0c

    # warm-up / compile — ONE program: the matched forward returns the folded
    # rate profile too, so the reference-parity peak estimate is its argmax
    t0w = time.time()
    doa, rate = demo.forward_batch(frames_j, method="matched")
    doa.block_until_ready()
    compile_time = time.time() - t0w
    doa_peak = np.asarray(demo.doa_list)[np.argmax(np.asarray(rate), axis=-1)]

    # timed runs of the jitted flagship program, pipelined, ending in a block
    fn = demo._forward_batch_matched_jit
    n_rep = 100
    t1 = time.time()
    for _ in range(n_rep):
        doa, rate = fn(frames_j)
    doa.block_until_ready()
    elapsed = (time.time() - t1) / n_rep

    audio_sec = batch_size * frame
    throughput = audio_sec / elapsed

    # sanity gate: matched estimates must land within a few grid steps
    # (grid step = 360/449 ≈ 0.8°; gate 5°), reference-parity peak reported too
    def ok_frac(est, tol_deg):
        err = np.abs(np.arcsin(np.abs(np.sin(np.asarray(est) - doas))))
        return float(np.mean(np.rad2deg(err) < tol_deg))

    ok_matched = ok_frac(doa, 5.0)
    ok_peak = ok_frac(doa_peak, 25.0)

    metric = (
        "audio-sec/sec/device full encode->SNN->DoA pipeline "
        "(7-mic Hilbert-SNN, 449-DoA grid, matched estimator)"
    )
    if fs != 48_000:
        metric += f" [reduced-rate variant fs={fs}]"
    print(
        f"# design {design_time:.1f}s, calib {calib_time:.1f}s, compile {compile_time:.1f}s, "
        f"batch {batch_size} x {frame}s frames in {elapsed*1000:.3f} ms, "
        f"doa-ok-frac {ok_matched:.2f} @5deg (matched), "
        f"{ok_peak:.2f} @25deg (reference-parity peak)",
        file=sys.stderr,
    )
    if ok_matched < 1.0:
        print("# WARNING: matched accuracy gate failed", file=sys.stderr)
    print(
        json.dumps(
            {
                "metric": metric,
                "value": throughput,
                "unit": "audio-sec/sec",
                "vs_baseline": throughput,
                "device": device,
            }
        )
    )


if __name__ == "__main__":
    main()
