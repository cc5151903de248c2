"""Multi-band flagship throughput + accuracy on the GPU.

The reference's live benchmark spans three bands — 1600-2000 / 2000-2300 /
2300-2600 Hz (paper_plots/snn_localization_benchmark.py:549-583; committed
data dirs demo-benchmark-simulation-freq*) — while bench.py's headline number
is single-band.  This experiment times the SAME flagship program at F=3:
3x encode channels (STHT -> 3-band filterbank -> RZCC) and 3x hidden SNN
blocks (hidden N = 3*449), with per-band rate folding into the DoA profile
(micloc/xylo_snn_localization.py:379-398), and gates accuracy the same way
bench.py does.

Usage: python experiments/multiband_bench.py  (owns the GPU for a few min)
"""
import json
import sys
import time

import numpy as np


def main():
    import os

    import jax

    from haghighatshoarmuir2024.utils.cache import (
        compilation_cache_dir,
        enable_persistent_compilation_cache,
    )

    enable_persistent_compilation_cache()
    cache_dir = compilation_cache_dir()

    import jax.numpy as jnp

    from common import jittered_sinusoid_template

    from haghighatshoarmuir2024 import CenterCircularArray
    from haghighatshoarmuir2024.models.xylo import Demo
    from haghighatshoarmuir2024.ops.interp import signal_from_template

    # --fs=24000 runs the measured-transparent reduced-rate variant
    # (experiments/reduced_rate.py; the --band=hi row gates the highest band)
    fs = 48_000
    for a in sys.argv[1:]:
        if a.startswith("--fs="):
            fs = int(a.split("=", 1)[1])
    frame = 0.25
    num_grid = 64 * 7 + 1
    freq_bands = [[1600.0, 2000.0], [2000.0, 2300.0], [2300.0, 2600.0]]
    geometry = CenterCircularArray(radius=4.5e-2, num_mic=7)

    # enforce_hw_limits=False: 3 bands x 449 grid = 1347 hidden neurons,
    # beyond the 1000-neuron Xylo-A2 chip — which is exactly why the
    # reference's live benchmark ran ONE band at a time
    # (snn_localization_benchmark.py:556-562, two bands commented out).  The
    # integer simulator has no neuron-count limit, so the full 3-band
    # network runs as a software deployment.
    t0 = time.time()
    demo = Demo(
        geometry=geometry,
        freq_bands=freq_bands,
        doa_list=np.linspace(-np.pi, np.pi, num_grid),
        recording_duration=frame,
        kernel_duration=10e-3,
        bipolar_spikes=True,
        fs=fs,
        enforce_hw_limits=False,
    )
    design_time = time.time() - t0

    # wideband test signal spanning all three bands (jittered sum of the
    # band centers — the live benchmark's template class,
    # snn_localization_benchmark.py:116-148)
    t = np.arange(0, frame, 1 / fs)
    sig = np.zeros_like(t)
    for band in freq_bands:
        _, s = jittered_sinusoid_template(float(np.mean(band)), frame, fs=fs, seed=1)
        sig = sig + s
    sig /= np.abs(sig).max()

    batch_size = 96
    key = jax.random.PRNGKey(0)
    doas = np.linspace(-np.pi, np.pi, batch_size, endpoint=False)
    frames = np.stack(
        [
            np.asarray(signal_from_template(geometry, t, sig, float(d), fs=fs))
            for d in doas
        ]
    ).astype(np.float32)
    frames = frames + 0.1 * np.asarray(
        jax.random.normal(key, frames.shape), dtype=np.float32
    )
    frames_j = jnp.asarray(frames)

    t0c = time.time()
    demo.calibrate_profiles(template=(t, sig))
    calib_time = time.time() - t0c

    doa, rate = demo.forward_batch(frames_j, method="matched")
    doa_peak, _ = demo.forward_batch(frames_j, method="peak")
    doa.block_until_ready()
    compile_time = time.time() - t0 - design_time - calib_time

    fn = demo._forward_batch_matched_jit
    n_rep = 100
    t1 = time.time()
    for _ in range(n_rep):
        doa, rate = fn(frames_j)
    doa.block_until_ready()
    elapsed = (time.time() - t1) / n_rep

    throughput = batch_size * frame / elapsed

    def ok_frac(est, tol_deg):
        err = np.abs(np.arcsin(np.abs(np.sin(np.asarray(est) - doas))))
        return float(np.mean(np.rad2deg(err) < tol_deg))

    print(
        json.dumps(
            {
                "experiment": "multiband_flagship_bench",
                "fs": fs,
                "freq_bands": freq_bands,
                "batch": batch_size,
                "throughput_audio_sec_per_sec": round(throughput, 2),
                "ms_per_batch": round(elapsed * 1000, 2),
                "design_s": round(design_time, 1),
                "calib_s": round(calib_time, 1),
                "compile_s": round(compile_time, 1),
                "doa_ok_frac_matched_5deg": ok_frac(doa, 5.0),
                "doa_ok_frac_peak_25deg": ok_frac(doa_peak, 25.0),
            },
            indent=2,
        )
    )


if __name__ == "__main__":
    main()
