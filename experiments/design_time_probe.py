"""Attribute the flagship design-time cold start.

bench.py's stderr breakdown showed design 3.8 s (r01) -> 14.6 s (r02).  This
probe separates the three candidate costs of `Demo.__init__` at bench config
(449-grid, one band):

  * XLA compilation of the design program (cold vs warm persistent cache),
  * device execution of the batched covariance/eigh design,
  * host-side quantization/spec assembly.

Run twice in a row; the delta between runs is the compile share (the
persistent jax compilation cache makes run 2 warm).
"""
import json
import os
import time

import numpy as np


def main():
    import jax

    from haghighatshoarmuir2024.utils.cache import (
        compilation_cache_dir,
        enable_persistent_compilation_cache,
    )

    enable_persistent_compilation_cache()
    cache_dir = compilation_cache_dir()

    from common import FS

    from haghighatshoarmuir2024 import CenterCircularArray
    from haghighatshoarmuir2024.models.xylo import Demo
    from haghighatshoarmuir2024.models.snn_beamformer import SNNBeamformer

    geometry = CenterCircularArray(radius=4.5e-2, num_mic=7)
    grid = np.linspace(-np.pi, np.pi, 64 * 7 + 1)
    band = [1600.0, 1900.0]

    # stage 1: the beamformer design alone (the per-band hot path of
    # Demo.__init__; no design cache at this level, so the device work runs)
    tau = 1.0 / (2 * np.pi * float(np.mean(band)))
    bf = SNNBeamformer(
        geometry=geometry, kernel_duration=10e-3, freq_range=band,
        tau_vec=[tau, tau], bipolar_spikes=True, fs=FS,
    )
    t = np.arange(0, 0.25, 1 / FS)
    sig = np.sin(2 * np.pi * float(np.mean(band)) * t)

    t0 = time.time()
    bf_mat = bf.design_from_template((t, sig), grid)
    np.asarray(bf_mat)
    first = time.time() - t0

    t0 = time.time()
    bf_mat = bf.design_from_template((t, sig), grid)
    np.asarray(bf_mat)
    second = time.time() - t0

    # stage 2: full Demo.__init__ with the design cache off (adds the
    # quantization/spec assembly + XyloSim twin setup on top of stage 1)
    t0 = time.time()
    Demo(
        geometry=geometry, freq_bands=[band], doa_list=grid,
        recording_duration=0.25, kernel_duration=10e-3,
        bipolar_spikes=True, fs=FS, use_cache=False,
    )
    demo_total = time.time() - t0

    print(
        json.dumps(
            {
                "experiment": "design_time_probe",
                "design_first_call_s": round(first, 2),
                "design_warm_call_s": round(second, 2),
                "design_compile_share_s": round(first - second, 2),
                "demo_init_total_s": round(demo_total, 2),
                "demo_minus_design_s": round(demo_total - second, 2),
            }
        )
    )


if __name__ == "__main__":
    main()
