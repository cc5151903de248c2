"""Accuracy cost of the serving wire codecs (ops/mulaw.py, ops/resample.py).

The serving daemon trades wire bytes for throughput (i16 -> u8 -> u4, 48 ->
12 kHz); this sweep quantifies what that costs in DoA accuracy: the same
Monte-Carlo trials (random DoA, tone template, folded-error MAE — the
conventions of experiments/target_xylo_localization.py) are run through each
codec round trip before entering the full quantized pipeline with the
matched estimator.  Runs on CPU or GPU.

Usage: python experiments/wire_accuracy.py
"""
import json

import numpy as np

from common import FS, sinusoid_template

from haghighatshoarmuir2024 import CenterCircularArray
from haghighatshoarmuir2024.models.xylo import Demo
from haghighatshoarmuir2024.ops.interp import signal_from_template
from haghighatshoarmuir2024.ops.mulaw import (
    mulaw4_decode,
    mulaw_decode,
    unpack4,
)
from haghighatshoarmuir2024.ops.resample import (
    design_upsample_fir,
    upsample_poly,
)
from haghighatshoarmuir2024.runtime.server import WireEncoder


def roundtrip(x, wire, up):
    """Host-side encode->decode twin of the daemon path: (T, M) -> (T, M)."""
    enc = WireEncoder(wire, wire_upsample=up)
    w = enc.encode(x)
    if wire == "i16":
        y = w.astype(np.float32) / 32768.0
    elif wire == "u8":
        y = mulaw_decode(w)
    elif wire == "u4":
        y = mulaw4_decode(unpack4(w))
    else:
        y = w
    if up > 1:
        y = upsample_poly(y, design_upsample_fir(up), up)
    return np.asarray(y, np.float32)


def run(num_sims: int = 20, num_grid: int = 113, snrs=(-10.0, 2.0, 20.0),
        seed: int = 0):
    geometry = CenterCircularArray(radius=4.5e-2, num_mic=7)
    demo = Demo(
        geometry=geometry,
        freq_bands=[[1600, 1900]],
        doa_list=np.linspace(-np.pi, np.pi, num_grid),
        recording_duration=0.25,
        kernel_duration=10e-3,
        bipolar_spikes=True,
        fs=FS,
    )
    demo.calibrate_profiles()
    t, sig = sinusoid_template(1750.0, 0.25)

    rng = np.random.default_rng(seed)
    configs = [("f32", 1), ("i16", 1), ("u8", 1), ("u4", 1),
               ("u8", 4), ("u4", 4)]
    out = {}
    for snr_db in snrs:
        doas = rng.uniform(-np.pi, np.pi, num_sims)
        frames = []
        for d in doas:
            clean = np.asarray(signal_from_template(geometry, t, sig, float(d), fs=FS))
            sigma = np.sqrt((clean**2).mean() / 10 ** (snr_db / 10))
            x = clean + sigma * rng.standard_normal(clean.shape)
            frames.append((x / np.abs(x).max() * 0.98).astype(np.float32))
        frames = np.stack(frames)
        for wire, up in configs:
            fr = np.stack([roundtrip(f, wire, up) for f in frames])
            est, _ = demo.forward_batch(fr, method="matched")
            err = np.arcsin(np.abs(np.sin(np.asarray(est) - doas)))
            key = f"{wire}" + ("@12k" if up == 4 else "")
            out.setdefault(key, {})[snr_db] = round(
                float(np.rad2deg(err).mean()), 3
            )
    return out


def main():
    out = run()
    print(json.dumps({"experiment": "wire_accuracy",
                      "mae_deg_by_wire_and_snr": out}, indent=2))
    return out


if __name__ == "__main__":
    main()
