"""Push-to-hidden deployment twin — the experiment harness of
micloc/xylo_snn_localization_push_to_hidden.py.

The reference script's main() runs only the power measurement (:678-708):
Poisson-like random input spikes at ~1 kHz for 2 ms pushed through
``_evolve_to_hidden`` on the board at a 6.25 MHz core clock, reporting scaled
µW per power rail (:551-637).  Without the board, this twin reports the
op-census energy proxy over the same random-spike workload, plus a
localization sanity sweep that the reference's (unreachable) visualization
path would have exercised.
"""
import json
import sys

import numpy as np
import jax

from common import FS, sinusoid_template, snr_sweep_config, summarize

from haghighatshoarmuir2024 import CenterCircularArray
from haghighatshoarmuir2024.models.xylo import DemoPushToHidden, estimate_power
from haghighatshoarmuir2024.ops.interp import signal_from_template


def build_demo(num_grid: int = 16 * 7):
    geometry = CenterCircularArray(radius=4.5e-2, num_mic=7)
    return DemoPushToHidden(
        geometry=geometry,
        freq_bands=[[1600, 1900]],
        doa_list=np.linspace(-np.pi, np.pi, num_grid),
        recording_duration=0.25,
        kernel_duration=10e-3,
        bipolar_spikes=True,
        fs=FS,
    )


def power_measurement(demo) -> dict:
    """Random-spike power workload (reference :597-611: spk_rate=1 kHz,
    duration 2 ms, spikes pushed straight to the hidden layer)."""
    spk_rate = 1_000
    duration = 2e-3
    T = int(FS * duration)
    rng = np.random.default_rng(0)
    spikes_in = (rng.random((T, demo.xylo_config.n_in)) < spk_rate / FS).astype(np.int64)

    demo.xylo.reset_state()
    full, _, rec = demo.xylo.evolve_to_hidden(spikes_in, record=False)
    hidden = np.asarray(rec["Spikes"])
    est = estimate_power(demo.xylo_config, spikes_in, hidden[:, demo.xylo.n_stage1 :],
                         audio_duration=duration)
    return {k: float(v) for k, v in est.items()}


def localization_check(demo, num_trials: int = 8, snr_db: float = 10.0, seed: int = 0) -> dict:
    """DoA sanity sweep through the on-chip path (encode → stage-1 LIF →
    projection → stage-2 LIF → rate → peak)."""
    t, sig = sinusoid_template(1750.0, demo.recording_duration)
    rng = np.random.default_rng(seed)
    errors = []
    for _ in range(num_trials):
        doa_true = rng.uniform(-np.pi, np.pi)
        clean = np.asarray(signal_from_template(demo.geometry, t, sig, doa_true, fs=FS))
        sig_pow = np.mean(clean**2)
        noise = rng.standard_normal(clean.shape) * np.sqrt(sig_pow / 10 ** (snr_db / 10))
        spikes = np.asarray(demo.spike_encoding(clean + noise))
        hidden = demo.xylo_process(spikes)
        rate = demo.extract_rate(hidden)
        est = float(demo.estimate_doa_from_rate(rate, "peak"))
        errors.append(np.degrees(np.arcsin(abs(np.sin(est - doa_true)))))
    return {"snr_db": snr_db, "mae_deg": float(np.mean(errors)), "errors_deg": errors}


def main():
    quick = "--quick" in sys.argv
    demo = build_demo(num_grid=16 * 7)
    out = {
        "experiment": "push_to_hidden",
        "power": power_measurement(demo),
        "localization": localization_check(demo, num_trials=4 if quick else 8),
        "w_rec_nonzeros": int(np.count_nonzero(np.asarray(demo.xylo_config.w_rec))),
        "w_in_max_fan_out": int(
            np.count_nonzero(np.asarray(demo.xylo_config.w_in), axis=1).max()
        ),
    }
    print(json.dumps(out, indent=2))
    return out


if __name__ == "__main__":
    main()
