"""Monte-Carlo DoA accuracy of the classical SRP-PHAT baseline.

BEYOND-PARITY experiment: the reference has no TDoA/phase-transform baseline
(its families are Hilbert / SNN / MUSIC); this sweep runs the textbook
GCC-PHAT steered-power method (models/srp_phat.py) under the SAME MC
conventions as experiments/target_localization.py — random DoA per trial,
MAE = arcsin|sin(est − true)|, SNR ∈ [-10, 20] dB — so the SNN pipelines can
be compared against the classical method inside one framework.

Usage: python experiments/srp_phat_baseline.py
"""
import json

import numpy as np
import jax
import jax.numpy as jnp

from common import (
    FS,
    chirp_template,
    fig_mae_vs_snr,
    sinusoid_template,
    snr_sweep_config,
    speech_template,
    summarize,
)

from haghighatshoarmuir2024 import CenterCircularArray
from haghighatshoarmuir2024.models import SRPPHAT
from haghighatshoarmuir2024.parallel import make_trial_fn, monte_carlo_sweep


def run(target: str = "tone", num_sims: int = 100, num_grid: int = 32 * 7,
        seed: int = 0):
    geometry = CenterCircularArray(radius=4.5e-2, num_mic=7)
    doa_list = np.linspace(-np.pi, np.pi, num_grid)

    if target == "tone":
        t, sig = sinusoid_template(1750.0, 0.25)
        band = [1400.0, 2100.0]
    elif target == "chirp":
        t, sig = chirp_template((1600.0, 2600.0), 0.25)
        band = [1400.0, 2800.0]
    else:
        t, sig = speech_template(duration=1.0)
        band = [300.0, 4000.0]  # speech band: PHAT uses all voiced content

    srp = SRPPHAT(geometry, freq_range=band, doa_list=doa_list, fs=FS,
                  frame_duration=t[-1] + 1.0 / FS)
    grid_j = jnp.asarray(doa_list)
    # numpy float closures: no complex array crosses the host/device
    # boundary
    steer_re, steer_im = srp._steer_re, srp._steer_im

    def estimate(sig_in):
        return grid_j[jnp.argmax(srp._power_impl(sig_in, steer_re, steer_im))]

    # minus-convention synthesis: SRP-PHAT's steering is physical
    # (exp(+j2pi f (d_i - d_j)) against X_i X_j^*), so like MUSIC it expects
    # t - delay propagation; plus-convention audio mirrors the raw estimates
    # by 180 deg (hidden by the folded metric, measured)
    trial = make_trial_fn(geometry, t, sig, estimate, FS, delay_sign=-1)
    return monte_carlo_sweep(
        trial, snr_sweep_config(), num_sims, jax.random.PRNGKey(seed)
    )


def main():
    out = {}
    for target in ("tone", "chirp", "speech"):
        res = run(target=target, num_sims=100 if target != "speech" else 20)
        out[target] = summarize(res)
    fig_mae_vs_snr(
        {t: (out[t]["snr_db"], out[t]["mae_deg"]) for t in out},
        "srp_phat_baseline_mae.pdf",
    )
    print(json.dumps({"experiment": "srp_phat_baseline", "results": out}, indent=2))
    return out


if __name__ == "__main__":
    main()
