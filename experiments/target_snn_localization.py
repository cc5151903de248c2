"""Monte-Carlo DoA accuracy of the float32 SNN beamformer — twin of
paper_plots/target_snn_localization.py (chirp design template :126-134,
bandwidth-corrected SNR :382-393, 11 SNRs × num_sims)."""
import json

import numpy as np
import jax
import jax.numpy as jnp

from common import FS, chirp_template, snr_sweep_config, speech_template, summarize

from haghighatshoarmuir2024 import CenterCircularArray
from haghighatshoarmuir2024.models.snn_beamformer import SNNBeamformer
from haghighatshoarmuir2024.parallel import (
    make_trial_fn,
    monte_carlo_sweep,
    snr_with_bandwidth_correction,
)


def run(
    target: str = "tone",
    num_sims: int = 100,
    num_grid: int = 32 * 7,
    bipolar: bool = True,
    seed: int = 0,
):
    geometry = CenterCircularArray(radius=4.5e-2, num_mic=7)
    freq_design = 2_000.0
    freq_range = (0.5 * freq_design, freq_design)
    freq_mid = float(np.mean(freq_range))
    tau = 1.0 / (2 * np.pi * freq_mid)
    doa_list = np.linspace(-np.pi, np.pi, num_grid)

    snn = SNNBeamformer(
        geometry, 10e-3, freq_range, [tau, tau], bipolar_spikes=bipolar, fs=FS
    )
    t_design, sig_design = chirp_template(freq_range, 0.25)
    bf_mat = snn.design_from_template((t_design, sig_design), doa_list)

    if target == "tone":
        t, sig = chirp_template(freq_range, 0.25)
    else:
        t, sig = speech_template(duration=1.0)

    grid_j = jnp.asarray(doa_list)
    time_j = t

    def estimate(sig_in):
        out = snn.apply_to_signal(bf_mat, (time_j, sig_in))
        power = jnp.mean(out**2, axis=0)
        return grid_j[jnp.argmax(power)]

    trial = make_trial_fn(geometry, t, sig, estimate, FS)
    # bandwidth-corrected SNR sweep (reference :382-393)
    snr_vec = [
        snr_with_bandwidth_correction(s, FS, freq_range) for s in snr_sweep_config()
    ]
    res = monte_carlo_sweep(trial, snr_vec, num_sims, jax.random.PRNGKey(seed))
    res["snr_db"] = snr_sweep_config()  # report nominal SNRs
    return res


def main():
    from common import fig_mae_vs_snr

    out = {}
    for target, sims in (("tone", 100), ("speech", 20)):
        res = run(target=target, num_sims=sims)
        out[target] = summarize(res)
    fig_mae_vs_snr(
        {t: (out[t]["snr_db"], out[t]["mae_deg"]) for t in out},
        "target_snn_localization_mae.pdf",
    )
    print(json.dumps({"experiment": "target_snn_localization", "results": out}, indent=2))
    return out


if __name__ == "__main__":
    main()
