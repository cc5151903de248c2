"""Monte-Carlo DoA accuracy of the Hilbert beamformer — twin of
paper_plots/target_localization.py (MAE vs SNR ∈ [-10, 20] dB, random DoA per
trial, error = arcsin|sin(est − true)|, :210-300).

The reference runs 11 × 100 serial pipeline invocations; here the trial axis
is one vmapped (optionally mesh-sharded) program per SNR point.
"""
import json

import numpy as np
import jax
import jax.numpy as jnp

from common import FS, sinusoid_template, snr_sweep_config, speech_template, summarize

from haghighatshoarmuir2024 import CenterCircularArray
from haghighatshoarmuir2024.models.beamformer import Beamformer
from haghighatshoarmuir2024.parallel import make_trial_fn, monte_carlo_sweep


def run(target: str = "tone", num_sims: int = 100, num_grid: int = 32 * 7, seed: int = 0):
    geometry = CenterCircularArray(radius=4.5e-2, num_mic=7)
    freq_design = 2_000.0
    freq_range = (0.5 * freq_design, freq_design)
    kernel_duration = 10e-3
    doa_list = np.linspace(-np.pi, np.pi, num_grid)

    bf = Beamformer(geometry, kernel_duration, freq_range, fs=FS)
    t_design, sig_design = sinusoid_template(0.75 * freq_design, 0.25)
    bf_mat, _ = bf.design_from_template((t_design, sig_design), doa_list)
    from haghighatshoarmuir2024.utils import to_numpy

    bf_mat = to_numpy(bf_mat)  # host constant

    if target == "tone":
        t, sig = sinusoid_template(0.75 * freq_design, 0.25)
    else:
        t, sig = speech_template(duration=1.0)

    grid_j = jnp.asarray(doa_list)
    kernel = jnp.asarray(bf.kernel, dtype=jnp.float32)

    def estimate(sig_in):
        out = bf.apply_to_signal(bf_mat, sig_in)
        power = jnp.mean(jnp.abs(out) ** 2, axis=0)
        return grid_j[jnp.argmax(power)]

    trial = make_trial_fn(geometry, t, sig, estimate, FS)
    res = monte_carlo_sweep(
        trial, snr_sweep_config(), num_sims, jax.random.PRNGKey(seed)
    )
    return res


def main():
    from common import fig_mae_vs_snr

    out = {}
    for target in ("tone", "speech"):
        res = run(target=target, num_sims=100 if target == "tone" else 20)
        out[target] = summarize(res)
    fig_mae_vs_snr(
        {t: (out[t]["snr_db"], out[t]["mae_deg"]) for t in out},
        "target_localization_mae.pdf",
    )
    print(json.dumps({"experiment": "target_localization", "results": out}, indent=2))
    return out


if __name__ == "__main__":
    main()
