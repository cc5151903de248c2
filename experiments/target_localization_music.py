"""Monte-Carlo DoA accuracy of the MUSIC beamformer — twin of
paper_plots/target_localization_MUSIC.py (num_active_freq=1, 2048-bin FFT,
:65-67)."""
import json

import numpy as np
import jax
import jax.numpy as jnp

from common import FS, sinusoid_template, snr_sweep_config, speech_template, summarize

from haghighatshoarmuir2024 import CenterCircularArray
from haghighatshoarmuir2024.models.music import MUSIC
from haghighatshoarmuir2024.parallel import make_trial_fn, monte_carlo_sweep

NUM_ACTIVE_FREQ = 1
NUM_FFT_BIN = 2048


def run(target: str = "tone", num_sims: int = 100, num_grid: int = 32 * 7, seed: int = 0):
    geometry = CenterCircularArray(radius=4.5e-2, num_mic=7)
    freq_design = 2_000.0
    freq_range = (0.5 * freq_design, freq_design)
    doa_list = np.linspace(-np.pi, np.pi, num_grid)
    music = MUSIC(geometry, freq_range, doa_list, frame_duration=0.25, fs=FS)

    if target == "tone":
        t, sig = sinusoid_template(0.75 * freq_design, 0.25)
    else:
        t, sig = speech_template(duration=1.0)

    grid_j = jnp.asarray(doa_list)

    def estimate(sig_in):
        aps = music.beamforming(sig_in, NUM_ACTIVE_FREQ, NUM_FFT_BIN)
        return grid_j[jnp.argmax(aps)]

    # minus-convention synthesis: the reference's MUSIC MC synthesizes via
    # MUSIC's own apply_to_template (t - delay,
    # paper_plots/target_localization_MUSIC.py:171 ->
    # micloc/music_beamformer.py:307-312); the folded error metric would hide
    # the 180-deg mirror a plus-convention signal produces, but the raw
    # estimates would be antipodal
    trial = make_trial_fn(geometry, t, sig, estimate, FS, delay_sign=-1)
    return monte_carlo_sweep(trial, snr_sweep_config(), num_sims, jax.random.PRNGKey(seed))


def main():
    from common import fig_mae_vs_snr

    out = {}
    for target, sims in (("tone", 100), ("speech", 20)):
        out[target] = summarize(run(target=target, num_sims=sims))
    fig_mae_vs_snr(
        {t: (out[t]["snr_db"], out[t]["mae_deg"]) for t in out},
        "target_localization_music_mae.pdf",
    )
    print(json.dumps({"experiment": "target_localization_music", "results": out}, indent=2))
    return out


if __name__ == "__main__":
    main()
