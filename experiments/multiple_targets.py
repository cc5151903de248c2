"""Two-target resolution — twin of paper_plots/multiple_targets_{beamformer,
music,snn}.py: two equal-power sources at ±60° (multiple_targets_snn.py:194-195),
shared ``signal_multiple_targets`` synthesis (:87-159), beam response of each
method, and a resolvability check (two distinct peaks at the target angles)."""
import json
import sys

import numpy as np
import jax
import jax.numpy as jnp

from common import FS, sinusoid_template

from haghighatshoarmuir2024 import CenterCircularArray
from haghighatshoarmuir2024.models.beamformer import Beamformer
from haghighatshoarmuir2024.models.music import MUSIC
from haghighatshoarmuir2024.models.snn_beamformer import SNNBeamformer
from haghighatshoarmuir2024.ops.interp import signal_from_template
from haghighatshoarmuir2024.ops.peaks import find_peaks_mask


def signal_multiple_targets(geometry, time_temp, sig_temps, doas, powers=None,
                            delay_sign=1):
    """Sum of per-target delayed/power-scaled copies
    (paper_plots/multiple_targets_snn.py:87-159).

    ``delay_sign``: the reference's two experiments disagree on the synthesis
    convention — multiple_targets_snn.py:147 delays with ``t + delay`` while
    multiple_targets_music.py:147 uses ``t - delay``.  MUSIC's steering
    matches the minus convention (see ops/interp.signal_from_template), so the
    MUSIC rows below pass ``delay_sign=-1``; the Hilbert/SNN designs are
    self-consistent under the plus convention."""
    powers = powers or [1.0] * len(doas)
    sig = 0.0
    for s, doa, p in zip(sig_temps, doas, powers):
        sig = sig + np.sqrt(p) * np.asarray(
            signal_from_template(
                geometry, time_temp, s, doa, fs=FS, delay_sign=delay_sign
            )
        )
    return sig


def detect_peaks(profile, doa_list, num=2):
    """Top-`num` well-separated peaks of an angular profile."""
    mask = np.asarray(find_peaks_mask(jnp.asarray(profile), distance=len(doa_list) // 16))
    idx = np.nonzero(mask)[0]
    idx = idx[np.argsort(profile[idx])[::-1]][:num]
    return np.sort(doa_list[idx])


def main(snr_db: float = 20.0):
    geometry = CenterCircularArray(radius=4.5e-2, num_mic=7)
    num_grid = 32 * 7
    doa_list = np.linspace(-np.pi, np.pi, num_grid)
    doa_targets = np.array([-np.pi / 3, np.pi / 3])  # ±60 deg
    freq_design = 2_000.0
    freq_range = (0.5 * freq_design, freq_design)
    freq_mid = float(np.mean(freq_range))
    t, sig1 = sinusoid_template(0.75 * freq_design, 0.25)
    _, sig2 = sinusoid_template(0.80 * freq_design, 0.25)

    rng = np.random.default_rng(0)
    sig_in = signal_multiple_targets(geometry, t, [sig1, sig2], doa_targets)
    sig_in = sig_in + np.sqrt(np.mean(sig_in**2) / 10 ** (snr_db / 10)) * rng.standard_normal(sig_in.shape)

    out = {}

    # Hilbert (interference removal improves multi-target separation)
    for ir in (False, True):
        bf = Beamformer(geometry, 10e-3, freq_range, fs=FS)
        bf_mat, _ = bf.design_from_template((t, sig1), doa_list, interference_removal=ir)
        # keep the complex beamformed signal on device; only real power comes back
        prof = np.asarray(jnp.mean(jnp.abs(bf.apply_to_signal(bf_mat, sig_in)) ** 2, axis=0))
        peaks = detect_peaks(prof, doa_list)
        out[f"hilbert{'_ir' if ir else ''}"] = {
            "detected_deg": np.rad2deg(peaks).tolist(),
        }

    # MUSIC — synthesized with the reference's MUSIC convention (t - delay,
    # paper_plots/multiple_targets_music.py:147); the plus-convention signal
    # above would mirror both detections by 180° (see
    # ops/interp.signal_from_template)
    sig_in_m = signal_multiple_targets(
        geometry, t, [sig1, sig2], doa_targets, delay_sign=-1
    )
    sig_in_m = sig_in_m + np.sqrt(
        np.mean(sig_in_m**2) / 10 ** (snr_db / 10)
    ) * rng.standard_normal(sig_in_m.shape)
    music = MUSIC(geometry, freq_range, doa_list, frame_duration=0.25, fs=FS)
    aps = np.asarray(music.beamforming(jnp.asarray(sig_in_m), 2, 2048))
    out["music"] = {"detected_deg": np.rad2deg(detect_peaks(aps, doa_list)).tolist()}
    # beyond parity: true noise-subspace MUSIC resolves the pair much more
    # sharply than the reference's Bartlett scan (models/music.py num_sources)
    aps2 = np.asarray(music.beamforming(jnp.asarray(sig_in_m), 2, 2048, num_sources=2))
    out["music_ns2"] = {
        "detected_deg": np.rad2deg(detect_peaks(aps2, doa_list)).tolist()
    }

    # float SNN
    tau = 1.0 / (2 * np.pi * freq_mid)
    snn = SNNBeamformer(geometry, 10e-3, freq_range, [tau, tau], bipolar_spikes=True, fs=FS)
    bf_mat_snn = snn.design_from_template((t, sig1), doa_list)
    prof_snn = np.mean(np.asarray(snn.apply_to_signal(bf_mat_snn, (t, sig_in))) ** 2, axis=0)
    out["snn"] = {"detected_deg": np.rad2deg(detect_peaks(prof_snn, doa_list)).tolist()}

    out["targets_deg"] = np.rad2deg(doa_targets).tolist()
    from common import fig_polar_patterns

    fig_polar_patterns(
        {"hilbert": prof, "music": aps, "snn": prof_snn},
        doa_list,
        "multiple_targets.pdf",
    )
    print(json.dumps({"experiment": "multiple_targets", "results": out}, indent=2))
    return out


if __name__ == "__main__":
    main()
