"""Two moving sources that CROSS — multi-target tracking through MUSIC
(beyond reference parity).

The reference's multi-target study is static: paper_plots/multiple_targets_
{beamformer,music,snn}.py:87-246 synthesize two FIXED sources and check that
the angular response shows two peaks.  Its moving-target evaluation
(micloc/tests/test_snn_hilbert_localization.py:224-334) is single-source.
Neither answers the production question this harness measures: when two
sources move and their bearings cross, can the system keep per-source
identity?

Front end: the noise-subspace MUSIC pseudospectrum (``num_sources=2`` —
models/music.py's beyond-parity path; the Bartlett/Hilbert responses merge
two sources below ~120° separation, measured here, so super-resolution is
what makes per-frame two-peak measurements exist at all).  Synthesis uses the
reference's MUSIC convention (``t - delay``,
paper_plots/multiple_targets_music.py:147) — see
ops/interp.signal_from_template for the two-convention story.

Per frame, ``ops.peaks.top_k_peaks`` turns the pseudospectrum into K=2
measurements; the gated GNN tracker (`utils.tracking.track_multi_angles`)
associates them into persistent tracks.  The memoryless baseline ("sorted
peaks": target 1 := the more-negative bearing, the best any frame-by-frame
scorer can do) necessarily swaps identity at the crossing; the tracker's
velocity state carries each track through it.
"""
import json

import numpy as np
import jax.numpy as jnp

from common import FS, fig_lines

from haghighatshoarmuir2024 import CenterCircularArray
from haghighatshoarmuir2024.models.music import MUSIC
from haghighatshoarmuir2024.ops.interp import signal_from_template
from haghighatshoarmuir2024.ops.peaks import top_k_peaks
from haghighatshoarmuir2024.utils.tracking import track_multi_angles


def _fold_deg(est, true):
    return np.rad2deg(np.arcsin(np.abs(np.sin(np.asarray(est) - np.asarray(true)))))


def main(duration: float = 6.0, snr_db: float = 10.0, frame: float = 0.25):
    geometry = CenterCircularArray(radius=4.5e-2, num_mic=7)
    num_grid = 32 * 7
    doa_list = np.linspace(-np.pi, np.pi, num_grid)
    freq_design = 2_000.0
    freq_range = (0.5 * freq_design, freq_design)

    t = np.arange(0, duration, 1 / FS)
    # two tones (multiple_targets_snn.py's 0.75/0.80 f_design split) on
    # crossing linear bearing sweeps: -80 deg -> +40 deg and +80 -> -40
    traj1 = np.deg2rad(-80 + 120 * t / t[-1]).astype(np.float32)
    traj2 = np.deg2rad(80 - 120 * t / t[-1]).astype(np.float32)
    sig1 = np.sin(2 * np.pi * 0.75 * freq_design * t)
    sig2 = np.sin(2 * np.pi * 0.80 * freq_design * t)

    rng = np.random.default_rng(0)
    sig_in = np.asarray(
        signal_from_template(geometry, t, sig1, traj1, fs=FS, delay_sign=-1)
    ) + np.asarray(signal_from_template(geometry, t, sig2, traj2, fs=FS, delay_sign=-1))
    sig_in = sig_in + np.sqrt(
        np.mean(sig_in**2) / 10 ** (snr_db / 10)
    ) * rng.standard_normal(sig_in.shape)

    n_frames = int(duration / frame)
    Tf = int(frame * FS)
    frame_centers = (np.arange(n_frames) + 0.5) * frame
    true1 = np.interp(frame_centers, t, traj1)
    true2 = np.interp(frame_centers, t, traj2)

    music = MUSIC(geometry, freq_range, doa_list, frame_duration=frame, fs=FS)

    z = np.zeros((n_frames, 2), np.float32)
    valid = np.zeros((n_frames, 2), bool)
    for k in range(n_frames):
        p = music.beamforming(
            jnp.asarray(sig_in[k * Tf : (k + 1) * Tf]), 2, 2048, num_sources=2
        )
        idx, _, ok = top_k_peaks(p, 2, distance=num_grid // 32, rel_height=0.2)
        z[k] = doa_list[np.asarray(idx)]
        valid[k] = np.asarray(ok)

    # memoryless baseline: per-frame identity by sorted bearing (swaps at the
    # crossing by construction)
    z_sorted = np.sort(np.where(valid, z, np.nan), axis=1)
    base1 = _fold_deg(z_sorted[:, 0], true1)
    base2 = _fold_deg(z_sorted[:, 1], true2)

    thetas, confirmed = track_multi_angles(z, valid, num_tracks=4, max_misses=4)
    thetas, confirmed = np.asarray(thetas), np.asarray(confirmed)
    # match each truth to its confirmed slot early (before the crossing)
    probe = 3
    slots = np.nonzero(confirmed[probe])[0]
    s1 = int(slots[np.argmin(_fold_deg(thetas[probe, slots], true1[probe]))])
    s2 = int(slots[np.argmin(_fold_deg(thetas[probe, slots], true2[probe]))])
    trk1 = _fold_deg(thetas[probe:, s1], true1[probe:])
    trk2 = _fold_deg(thetas[probe:, s2], true2[probe:])

    results = {
        "snr_db": snr_db,
        "n_frames": n_frames,
        "confirmed_final": int(confirmed[-1].sum()),
        "identity_held": bool(max(trk1.max(), trk2.max()) < 15.0),
        "sorted_peaks_baseline_mae_deg": [
            float(np.nanmean(base1)),
            float(np.nanmean(base2)),
        ],
        "tracked_mae_deg": [float(trk1.mean()), float(trk2.mean())],
        "tracked_max_err_deg": [float(trk1.max()), float(trk2.max())],
    }

    fig_lines(
        frame_centers,
        {
            "true 1": np.rad2deg(true1),
            "true 2": np.rad2deg(true2),
            "track A": np.rad2deg(np.where(confirmed[:, s1], thetas[:, s1], np.nan)),
            "track B": np.rad2deg(np.where(confirmed[:, s2], thetas[:, s2], np.nan)),
            "peaks (sorted)": np.rad2deg(z_sorted[:, 0]),
        },
        "multi_target_tracking.pdf",
        xlabel="time [s]",
        ylabel="DoA [deg]",
    )
    print(json.dumps({"experiment": "multi_target_tracking", "results": results}, indent=2))
    return results


if __name__ == "__main__":
    import sys

    snr = float(sys.argv[1]) if len(sys.argv) > 1 else 10.0
    main(snr_db=snr)
