"""Moving-target tracking — working twin of the reference's moving-target
evaluations (tests/test_snn_hilbert_localization.py:224-334 tracks a rotating
source with an Envelope smoother; paper_plots/target_snn_localization.py's
``test_moving_target`` :531-640 is dead code with an unbound-variable bug and
is disabled in its own main — this implementation is the working equivalent).

A source sweeps a DoA arc; per-frame estimates from the Hilbert and quantized
pipelines are compared against the trajectory (median tracking error, folded
metric).
"""
import json

import numpy as np
import jax
import jax.numpy as jnp

from common import FS, sinusoid_template

from haghighatshoarmuir2024 import CenterCircularArray
from haghighatshoarmuir2024.models.beamformer import Beamformer
from haghighatshoarmuir2024.models.xylo import Demo
from haghighatshoarmuir2024.ops.interp import received_signal
from haghighatshoarmuir2024.utils import to_numpy
from haghighatshoarmuir2024.utils.tracking import track_angles


def main(duration: float = 4.0, snr_db: float = 10.0, frame: float = 0.25):
    geometry = CenterCircularArray(radius=4.5e-2, num_mic=7)
    num_grid = 32 * 7
    doa_list = np.linspace(-np.pi, np.pi, num_grid)
    freq_design = 2_000.0
    freq_range = (0.5 * freq_design, freq_design)

    t = np.arange(0, duration, 1 / FS)
    sig = np.sin(2 * np.pi * 0.75 * freq_design * t)
    # source sweeps a 120-degree arc over the recording
    doa_traj = -np.pi / 3 + (2 * np.pi / 3) * (t / t[-1])

    sig_in = np.asarray(
        received_signal(
            geometry, jnp.asarray(t), jnp.asarray(sig), jnp.asarray(doa_traj),
            snr_db=snr_db, key=jax.random.PRNGKey(0), fs=FS,
        )
    )

    n_frames = int(duration / frame)
    Tf = int(frame * FS)
    frame_centers = (np.arange(n_frames) + 0.5) * frame
    doa_true = np.interp(frame_centers, t, doa_traj)

    results = {}

    # Hilbert tracker
    t_d, sig_d = sinusoid_template(0.75 * freq_design, frame)
    bf = Beamformer(geometry, 10e-3, freq_range, fs=FS)
    bf_mat, _ = bf.design_from_template((t_d, sig_d), doa_list)
    ests = []
    for k in range(n_frames):
        out = bf.apply_to_signal(bf_mat, sig_in[k * Tf : (k + 1) * Tf])
        p = jnp.mean(jnp.abs(out) ** 2, axis=0)
        ests.append(doa_list[int(jnp.argmax(p))])
    err = np.arcsin(np.abs(np.sin(np.asarray(ests) - doa_true)))
    results["hilbert"] = {
        "median_err_deg": float(np.rad2deg(np.median(err))),
        "mae_deg": float(np.rad2deg(err.mean())),
    }

    # wrapped-angle alpha-beta tracker on the per-frame estimates
    # (utils/tracking.py — beyond parity: the reference scores raw frames)
    tracked = np.asarray(track_angles(np.asarray(ests, np.float32)))
    err_t = np.arcsin(np.abs(np.sin(tracked - doa_true)))
    results["hilbert_tracked"] = {
        "median_err_deg": float(np.rad2deg(np.median(err_t))),
        "mae_deg": float(np.rad2deg(err_t.mean())),
    }

    # quantized Xylo tracker
    demo = Demo(
        geometry=geometry,
        freq_bands=[list(freq_range)],
        doa_list=doa_list,
        recording_duration=frame,
        kernel_duration=10e-3,
        bipolar_spikes=True,
        fs=FS,
    )
    ests_x = []
    for k in range(n_frames):
        doa, _ = demo.forward(sig_in[k * Tf : (k + 1) * Tf])
        ests_x.append(float(doa))
    err_x = np.arcsin(np.abs(np.sin(np.asarray(ests_x) - doa_true)))
    results["xylo"] = {
        "median_err_deg": float(np.rad2deg(np.median(err_x))),
        "mae_deg": float(np.rad2deg(err_x.mean())),
    }

    tracked_x = np.asarray(track_angles(np.asarray(ests_x, np.float32)))
    err_xt = np.arcsin(np.abs(np.sin(tracked_x - doa_true)))
    results["xylo_tracked"] = {
        "median_err_deg": float(np.rad2deg(np.median(err_xt))),
        "mae_deg": float(np.rad2deg(err_xt.mean())),
    }

    from common import fig_lines

    fig_lines(
        frame_centers,
        {
            "true": np.rad2deg(doa_true),
            "hilbert": np.rad2deg(np.asarray(ests)),
            "xylo": np.rad2deg(np.asarray(ests_x)),
            "hilbert tracked": np.rad2deg(tracked),
            "xylo tracked": np.rad2deg(tracked_x),
        },
        "moving_target_track.pdf",
        xlabel="time [s]",
        ylabel="DoA [deg]",
    )
    print(json.dumps({"experiment": "moving_target", "results": results}, indent=2))
    return results


if __name__ == "__main__":
    main()
