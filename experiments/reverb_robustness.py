"""Localization robustness under room reverberation — beyond-parity.

The reference's simulation harness is strictly anechoic: every
``apply_to_template`` synthesizes ONE plane wave per source plus white noise
(micloc/beamformer.py:233-253); robustness to reflections is never measured.
This experiment synthesizes reverberant array input with the image-source
model (ops/interp.room_image_paths + signal_from_template_multipath: direct
path + wall images up to order 2 in a 5x4 m room) and sweeps the wall
reflection coefficient, reporting MAE of

  * the Hilbert beamformer (non-SNN reference algorithm), and
  * the full quantized Xylo pipeline with the matched estimator,

against the DIRECT-path DoA at fixed 10 dB (direct-path) SNR.  Each trial
places the source at a random in-room position >= 1 m from the array; the
path table is host-computed (fixed P = 13 paths at order 2) and the whole
trial batch runs as one jitted device program per model.

Usage: python experiments/reverb_robustness.py [--quick]
"""
import json
import sys

import numpy as np
import jax
import jax.numpy as jnp

from common import FS

from haghighatshoarmuir2024 import CenterCircularArray
from haghighatshoarmuir2024.models.beamformer import Beamformer
from haghighatshoarmuir2024.models.xylo import Demo
from haghighatshoarmuir2024.ops.interp import (
    room_image_paths,
    signal_from_template_multipath,
)
from haghighatshoarmuir2024.parallel import folded_angle_error

ROOM = (5.0, 4.0)
ARRAY_XY = (2.2, 1.7)
REFLECTIONS = [0.0, 0.3, 0.5, 0.7, 0.9]
SNR_DB = 10.0


def _sample_positions(rng, n, min_dist=1.0):
    """Random in-room source positions >= min_dist from the array center."""
    out = []
    while len(out) < n:
        xy = rng.uniform([0.3, 0.3], [ROOM[0] - 0.3, ROOM[1] - 0.3])
        if np.hypot(xy[0] - ARRAY_XY[0], xy[1] - ARRAY_XY[1]) >= min_dist:
            out.append(xy)
    return np.asarray(out)


def _path_tables(positions, reflection):
    tabs = [
        room_image_paths(p, ARRAY_XY, ROOM, reflection=reflection, order=2)
        for p in positions
    ]
    doas = np.stack([t[0] for t in tabs])
    extra = np.stack([t[1] for t in tabs])
    gains = np.stack([t[2] for t in tabs])
    return doas, extra, gains


def run(num_trials: int = 20, num_grid: int = 16 * 7, seed: int = 0,
        duration: float = 0.25):
    geometry = CenterCircularArray(radius=4.5e-2, num_mic=7)
    grid = np.linspace(-np.pi, np.pi, num_grid)
    freq_range = (1600.0, 1900.0)
    t = np.arange(0, duration, 1 / FS)
    sig = np.sin(2 * np.pi * 1750.0 * t)

    bf = Beamformer(geometry, kernel_duration=10e-3, freq_range=freq_range, fs=FS)
    bf_mat, _ = bf.design_from_template((t, sig), grid)
    # NUMPY closure: the jitted programs embed host constants only
    from haghighatshoarmuir2024.utils import to_numpy

    bf_mat = to_numpy(bf_mat)

    demo = Demo(
        geometry=geometry,
        freq_bands=[list(freq_range)],
        doa_list=grid,
        recording_duration=duration,
        kernel_duration=10e-3,
        bipolar_spikes=True,
        fs=FS,
    )
    demo.calibrate_profiles()

    grid_j = jnp.asarray(grid)
    t_j = jnp.asarray(t, jnp.float32)
    s_j = jnp.asarray(sig, jnp.float32)

    def synth(key, doas_p, extra_p, gains_p):
        clean = signal_from_template_multipath(
            geometry, t_j, s_j, doas_p, extra_p, gains_p, fs=FS
        )
        # SNR defined against the DIRECT-path power (gain 1): reflections are
        # part of the "signal" reaching the array, noise is the electronics
        direct = signal_from_template_multipath(
            geometry, t_j, s_j, doas_p[:1], extra_p[:1], gains_p[:1], fs=FS
        )
        sigma = jnp.sqrt(jnp.mean(direct**2) / 10 ** (SNR_DB / 10))
        return clean + sigma * jax.random.normal(key, clean.shape, clean.dtype)

    @jax.jit
    def trial_hilbert(keys, doas_b, extra_b, gains_b):
        def one(key, dp, ep, gp):
            sig_in = synth(key, dp, ep, gp)
            out = bf.apply_to_signal(bf_mat, sig_in)
            power = jnp.mean(jnp.abs(out) ** 2, axis=0)
            return grid_j[jnp.argmax(power)]
        return jax.vmap(one)(keys, doas_b, extra_b, gains_b)

    rates_fn = demo._rates_batch_jit
    profiles = np.asarray(demo._profiles, np.float32)  # numpy closure
    G = num_grid

    @jax.jit
    def trial_xylo(keys, doas_b, extra_b, gains_b):
        frames = jax.vmap(synth)(keys, doas_b, extra_b, gains_b)
        rate = rates_fn(frames)
        folded = rate.reshape(rate.shape[0], -1, G).mean(1)
        rc = folded - folded.mean(axis=-1, keepdims=True)
        scores = jnp.matmul(rc, profiles.T, precision=jax.lax.Precision.HIGHEST)
        return grid_j[jnp.argmax(scores, axis=-1)]

    rng = np.random.default_rng(seed)
    positions = _sample_positions(rng, num_trials)
    keys = jax.random.split(jax.random.PRNGKey(seed), num_trials)

    res = {"reflection": REFLECTIONS, "snr_db": SNR_DB,
           "num_trials": num_trials, "room": ROOM}
    for name in ("hilbert", "xylo_matched"):
        res[name + "_mae_deg"] = []
    for refl in REFLECTIONS:
        doas_b, extra_b, gains_b = _path_tables(positions, refl)
        doa_true = jnp.asarray(doas_b[:, 0])
        est_h = trial_hilbert(keys, jnp.asarray(doas_b), jnp.asarray(extra_b),
                              jnp.asarray(gains_b, jnp.float32))
        est_x = trial_xylo(keys, jnp.asarray(doas_b), jnp.asarray(extra_b),
                           jnp.asarray(gains_b, jnp.float32))
        for name, est in (("hilbert", est_h), ("xylo_matched", est_x)):
            err = np.asarray(folded_angle_error(est, doa_true))
            res[name + "_mae_deg"].append(round(float(np.degrees(err.mean())), 2))
    return res


def main():
    from common import fig_lines

    num_trials = 8 if "--quick" in sys.argv else 20
    if "--trials" in sys.argv:
        num_trials = int(sys.argv[sys.argv.index("--trials") + 1])
    res = run(num_trials=num_trials)
    fig_lines(
        res["reflection"],
        {
            "Hilbert beamformer": res["hilbert_mae_deg"],
            "quantized Xylo (matched)": res["xylo_matched_mae_deg"],
        },
        "reverb_robustness_mae.pdf",
        xlabel="wall reflection coefficient",
        ylabel="MAE [deg]",
    )
    print(json.dumps({"experiment": "reverb_robustness", "results": res}, indent=2))
    return res


if __name__ == "__main__":
    main()
