"""Robustness to array imperfections (gain + position mismatch) — beyond parity.

Production arrays never match their datasheet: microphones have gain spread
and placement error.  The reference's harness assumes a perfect array (its
synthesis and its design share the same geometry object by construction, and
it never perturbs either).  Here the SYNTHESIS uses a perturbed array —
per-mic gain error (log-normal, sigma_gain dB) and mic position error
(Gaussian, sigma_pos meters, redrawn per trial) — while the DESIGN keeps the
nominal geometry, and we sweep the error magnitude:

  * Hilbert beamformer (float reference algorithm);
  * quantized Xylo pipeline, matched estimator.

Fixed 10 dB SNR, random DoA per trial, folded angle MAE.

Usage: python experiments/mismatch_robustness.py [--quick]
"""
import json
import sys

import numpy as np
import jax
import jax.numpy as jnp

from common import FS

from haghighatshoarmuir2024 import ArrayGeometry, CenterCircularArray
from haghighatshoarmuir2024.models.beamformer import Beamformer
from haghighatshoarmuir2024.models.xylo import Demo
from haghighatshoarmuir2024.ops.interp import signal_from_template
from haghighatshoarmuir2024.parallel import folded_angle_error

SNR_DB = 10.0
GAIN_DB = [0.0, 1.0, 2.0, 4.0]       # per-mic gain spread (std, dB)
POS_MM = [0.0, 1.0, 2.0, 5.0]        # mic position error (std, mm)


def _perturbed_geometry(geometry, rng, sigma_pos_m):
    """Nominal polar mic positions + Gaussian XY error -> new geometry."""
    x = geometry.r_vec * np.cos(geometry.theta_vec)
    y = geometry.r_vec * np.sin(geometry.theta_vec)
    x = x + rng.normal(0, sigma_pos_m, x.shape)
    y = y + rng.normal(0, sigma_pos_m, y.shape)
    r = np.hypot(x, y)
    r = np.maximum(r, 1e-4)  # ArrayGeometry requires positive radii
    return ArrayGeometry(r, np.arctan2(y, x), speed=geometry.speed)


def run(num_trials: int = 20, num_grid: int = 16 * 7, seed: int = 0,
        duration: float = 0.25):
    geometry = CenterCircularArray(radius=4.5e-2, num_mic=7)
    grid = np.linspace(-np.pi, np.pi, num_grid)
    freq_range = (1600.0, 1900.0)
    t = np.arange(0, duration, 1 / FS)
    sig = np.sin(2 * np.pi * 1750.0 * t)

    bf = Beamformer(geometry, kernel_duration=10e-3, freq_range=freq_range, fs=FS)
    # NUMPY closures: the jitted programs embed host constants only
    from haghighatshoarmuir2024.utils import to_numpy

    bf_mat = to_numpy(bf.design_from_template((t, sig), grid)[0])
    demo = Demo(
        geometry=geometry, freq_bands=[list(freq_range)], doa_list=grid,
        recording_duration=duration, kernel_duration=10e-3,
        bipolar_spikes=True, fs=FS,
    )
    demo.calibrate_profiles()
    profiles = np.asarray(demo._profiles, np.float32)
    rates_fn = demo._rates_batch_jit
    grid_j = jnp.asarray(grid)
    G = num_grid

    @jax.jit
    def est_hilbert(frames):
        def one(x):
            out = bf.apply_to_signal(bf_mat, x)
            return grid_j[jnp.argmax(jnp.mean(jnp.abs(out) ** 2, axis=0))]
        return jax.vmap(one)(frames)

    @jax.jit
    def est_xylo(frames):
        rate = rates_fn(frames)
        folded = rate.reshape(rate.shape[0], -1, G).mean(1)
        rc = folded - folded.mean(axis=-1, keepdims=True)
        s = jnp.matmul(rc, profiles.T, precision=jax.lax.Precision.HIGHEST)
        return grid_j[jnp.argmax(s, axis=-1)]

    def sweep(kind, values):
        rows = {"hilbert_mae_deg": [], "xylo_matched_mae_deg": []}
        for v in values:
            rng = np.random.default_rng(seed)
            keys = jax.random.split(jax.random.PRNGKey(seed), num_trials)
            doa_true = rng.uniform(0, 2 * np.pi, num_trials)
            frames = []
            for i in range(num_trials):
                g = (
                    _perturbed_geometry(geometry, rng, v * 1e-3)
                    if kind == "pos" else geometry
                )
                clean = np.asarray(
                    signal_from_template(g, t, sig, float(doa_true[i]), fs=FS)
                )
                if kind == "gain":
                    gains = 10 ** (rng.normal(0, v, clean.shape[1]) / 20.0)
                    clean = clean * gains[None, :]
                sigma = np.sqrt((clean**2).mean() / 10 ** (SNR_DB / 10))
                noise = np.asarray(
                    jax.random.normal(keys[i], clean.shape), np.float64
                )
                frames.append((clean + sigma * noise).astype(np.float32))
            frames = jnp.asarray(np.stack(frames))
            for name, fn in (("hilbert", est_hilbert), ("xylo_matched", est_xylo)):
                err = np.asarray(
                    folded_angle_error(fn(frames), jnp.asarray(doa_true))
                )
                rows[name + "_mae_deg"].append(round(float(np.degrees(err.mean())), 2))
        return rows

    return {
        "snr_db": SNR_DB, "num_trials": num_trials,
        "gain_spread_db": GAIN_DB, "gain": sweep("gain", GAIN_DB),
        "pos_error_mm": POS_MM, "pos": sweep("pos", POS_MM),
    }


def main():
    from common import fig_lines

    num_trials = 8 if "--quick" in sys.argv else 20
    if "--trials" in sys.argv:
        num_trials = int(sys.argv[sys.argv.index("--trials") + 1])
    res = run(num_trials=num_trials)
    fig_lines(res["gain_spread_db"], {
        "Hilbert": res["gain"]["hilbert_mae_deg"],
        "quantized Xylo (matched)": res["gain"]["xylo_matched_mae_deg"],
    }, "mismatch_gain_mae.pdf", xlabel="per-mic gain spread [dB std]",
        ylabel="MAE [deg]")
    fig_lines(res["pos_error_mm"], {
        "Hilbert": res["pos"]["hilbert_mae_deg"],
        "quantized Xylo (matched)": res["pos"]["xylo_matched_mae_deg"],
    }, "mismatch_pos_mae.pdf", xlabel="mic position error [mm std]",
        ylabel="MAE [deg]")
    print(json.dumps({"experiment": "mismatch_robustness", "results": res}, indent=2))
    return res


if __name__ == "__main__":
    main()
