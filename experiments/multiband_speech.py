"""Multi-band quantized-pipeline accuracy on REAL SPEECH — beyond-parity.

The reference's quantized deployments are single-band by hardware necessity:
F bands cost F x 449 hidden neurons and the Xylo-A2 chip has 1000
(micloc/xylo_snn_localization.py:596-601; its live benchmark ran the three
bands 1600-2000/2000-2300/2300-2600 ONE at a time,
paper_plots/snn_localization_benchmark.py:556-562).  Speech is wideband, so
a single 1 kHz-wide band throws away most of the signal energy — the round-3
speech MC shows the cost (MAE ~28-35 degrees at -10 dB on the 1-2 kHz band).

This experiment runs the SAME speech-target Monte Carlo through a 3-band
quantized pipeline (software deployment, enforce_hw_limits=False) and
compares, at matched grid/template/seeds:

  * single-band [1000, 2000] (the round-3 speech harness config);
  * 3 bands [500-1000 | 1000-2000 | 2000-3000] covering the speech formant
    range, rates folded over bands (reference folding,
    micloc/xylo_snn_localization.py:379-398);
  * the same 3 bands with the BAND-STACKED matched estimator
    (calibrate_profiles(band_stacked=True)): each band's angular response is
    matched in its own coordinates and the per-band correlation evidence
    adds, instead of averaging warped profiles across bands.

Estimators: reference-parity windowed peak + matched (speech-calibrated) per
config, + matched_stacked for the 3-band config.

Usage: python experiments/multiband_speech.py [--quick] [--sims N]
(owns the GPU for a few minutes).
"""
import json
import sys

import numpy as np
import jax
import jax.numpy as jnp

from common import FS, speech_template

from haghighatshoarmuir2024 import CenterCircularArray
from haghighatshoarmuir2024.models.xylo import Demo
from haghighatshoarmuir2024.models.xylo.pipeline import (
    _auto_blend_scores,
    _blockcos,
    _cos1,
)
from haghighatshoarmuir2024.ops.interp import signal_from_template
from haghighatshoarmuir2024.parallel import folded_angle_error
from haghighatshoarmuir2024.utils.peak_location import find_peak_location

SNRS = [-10.0, -4.0, 2.0, 8.0, 14.0, 20.0]


def _mc_config(demo, t_sp, sig_sp, num_sims, seed, chunk=16, stacked=False):
    """MC sweep for one Demo config.  One jitted program per SNR chunk:
    synthesize noisy random-DoA speech frames, one batched rates forward,
    every estimator from the same rates."""
    geometry = demo.geometry
    grid_j = jnp.asarray(demo.doa_list)
    G = len(demo.doa_list)
    win = max(2 * ((G // 32) // 2) + 1, 1)
    t_j = jnp.asarray(t_sp, jnp.float32)
    s_j = jnp.asarray(sig_sp, jnp.float32)

    # numpy closures: the jitted programs embed host constants only
    prof_folded = np.asarray(
        demo.calibrate_profiles(template=(t_sp, sig_sp)), np.float32
    )
    prof_stacked = None
    if stacked:
        prof_stacked = np.asarray(
            demo.calibrate_profiles(template=(t_sp, sig_sp), band_stacked=True),
            np.float32,
        )
    rates_fn = demo._rates_batch_jit

    def synth_one(key, snr_db):
        k_doa, k_noise = jax.random.split(key)
        doa_true = jax.random.uniform(k_doa, (), minval=0.0, maxval=2 * jnp.pi)
        sig_in = signal_from_template(geometry, t_j, s_j, doa_true, fs=FS)
        sigma = jnp.sqrt(jnp.mean(sig_in**2) / 10 ** (snr_db / 10))
        noisy = sig_in + sigma * jax.random.normal(k_noise, sig_in.shape, sig_in.dtype)
        return doa_true, noisy

    @jax.jit
    def trial_chunk(keys, snr_db):
        true, frames = jax.vmap(synth_one, in_axes=(0, None))(keys, snr_db)
        rate = rates_fn(frames)  # (chunk, H)
        folded = rate.reshape(rate.shape[0], -1, G).mean(1)  # (chunk, G)
        idx = jax.vmap(lambda r: find_peak_location(r, win) if win > 1 else jnp.argmax(r))(folded)
        ests = [grid_j[idx]]
        rc = folded - folded.mean(axis=-1, keepdims=True)
        scores = jnp.matmul(rc, prof_folded.T, precision=jax.lax.Precision.HIGHEST)
        ests.append(grid_j[jnp.argmax(scores, axis=-1)])
        if prof_stacked is not None:
            ru = rate - rate.mean(axis=-1, keepdims=True)
            s2 = jnp.matmul(ru, prof_stacked.T, precision=jax.lax.Precision.HIGHEST)
            ests.append(grid_j[jnp.argmax(s2, axis=-1)])
            # per-band COSINE variant and the SNR-adaptive blends: measured
            # through the SHIPPED scorers (models/xylo/pipeline._blockcos /
            # _cos1 / _auto_blend_scores) — an inline copy here would let the
            # production scorer drift away from what this ablation validates
            s3 = jnp.matmul(
                _blockcos(rate, G), _blockcos(jnp.asarray(prof_stacked), G).T,
                precision=jax.lax.Precision.HIGHEST,
            )
            ests.append(grid_j[jnp.argmax(s3, axis=-1)])
            # combined: per-band cosines + the folded profile's cosine (the
            # fold averages band noise 3x, strongest evidence at low SNR;
            # the band cosines dominate at high SNR) — one bounded sum
            sfold = jnp.matmul(
                _cos1(folded), _cos1(jnp.asarray(prof_folded)).T,
                precision=jax.lax.Precision.HIGHEST,
            )
            s4 = s3 + sfold
            ests.append(grid_j[jnp.argmax(s4, axis=-1)])
            # SNR-ADAPTIVE blends (ROADMAP's remaining estimator idea): the
            # folded cosine wins below ~-4 dB (3x noise averaging), the
            # per-band cosines above; the fixed sum s4 splits the difference.
            # _auto_blend_scores weights each bounded component by its own
            # achieved confidence, so the blend adapts per trial with no SNR
            # oracle — exactly the estimator served as method="matched_auto".
            for wname in ("peak", "peak2", "contrast"):
                sw = _auto_blend_scores(
                    rate, jnp.asarray(prof_stacked), G, weight=wname
                )
                ests.append(grid_j[jnp.argmax(sw, axis=-1)])
        return true, jnp.stack(ests, axis=-1)  # (chunk,), (chunk, K)

    keys = jax.random.split(jax.random.PRNGKey(seed), num_sims)
    pad = (-num_sims) % chunk
    if pad:  # modular gather: pad can exceed num_sims when chunk > num_sims
        keys = jnp.concatenate([keys, keys[jnp.arange(pad) % num_sims]])
    out = []
    for snr_db in SNRS:
        errs = []
        for s in range(0, keys.shape[0], chunk):
            true, ests = trial_chunk(keys[s : s + chunk], jnp.asarray(float(snr_db)))
            errs.append(np.asarray(folded_angle_error(ests, true[:, None])))
        out.append(np.concatenate(errs)[:num_sims])
    return np.stack(out)  # (num_snr, num_sims, K)


def run(num_sims: int = 50, num_grid: int = 16 * 7, seed: int = 0,
        duration: float = 1.0, chunk: int = 16):
    geometry = CenterCircularArray(radius=4.5e-2, num_mic=7)
    doa_list = np.linspace(-np.pi, np.pi, num_grid)
    t_sp, sig_sp = speech_template(duration=duration)

    common = dict(
        geometry=geometry,
        doa_list=doa_list,
        recording_duration=duration,
        kernel_duration=10e-3,
        bipolar_spikes=True,
        fs=FS,
    )
    res = {"snr_db": SNRS, "num_sims": num_sims, "num_grid": num_grid}

    # --- single band (round-3 speech harness config)
    demo1 = Demo(freq_bands=[[1000.0, 2000.0]], **common)
    e1 = _mc_config(demo1, t_sp, sig_sp, num_sims, seed, chunk=chunk)
    res["single_band_1000_2000"] = {
        "reference_peak_mae_deg": np.degrees(e1[:, :, 0].mean(1)).round(2).tolist(),
        "matched_speech_cal_mae_deg": np.degrees(e1[:, :, 1].mean(1)).round(2).tolist(),
    }
    del demo1

    # --- three bands over the speech formant range (3 x G hidden neurons —
    # impossible on the 1000-neuron Xylo-A2 at G=449; trivial in software)
    bands3 = [[500.0, 1000.0], [1000.0, 2000.0], [2000.0, 3000.0]]
    demo3 = Demo(freq_bands=bands3, enforce_hw_limits=False, **common)
    e3 = _mc_config(demo3, t_sp, sig_sp, num_sims, seed, chunk=chunk, stacked=True)
    res["three_band_500_3000"] = {
        "freq_bands": bands3,
        "reference_peak_mae_deg": np.degrees(e3[:, :, 0].mean(1)).round(2).tolist(),
        "matched_speech_cal_mae_deg": np.degrees(e3[:, :, 1].mean(1)).round(2).tolist(),
        "matched_band_stacked_mae_deg": np.degrees(e3[:, :, 2].mean(1)).round(2).tolist(),
        "matched_band_cos_mae_deg": np.degrees(e3[:, :, 3].mean(1)).round(2).tolist(),
        "matched_band_cosfold_mae_deg": np.degrees(e3[:, :, 4].mean(1)).round(2).tolist(),
        "matched_auto_peak_mae_deg": np.degrees(e3[:, :, 5].mean(1)).round(2).tolist(),
        "matched_auto_peak2_mae_deg": np.degrees(e3[:, :, 6].mean(1)).round(2).tolist(),
        "matched_auto_contrast_mae_deg": np.degrees(e3[:, :, 7].mean(1)).round(2).tolist(),
    }
    return res


def run_cross_segment(num_sims: int = 50, num_grid: int = 16 * 7, seed: int = 0,
                      duration: float = 1.0, chunk: int = 16):
    """Cross-SEGMENT speech calibration: calibrate the 3-band stacked
    profiles on a different 1 s stretch of the utterance than the trials
    use.  Answers whether speech calibration overfits the exact segment
    (the round-2 verdict flagged same-template calibration circularity;
    cross-template landed in round 3 — this is the finer within-class
    check)."""
    geometry = CenterCircularArray(radius=4.5e-2, num_mic=7)
    doa_list = np.linspace(-np.pi, np.pi, num_grid)
    t_eval, sig_eval = speech_template(duration=duration, segment=0)
    t_cal, sig_cal = speech_template(duration=duration, segment=1)

    demo = Demo(
        geometry=geometry,
        freq_bands=[[500.0, 1000.0], [1000.0, 2000.0], [2000.0, 3000.0]],
        doa_list=doa_list,
        recording_duration=duration,
        kernel_duration=10e-3,
        bipolar_spikes=True,
        fs=FS,
        enforce_hw_limits=False,
    )
    grid_j = jnp.asarray(doa_list)
    G = num_grid
    rates_fn = demo._rates_batch_jit

    profs = {
        "self_segment": demo.calibrate_profiles(
            template=(t_eval, sig_eval), band_stacked=True),
        "cross_segment": demo.calibrate_profiles(
            template=(t_cal, sig_cal), band_stacked=True),
    }
    t_j = jnp.asarray(t_eval, jnp.float32)
    s_j = jnp.asarray(sig_eval, jnp.float32)

    # numpy closures, scored through the SHIPPED per-band cosine (pipeline._blockcos)
    prof_cos = {
        k: np.asarray(_blockcos(jnp.asarray(v, jnp.float32), G))
        for k, v in profs.items()
    }

    def synth_one(key, snr_db):
        k_doa, k_noise = jax.random.split(key)
        doa_true = jax.random.uniform(k_doa, (), minval=0.0, maxval=2 * jnp.pi)
        sig_in = signal_from_template(geometry, t_j, s_j, doa_true, fs=FS)
        sigma = jnp.sqrt(jnp.mean(sig_in**2) / 10 ** (snr_db / 10))
        return doa_true, sig_in + sigma * jax.random.normal(
            k_noise, sig_in.shape, sig_in.dtype)

    @jax.jit
    def trial_chunk(keys, snr_db):
        true, frames = jax.vmap(synth_one, in_axes=(0, None))(keys, snr_db)
        rc = _blockcos(rates_fn(frames), G)
        ests = [
            grid_j[jnp.argmax(
                jnp.matmul(rc, p.T, precision=jax.lax.Precision.HIGHEST),
                axis=-1)]
            for p in prof_cos.values()
        ]
        return true, jnp.stack(ests, axis=-1)

    snrs = [-4.0, 8.0, 20.0]
    keys = jax.random.split(jax.random.PRNGKey(seed), num_sims)
    pad = (-num_sims) % chunk
    if pad:  # modular gather: pad can exceed num_sims when chunk > num_sims
        keys = jnp.concatenate([keys, keys[jnp.arange(pad) % num_sims]])
    out = {"snr_db": snrs}
    errs = []
    for snr_db in snrs:
        es = []
        for s in range(0, keys.shape[0], chunk):
            true, ests = trial_chunk(keys[s : s + chunk], jnp.asarray(float(snr_db)))
            es.append(np.asarray(folded_angle_error(ests, true[:, None])))
        errs.append(np.concatenate(es)[:num_sims])
    errs = np.stack(errs)  # (snr, sims, 2)
    for k, lab in enumerate(profs):
        out[lab + "_mae_deg"] = np.degrees(errs[:, :, k].mean(1)).round(2).tolist()
    return out


def main():
    from common import fig_mae_vs_snr

    num_sims = 50
    if "--quick" in sys.argv:
        num_sims = 8
    if "--sims" in sys.argv:
        num_sims = int(sys.argv[sys.argv.index("--sims") + 1])
    if "--cross-segment" in sys.argv:
        res = run_cross_segment(num_sims=num_sims)
        print(json.dumps(
            {"experiment": "multiband_speech_cross_segment", "results": res},
            indent=2))
        return res
    res = run(num_sims=num_sims)
    snr = res["snr_db"]
    fig_mae_vs_snr(
        {
            "single band, matched": (snr, res["single_band_1000_2000"]["matched_speech_cal_mae_deg"]),
            "3 bands, matched (folded)": (snr, res["three_band_500_3000"]["matched_speech_cal_mae_deg"]),
            "3 bands, matched_stacked (cos)": (snr, res["three_band_500_3000"]["matched_band_cos_mae_deg"]),
            "single band, reference peak": (snr, res["single_band_1000_2000"]["reference_peak_mae_deg"]),
        },
        "multiband_speech_mae.pdf",
    )
    print(json.dumps({"experiment": "multiband_speech", "results": res}, indent=2))
    return res


if __name__ == "__main__":
    main()
