"""Monte-Carlo DoA accuracy of the full quantized Xylo pipeline — twin of
paper_plots/target_xylo_localization.py (bipolar, 100 sims) and
target_xylo_unipolar_localization.py (unipolar, 20 sims): random DoA per
trial, robust windowed peak finding (win = num_grid//32 oddified, :326-333),
folded angle metric.

``--speech`` runs the twin of the reference's speech-target harness
(paper_plots/target_xylo_localization.py:123-394, invoked first in its
main() at :792-794): the LibriSpeech sample through the full
encode→XyloSim→rate chain — fixed-DoA beam profiles at bandwidth-corrected
SNR ∈ {-10, 0, 10, 20} dB (:205-226), then the MC MAE-vs-SNR sweep on speech
trials (:269-338).  It additionally quantifies the matched estimator's
TEMPLATE MISMATCH: profiles calibrated on the design tone evaluated on
speech/chirp trials vs profiles calibrated on the evaluation template itself
(the calibration-robustness table in RESULTS.md)."""
import json
import sys

import numpy as np
import jax
import jax.numpy as jnp

from common import (
    FS,
    chirp_template,
    sinusoid_template,
    snr_sweep_config,
    speech_template,
    summarize,
)

from haghighatshoarmuir2024 import CenterCircularArray
from haghighatshoarmuir2024.models.xylo import Demo
from haghighatshoarmuir2024.ops.interp import signal_from_template
from haghighatshoarmuir2024.parallel import (
    make_trial_fn,
    monte_carlo_sweep,
    snr_with_bandwidth_correction,
)
from haghighatshoarmuir2024.utils.peak_location import find_peak_location


def run(bipolar: bool = True, num_sims: int = 100, num_grid: int = 16 * 7, seed: int = 0,
        envelope: bool = True):
    geometry = CenterCircularArray(radius=4.5e-2, num_mic=7)
    freq_design = 2_000.0
    freq_range = [0.5 * freq_design, freq_design]
    doa_list = np.linspace(-np.pi, np.pi, num_grid)

    demo = Demo(
        geometry=geometry,
        freq_bands=[freq_range],
        doa_list=doa_list,
        recording_duration=0.25,
        kernel_duration=10e-3,
        bipolar_spikes=bipolar,
        fs=FS,
    )

    freq_mid = float(np.mean(freq_range))
    t, sig = sinusoid_template(freq_mid, 0.25)

    grid_j = jnp.asarray(doa_list)
    win = num_grid // 32
    win = 2 * (win // 2) + 1
    fwd = demo._forward_jit

    def estimate(sig_in):
        _, rate = fwd(sig_in)
        if win > 1:
            idx = find_peak_location(rate, win)
        else:
            idx = jnp.argmax(rate)
        return grid_j[idx]

    trial = make_trial_fn(geometry, t, sig, estimate, FS)
    out = {
        "reference_estimator": monte_carlo_sweep(
            trial, snr_sweep_config(), num_sims, jax.random.PRNGKey(seed)
        )
    }

    # this framework's matched-profile estimator (calibrated, bias-free)
    demo.calibrate_profiles(template=(t, sig))
    profiles = demo._profiles

    def estimate_matched(sig_in):
        _, rate = fwd(sig_in)
        r = rate - jnp.mean(rate)
        return grid_j[jnp.argmax(profiles @ r)]

    trial_m = make_trial_fn(geometry, t, sig, estimate_matched, FS)
    out["matched_estimator"] = monte_carlo_sweep(
        trial_m, snr_sweep_config(), num_sims, jax.random.PRNGKey(seed)
    )
    if envelope:
        # the reference-parity (peak) rows carry the XyloSim step-convention
        # ambiguity; print its min–max band beside them
        out["reference_estimator_convention_envelope"] = convention_envelope(
            demo, t, sig, snr_sweep_config(), num_sims=min(num_sims, 25), seed=seed
        )
    return out


def convention_envelope(
    demo, t, sig, snr_db_vec, num_sims: int = 25, seed: int = 0, batch: int = 25
):
    """Min–max MAE envelope of the reference-parity peak estimator over the
    four XyloSim step conventions.

    rockpool is uninstallable here, so the exact ordering of
    micloc/xylo_snn_localization.py:286-313's delegated ``XyloSim`` step is
    unverifiable; the quantized pipeline's raw-peak numbers therefore carry a
    convention ambiguity (bounded in experiments/xylo_ordering_sensitivity.py
    at ≤5.7° tone MAE).  This prints that band NEXT TO the headline MC rows
    instead of leaving it in a footnote: every variant sees identical spike
    rasters (one shared encode), so the spread is purely the step convention.
    """
    import itertools

    from haghighatshoarmuir2024.models.xylo.sim import sim_hidden_batch

    variants = list(
        itertools.product(("decay_first", "integrate_first"), ("subtract", "zero"))
    )
    geometry = demo.geometry
    G = len(demo.doa_list)
    cfg = demo.xylo_config
    encode = jax.jit(jax.vmap(demo.spike_encoding))
    grid = np.asarray(demo.doa_list)

    rng = np.random.default_rng(seed)
    doa_true = rng.uniform(-np.pi, np.pi, size=num_sims)
    frames_clean = np.stack(
        [
            np.asarray(signal_from_template(geometry, t, sig, float(d), fs=FS))
            for d in doa_true
        ]
    ).astype(np.float32)
    sig_pow = np.mean(frames_clean**2, axis=(1, 2), keepdims=True)

    env = {"snr_db": [float(s) for s in snr_db_vec], "num_sims": num_sims}
    per_variant = {f"{o}/{r}": [] for o, r in variants}
    for snr_db in snr_db_vec:
        sigma = np.sqrt(sig_pow / 10 ** (snr_db / 10))
        noisy = frames_clean + sigma * rng.standard_normal(frames_clean.shape).astype(
            np.float32
        )
        maes = []
        for s0 in range(0, num_sims, batch):
            chunk = jnp.asarray(noisy[s0 : s0 + batch])
            spikes_in = np.asarray(encode(chunk), np.int8)
            chunk_maes = []
            for ordering, reset in variants:
                spk = np.asarray(
                    sim_hidden_batch(cfg, spikes_in, ordering=ordering, reset=reset)
                )
                rate = spk.mean(axis=1).reshape(spk.shape[0], -1, G).mean(axis=1)
                est = grid[np.argmax(rate, axis=-1)]
                err = np.abs(
                    np.arcsin(np.abs(np.sin(est - doa_true[s0 : s0 + batch])))
                )
                chunk_maes.append(np.degrees(err))
            maes.append(np.stack(chunk_maes))  # (V, chunk)
        per_snr = np.concatenate(maes, axis=1).mean(axis=1)  # (V,)
        for v, (o, r) in enumerate(variants):
            per_variant[f"{o}/{r}"].append(float(per_snr[v]))
    env["mae_deg_by_variant"] = per_variant
    env["mae_deg_min"] = [
        float(min(per_variant[k][i] for k in per_variant))
        for i in range(len(snr_db_vec))
    ]
    env["mae_deg_max"] = [
        float(max(per_variant[k][i] for k in per_variant))
        for i in range(len(snr_db_vec))
    ]
    return env


# --------------------------------------------------------------------- speech
def _multi_estimator_sweep(trial, snr_db_vec, num_sims, key, batch_size=20):
    """MC sweep where ``trial(key, snr_db) -> (doa_true, ests (K,))`` returns
    several estimators' answers from ONE pipeline forward (the reference
    recomputes per estimator; here the rate profile is shared)."""
    from haghighatshoarmuir2024.parallel import folded_angle_error

    keys = jax.random.split(key, num_sims)
    chunk = min(batch_size, num_sims)
    pad = (-num_sims) % chunk
    if pad:
        keys = jnp.concatenate([keys, keys[:pad]])
    batched = jax.jit(jax.vmap(trial, in_axes=(0, None)))
    out = []
    for snr_db in snr_db_vec:
        es = []
        for s in range(0, keys.shape[0], chunk):
            true, ests = batched(keys[s : s + chunk], jnp.asarray(float(snr_db)))
            es.append(np.asarray(folded_angle_error(ests, true[:, None])))
        out.append(np.concatenate(es)[:num_sims])  # (num_sims, K)
    return np.stack(out)  # (num_snr, num_sims, K)


def run_speech(
    bipolar: bool = True,
    num_sims: int = 100,
    num_grid: int = 16 * 7,
    seed: int = 0,
    duration: float = 1.0,
    batch_size: int = 20,
):
    """Speech-target twin (paper_plots/target_xylo_localization.py:123-394).

    Deviations, documented: grid 112 (not 449) and the speech sample truncated
    to ``duration`` seconds per trial — same conventions as the tone twin
    above; the harness logic (bandwidth-corrected fixed-DoA profiles, then the
    uncorrected 11-point MC sweep on random DoAs, :291-333) is reproduced.
    """
    geometry = CenterCircularArray(radius=4.5e-2, num_mic=7)
    freq_design = 2_000.0
    freq_range = [0.5 * freq_design, freq_design]
    doa_list = np.linspace(-np.pi, np.pi, num_grid)

    # reference speech harness designs with a 1.0 s template (:152-166)
    demo = Demo(
        geometry=geometry,
        freq_bands=[freq_range],
        doa_list=doa_list,
        recording_duration=1.0,
        kernel_duration=10e-3,
        bipolar_spikes=bipolar,
        fs=FS,
    )
    grid_j = jnp.asarray(doa_list)
    win = max(2 * ((num_grid // 32) // 2) + 1, 1)
    fwd = demo._forward_jit

    t_sp, sig_sp = speech_template(duration=duration)

    # ---- matched-profile calibrations: design tone vs evaluation templates
    profiles_tone = jnp.asarray(demo.calibrate_profiles())  # default f_mid tone
    t_ch, sig_ch = chirp_template(freq_range, duration)
    profiles_chirp = jnp.asarray(demo.calibrate_profiles(template=(t_ch, sig_ch)))
    profiles_speech = jnp.asarray(demo.calibrate_profiles(template=(t_sp, sig_sp)))
    f_mid = float(np.mean(freq_range))
    t_tone, sig_tone = sinusoid_template(f_mid, duration)

    def estimators(rate, profs):
        """(reference peak-win, matched per profile table in ``profs``)."""
        idx = find_peak_location(rate, win) if win > 1 else jnp.argmax(rate)
        ests = [grid_j[idx]]
        r = rate - jnp.mean(rate)
        for p in profs:
            scores = jnp.matmul(p, r, precision=jax.lax.Precision.HIGHEST)
            ests.append(grid_j[jnp.argmax(scores)])
        return jnp.stack(ests)

    # ---- stage A: fixed-DoA (0) beam profiles, bandwidth-corrected SNR
    # (paper_plots/target_xylo_localization.py:196-226)
    sig_fixed = signal_from_template(
        geometry, jnp.asarray(t_sp, jnp.float32), jnp.asarray(sig_sp, jnp.float32),
        jnp.asarray(0.0), fs=FS,
    )
    beam = {}
    rng = np.random.default_rng(seed)
    sig_pow = float(np.mean(np.asarray(sig_fixed) ** 2))
    for snr_db in (-10.0, 0.0, 10.0, 20.0):
        snr_bw = snr_with_bandwidth_correction(snr_db, FS, freq_range)
        sigma = np.sqrt(sig_pow / 10 ** (snr_bw / 10))
        noisy = np.asarray(sig_fixed) + sigma * rng.standard_normal(sig_fixed.shape)
        _, rate = fwd(jnp.asarray(noisy, jnp.float32))
        rate = np.asarray(rate)
        power = rate / max(rate.max(), 1e-12)
        est = estimators(jnp.asarray(rate), [profiles_tone, profiles_speech])
        err = np.degrees(np.arcsin(np.abs(np.sin(np.asarray(est)))))
        beam[f"{snr_db:+.0f}dB"] = {
            "peak_err_deg": float(err[0]),
            "matched_tone_err_deg": float(err[1]),
            "matched_speech_err_deg": float(err[2]),
            "sidelobe_db": float(
                10 * np.log10(max(np.partition(power, -2)[-2], 1e-12))
            ),
            "profile": power.tolist(),
        }

    # ---- stage B: MC MAE-vs-SNR on speech trials (:269-338) with the
    # reference-parity estimator AND the matched variants side by side
    def trial_speech(key, snr_db):
        k_doa, k_noise = jax.random.split(key)
        doa_true = jax.random.uniform(k_doa, (), minval=0.0, maxval=2 * jnp.pi)
        sig_in = signal_from_template(
            geometry, jnp.asarray(t_sp, jnp.float32),
            jnp.asarray(sig_sp, jnp.float32), doa_true, fs=FS,
        )
        sigma = jnp.sqrt(jnp.mean(sig_in**2) / 10 ** (snr_db / 10))
        noisy = sig_in + sigma * jax.random.normal(k_noise, sig_in.shape, sig_in.dtype)
        _, rate = fwd(noisy)
        return doa_true, estimators(rate, [profiles_tone, profiles_speech])

    errs = _multi_estimator_sweep(
        trial_speech, snr_sweep_config(), num_sims, jax.random.PRNGKey(seed),
        batch_size,
    )
    labels = ["reference_peak", "matched_tone_cal", "matched_speech_cal"]
    mc = {
        "snr_db": [float(s) for s in snr_sweep_config()],
        **{
            lab: {
                "mae_deg": [float(np.degrees(m)) for m in errs[:, :, k].mean(axis=1)],
                "median_deg": [
                    float(np.degrees(m)) for m in np.median(errs[:, :, k], axis=1)
                ],
            }
            for k, lab in enumerate(labels)
        },
    }

    # ---- stage C: calibration-robustness table — evaluate each template
    # with the tone-calibrated AND the self-calibrated matched profiles
    robust_snrs = [-10.0, 0.0, 10.0, 20.0]
    robustness = {}
    for name, (t_e, sig_e, prof_self) in {
        "tone": (t_tone, sig_tone, profiles_tone),
        "chirp": (t_ch, sig_ch, profiles_chirp),
        "speech": (t_sp, sig_sp, profiles_speech),
    }.items():
        t_j = jnp.asarray(t_e, jnp.float32)
        s_j = jnp.asarray(sig_e, jnp.float32)

        def trial(key, snr_db, t_j=t_j, s_j=s_j, prof_self=prof_self):
            k_doa, k_noise = jax.random.split(key)
            doa_true = jax.random.uniform(k_doa, (), minval=0.0, maxval=2 * jnp.pi)
            sig_in = signal_from_template(geometry, t_j, s_j, doa_true, fs=FS)
            sigma = jnp.sqrt(jnp.mean(sig_in**2) / 10 ** (snr_db / 10))
            noisy = sig_in + sigma * jax.random.normal(
                k_noise, sig_in.shape, sig_in.dtype
            )
            _, rate = fwd(noisy)
            return doa_true, estimators(rate, [profiles_tone, prof_self])

        e = _multi_estimator_sweep(
            trial, robust_snrs, num_sims, jax.random.PRNGKey(seed + 1), batch_size
        )
        robustness[name] = {
            "snr_db": robust_snrs,
            "reference_peak_mae_deg": [float(np.degrees(m)) for m in e[:, :, 0].mean(axis=1)],
            "matched_tone_cal_mae_deg": [float(np.degrees(m)) for m in e[:, :, 1].mean(axis=1)],
            "matched_self_cal_mae_deg": [float(np.degrees(m)) for m in e[:, :, 2].mean(axis=1)],
        }

    return {"beam_profiles": beam, "speech_mc": mc, "calibration_robustness": robustness}


def main_speech():
    from common import fig_lines, fig_mae_vs_snr

    bipolar = "--unipolar" not in sys.argv
    sims = 100 if bipolar else 20
    if "--quick" in sys.argv:
        sims = 10
    res = run_speech(bipolar=bipolar, num_sims=sims)
    mc = res["speech_mc"]
    fig_mae_vs_snr(
        {
            lab: (mc["snr_db"], mc[lab]["mae_deg"])
            for lab in ("reference_peak", "matched_tone_cal", "matched_speech_cal")
        },
        f"target_xylo_speech_{'bipolar' if bipolar else 'unipolar'}_mae.pdf",
    )
    grid = np.linspace(-180, 180, len(next(iter(res["beam_profiles"].values()))["profile"]))
    fig_lines(
        grid,
        {k: v["profile"] for k, v in res["beam_profiles"].items()},
        "xylo_fixed_speech_beam.pdf",
        xlabel="DoA (deg.)",
        ylabel="normalized rate",
    )
    out = {
        "experiment": f"target_xylo_speech_{'bipolar' if bipolar else 'unipolar'}",
        "results": {
            "beam_profiles": {
                k: {kk: vv for kk, vv in v.items() if kk != "profile"}
                for k, v in res["beam_profiles"].items()
            },
            "speech_mc": res["speech_mc"],
            "calibration_robustness": res["calibration_robustness"],
        },
    }
    print(json.dumps(out, indent=2))
    return res


def main():
    from common import fig_mae_vs_snr

    if "--speech" in sys.argv:
        return main_speech()

    bipolar = "--unipolar" not in sys.argv
    sims = 100 if bipolar else 20
    if "--quick" in sys.argv:
        sims = 10
    res = run(bipolar=bipolar, num_sims=sims)
    env = res.pop("reference_estimator_convention_envelope", None)
    sm = {k: summarize(v) for k, v in res.items()}
    if env is not None:
        sm["reference_estimator_convention_envelope"] = env
    fig_mae_vs_snr(
        {k: (v["snr_db"], v["mae_deg"]) for k, v in sm.items() if "mae_deg" in v},
        f"target_xylo_{'bipolar' if bipolar else 'unipolar'}_mae.pdf",
    )
    print(
        json.dumps(
            {
                "experiment": f"target_xylo_{'bipolar' if bipolar else 'unipolar'}_localization",
                "results": sm,
            },
            indent=2,
        )
    )
    return res


if __name__ == "__main__":
    main()
