"""Live-style quantized-SNN benchmark — twin of
paper_plots/snn_localization_benchmark.py: collect N DoA estimates from
repeated noisy frames (the reference records from the real board), save to a
timestamped .txt, and run the reference's windowed-median analysis
(:595-660).  Also re-analyzes the reference's committed data when present."""
import json
import os
import sys
import time

import numpy as np
import jax

from common import FS, chirp_template

from haghighatshoarmuir2024 import CenterCircularArray
from haghighatshoarmuir2024.models.xylo import Demo
from haghighatshoarmuir2024.ops.interp import signal_from_template
from haghighatshoarmuir2024.utils.stats import analyze_doa_samples

REF_DATA_DIRS = [
    "/root/reference/paper_plots/demo-benchmark-simulation-freq1600-2000",
    "/root/reference/paper_plots/demo-benchmark-simulation-freq2000-2300",
    "/root/reference/paper_plots/demo-benchmark-simulation-freq2300-2600",
]


def _make_demo(freq_band):
    num_mic = 7
    geometry = CenterCircularArray(radius=4.5e-2, num_mic=num_mic)
    num_grid = 64 * num_mic + 1
    return Demo(
        geometry=geometry,
        freq_bands=[list(freq_band)],
        doa_list=np.linspace(-np.pi, np.pi, num_grid),
        recording_duration=0.4,
        kernel_duration=20e-3,
        bipolar_spikes=True,
        fs=FS,
    )


def _clean_frame(demo, freq_band, doa_true, reflection: float = 0.0):
    """Array input for the benchmark chirp — free-field, or reverberant via
    the image-source model (reflection > 0; reverb_robustness.py's room)."""
    t, sig = chirp_template(freq_band, 0.4)
    if reflection <= 0.0:
        return np.asarray(
            signal_from_template(demo.geometry, t, sig, doa_true, fs=FS)
        )
    from haghighatshoarmuir2024.ops.interp import (
        room_image_paths,
        signal_from_template_multipath,
    )

    room, array_xy = (5.0, 4.0), (2.2, 1.7)
    # place the source at the requested DoA, 1.5 m from the array
    src = (array_xy[0] + 1.5 * np.cos(doa_true), array_xy[1] + 1.5 * np.sin(doa_true))
    doas, extra, gains = room_image_paths(
        src, array_xy, room, reflection=reflection, order=2
    )
    return np.asarray(
        signal_from_template_multipath(
            demo.geometry, t, sig, doas, extra, gains, fs=FS
        )
    )


def collect(num_samples: int = 200, freq_band=(1600, 2000), doa_true: float = 2.2439,
            snr_db: float = 10.0, reflection: float = 0.0, demo=None, batch: int = 20,
            gain_std_db: float = 0.0, sway_deg: float = 0.0,
            sway_corr: float = 0.0):
    """Reference benchmark config: frame 0.4 s, kernel 20 ms, grid 64·7+1,
    bipolar (snn_localization_benchmark.py:549-583).  Forwards run batched
    (vmap over frames) — the reference records one frame at a time from the
    board; here the per-frame variation is white noise plus (optionally) the
    nonstationarity live recordings actually have: per-frame per-mic gain
    drift (``gain_std_db``, log-normal) and source sway (``sway_deg``,
    Gaussian DoA jitter re-synthesized per frame; ``sway_corr`` makes it an
    AR(1) slow drift with stationary std ``sway_deg`` — correlation time
    1/(1-corr) frames, the structure live source motion has and iid jitter
    lacks: the 25-frame median window cancels iid sway but tracks a
    drift).

    Everything past the one clean-frame (or sway-path) synthesis runs
    ON-DEVICE in a single jitted step per batch — noise, gain draw,
    forward — and only the (batch,) DoA vector comes back per step.  The
    first version of this harness downloaded the device-synthesized sway
    frames (~107 MB at 200 samples) and re-uploaded clean+noise every
    batch: host-loop transfer traffic that dominated the run."""
    import jax.numpy as jnp

    if sway_deg > 0.0 and reflection > 0.0:
        # sway frames are re-synthesized free-field; silently combining
        # them with a reverberant sigma/label would report free-field
        # results under a reverb heading
        raise ValueError("sway_deg and reflection cannot be combined: the "
                         "sway path re-synthesizes free-field frames")
    demo = demo or _make_demo(freq_band)
    sig_clean = _clean_frame(demo, freq_band, doa_true, reflection)
    sigma = float(np.sqrt(np.mean(sig_clean**2) / 10 ** (snr_db / 10)))

    sway_frames = None  # device-resident (num_samples_padded, T, M)
    if sway_deg > 0.0:
        # re-synthesize every frame at a swayed DoA (free-field only; the
        # image-source synthesis is per-DoA too expensive per frame and
        # sway is a free-field effect to first order)
        t, sig = chirp_template(freq_band, 0.4)
        rng_sway = np.random.default_rng(1)
        innov = rng_sway.standard_normal(num_samples)
        if sway_corr > 0.0:
            x = np.empty(num_samples)
            x[0] = innov[0]
            scale = np.sqrt(1.0 - sway_corr**2)
            for k in range(1, num_samples):
                x[k] = sway_corr * x[k - 1] + scale * innov[k]
            innov = x
        doas = doa_true + np.deg2rad(sway_deg) * innov
        pad = (-num_samples) % batch
        if pad:  # pad the tail batch to the jitted shape
            doas = np.concatenate([doas, np.repeat(doas[-1:], pad)])
        synth = jax.jit(jax.vmap(
            lambda d: signal_from_template(demo.geometry, t, sig, d, fs=FS)
        ))
        sway_frames = synth(jnp.asarray(doas))  # stays on device
    clean_dev = jnp.asarray(
        np.broadcast_to(sig_clean[None], (batch,) + sig_clean.shape),
        jnp.float32,
    )

    @jax.jit
    def step(clean_b, key):
        kn, kg = jax.random.split(key)
        x = clean_b.astype(jnp.float32)
        if gain_std_db > 0.0:
            g = 10.0 ** (
                gain_std_db
                * jax.random.normal(kg, (batch, 1, clean_b.shape[-1]))
                / 20.0
            )
            x = x * g
        x = x + sigma * jax.random.normal(kn, x.shape)
        doa, _ = jax.vmap(demo._forward_jit)(x)
        return doa

    key = jax.random.PRNGKey(0)
    samples = []
    t0 = time.time()
    for s0 in range(0, num_samples, batch):
        n = min(batch, num_samples - s0)
        key, sub = jax.random.split(key)
        clean_b = (clean_dev if sway_frames is None
                   else sway_frames[s0 : s0 + batch])
        doa = step(clean_b, sub)
        samples.extend(np.rad2deg(np.asarray(doa))[:n].tolist())
    wall = time.time() - t0
    return np.asarray(samples), wall


def sweep(num_samples: int = 200):
    """Dispersion stress sweep: the r4 twin
    reported 0.0°/0.0° at a single 10 dB point — repeatability, not
    comparable noise behavior.  Reporting is against the reference's
    committed live bands (windowed-median MAE 0.43–0.66°, raw robust std
    1.0–3.0°).  The SNR {−10…10} dB × reflection {0…0.7} × gain-drift
    {1, 2} dB grid was ALREADY measured in round 5 (all 0.0°/0.0°; rows
    recorded in RESULTS.md and the comment below), so the shipped
    conditions probe the knob that actually moves the statistics: source
    sway / AR(1) drift — showing at which nonstationarity level the twin
    enters the measured dispersion band."""
    demo = _make_demo((1600, 2000))
    # The r5 white-noise-only sweep measured 0.0 deg MAE / 0.0 deg
    # robust-std at EVERY condition down to -10 dB free-field and
    # reflection 0.5: a stationary source + fresh white noise per frame
    # lands every 0.4 s frame on the same grid point (the 19200-sample
    # coherent integration swamps thermal noise), so the live runs' 1-3 deg
    # robust std must come from NONSTATIONARITY, not SNR.  The sweep
    # therefore also turns the two physical nonstationarity knobs live
    # recordings have — per-frame per-mic gain drift and source sway —
    # to find where the twin enters the measured dispersion band.
    # Measured in the first two r5 passes (kept for the RESULTS table; all
    # stationary-source conditions land EVERY frame on the same grid point):
    #   snr {10,5,0,-5,-10} x refl {0,0.3,0.5,0.7}, gain drift {1,2} dB,
    #   iid sway 1 deg -> MAE 0.0 / robust-std 0.0 (raw-std <= 0.38);
    #   iid sway 2 deg -> raw-std 1.14 enters the live band, robust-std
    #   still 0.0 (the raw-peak estimator's plateau keeps >50% of frames on
    #   the modal grid point and the 25-frame median cancels iid jitter).
    # The remaining conditions probe source DRIFT (AR(1), correlation time
    # ~= the median window) and larger sway, where the windowed-median MAE
    # itself must lift off zero.
    conditions = [
        dict(snr_db=10.0, reflection=0.0, sway_deg=2.0),
        dict(snr_db=10.0, reflection=0.0, sway_deg=3.0),
        dict(snr_db=10.0, reflection=0.0, sway_deg=4.0),
        dict(snr_db=10.0, reflection=0.0, sway_deg=5.0),
        dict(snr_db=10.0, reflection=0.0, sway_deg=3.0, sway_corr=0.96),
        dict(snr_db=10.0, reflection=0.0, sway_deg=5.0, sway_corr=0.96),
    ]
    rows = []
    for cond in conditions:
        samples, wall = collect(num_samples=num_samples, demo=demo, **cond)
        stats = analyze_doa_samples(
            samples, window_length=min(25, num_samples // 2), reject_jump=20.0
        )
        rows.append({
            **cond,
            "mae_deg": round(stats["doa_mae_postprocessed"], 4),
            "robust_std_deg": round(stats["robust_std"], 4),
            "raw_std_deg": round(stats["std"], 4),
        })
        print(
            f"# snr {cond['snr_db']:+5.1f} dB  reflection "
            f"{cond.get('reflection', 0.0):.1f}  gain "
            f"{cond.get('gain_std_db', 0.0):.1f} dB  sway "
            f"{cond.get('sway_deg', 0.0):.1f} deg  corr "
            f"{cond.get('sway_corr', 0.0):.2f}  ->  MAE "
            f"{rows[-1]['mae_deg']:7.4f} deg  robust-std "
            f"{rows[-1]['robust_std_deg']:7.4f} deg  raw-std "
            f"{rows[-1]['raw_std_deg']:7.4f} deg",
            file=sys.stderr, flush=True,
        )
    report = {
        "experiment": "snn_localization_benchmark_sweep",
        "num_samples": num_samples,
        "conditions": rows,
        "reference_band": {"mae_deg": [0.43, 0.66], "robust_std_deg": [1.0, 3.0]},
    }
    print(json.dumps(report, indent=2))
    return report


def main():
    num_samples = 200 if "--quick" not in sys.argv else 25
    if "--sweep" in sys.argv:
        return sweep(num_samples)
    samples, wall = collect(num_samples=num_samples)
    outdir = os.environ.get("HM2024_BENCH_DIR", "/tmp/hm2024-benchmark")
    os.makedirs(outdir, exist_ok=True)
    fname = os.path.join(outdir, time.strftime("%Y-%m-%d=>%H:%M:%S") + ".txt")
    np.savetxt(fname, samples, fmt="%0.6f")

    stats = analyze_doa_samples(samples, window_length=min(25, num_samples // 2), reject_jump=20.0)
    report = {
        "experiment": "snn_localization_benchmark",
        "collected": {
            "file": fname,
            "num_samples": int(num_samples),
            "audio_sec_per_sec": num_samples * 0.4 / wall,
            **{k: round(v, 4) for k, v in stats.items()},
        },
    }

    # re-analysis of the reference's committed runs (parity check)
    ref = {}
    for d in REF_DATA_DIRS:
        if os.path.isdir(d):
            for f in sorted(os.listdir(d)):
                data = np.loadtxt(os.path.join(d, f))
                s = analyze_doa_samples(data)
                ref[os.path.basename(d) + "/" + f] = round(s["doa_mae_postprocessed"], 4)
    if ref:
        report["reference_committed_mae"] = ref
    print(json.dumps(report, indent=2))
    return report


if __name__ == "__main__":
    main()
