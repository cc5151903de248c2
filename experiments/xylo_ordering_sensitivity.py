"""Bound the XyloSim step-ordering caveat by measurement.

rockpool/xylosim is not installable here, so the integer LIF's exact step
convention (micloc/xylo_snn_localization.py:286-313 delegates it to
``XyloSim.from_config``) cannot be replayed bit-for-bit.  This harness runs
the quantized localization Monte-Carlo under EVERY plausible convention —
{decay_first, integrate_first} x {subtract, zero} (see
models/xylo/sim._sim_hidden) — on identical spike rasters and reports the
DoA-statistic delta per variant, turning "unverifiable ordering" into
"ordering ambiguity costs <= X deg MAE".

Usage:
    python experiments/xylo_ordering_sensitivity.py [--sims 20] [--speech]
        [--grid 225] [--snrs -10 0 10]

Writes a table to stdout and (with --json) RESULTS-ready JSON.
"""
from __future__ import annotations

import argparse
import itertools
import json
import sys
import time

import numpy as np
import jax
import jax.numpy as jnp

sys.path.insert(0, ".")
from experiments.common import speech_template  # noqa: E402

from haghighatshoarmuir2024 import CenterCircularArray  # noqa: E402
from haghighatshoarmuir2024.models.xylo import Demo  # noqa: E402
from haghighatshoarmuir2024.models.xylo.sim import sim_hidden_batch  # noqa: E402
from haghighatshoarmuir2024.ops.interp import signal_from_template  # noqa: E402

FS = 48_000
VARIANTS = list(itertools.product(("decay_first", "integrate_first"), ("subtract", "zero")))


def angular_err_deg(est, true):
    return np.rad2deg(np.abs(np.arcsin(np.abs(np.sin(np.asarray(est) - np.asarray(true))))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sims", type=int, default=20, help="MC trials per SNR")
    ap.add_argument("--grid", type=int, default=225)
    ap.add_argument("--snrs", type=float, nargs="+", default=[-10.0, 0.0, 10.0])
    ap.add_argument("--speech", action="store_true", help="speech target instead of tone")
    ap.add_argument("--duration", type=float, default=0.25)
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args()

    geometry = CenterCircularArray(radius=4.5e-2, num_mic=7)
    demo = Demo(
        geometry=geometry,
        freq_bands=[[1600, 1900]],
        doa_list=np.linspace(-np.pi, np.pi, args.grid),
        recording_duration=args.duration,
        kernel_duration=10e-3,
        bipolar_spikes=True,
        fs=FS,
    )
    G = args.grid
    cfg = demo.xylo_config

    t = np.arange(0, args.duration, 1 / FS)
    if args.speech:
        t_sp, sig_sp = speech_template(duration=args.duration)
        template = np.asarray(sig_sp, np.float32)
    else:
        template = np.sin(2 * np.pi * 1750 * t).astype(np.float32)

    rng = np.random.default_rng(0)
    doa_true = rng.uniform(-np.pi, np.pi, size=args.sims).astype(np.float64)

    # one shared encode per (trial, snr): every variant sees IDENTICAL input
    # spike rasters, so the deltas below are purely the step convention's
    encode = jax.jit(jax.vmap(demo.spike_encoding))

    def fold_rate(spk):  # (B, T, H) -> (B, G)
        r = spk.mean(axis=1)  # (B, H)
        return r.reshape(r.shape[0], -1, G).mean(axis=1)

    results = {f"{o}/{rs}": {} for o, rs in VARIANTS}
    raster_delta = {}
    for snr_db in args.snrs:
        frames = []
        for i, d in enumerate(doa_true):
            s = np.asarray(signal_from_template(geometry, t, template, float(d), fs=FS))
            p_sig = np.mean(s**2)
            noise = rng.standard_normal(s.shape).astype(np.float32)
            noise *= np.sqrt(p_sig / np.mean(noise**2) * 10 ** (-snr_db / 10))
            frames.append(s + noise)
        frames = jnp.asarray(np.stack(frames), jnp.float32)
        spikes_in = np.asarray(encode(frames), np.int8)  # (B, T, N_in)

        base_raster = None
        for ordering, reset in VARIANTS:
            name = f"{ordering}/{reset}"
            t0 = time.time()
            spk = np.asarray(
                sim_hidden_batch(cfg, spikes_in, ordering=ordering, reset=reset)
            )
            rate = fold_rate(spk)
            est = np.asarray(demo.doa_list)[np.argmax(rate, axis=-1)]
            mae = float(np.mean(angular_err_deg(est, doa_true)))
            med = float(np.median(angular_err_deg(est, doa_true)))
            results[name][snr_db] = (mae, med)
            if ordering == "decay_first" and reset == "subtract":
                base_raster = spk
            else:
                raster_delta[(name, snr_db)] = float(
                    np.mean(spk != base_raster)
                )
            print(
                f"# snr {snr_db:+.0f} dB  {name:<26s} MAE {mae:6.2f} deg  "
                f"median {med:6.2f} deg  ({time.time()-t0:.1f}s)",
                file=sys.stderr,
            )

    target = "speech" if args.speech else "tone"
    print(f"\n== XyloSim step-ordering sensitivity ({target}, {args.sims} trials/SNR, grid {G}) ==")
    hdr = "variant".ljust(28) + "".join(f"  MAE@{s:+.0f}dB" for s in args.snrs)
    print(hdr)
    base = results["decay_first/subtract"]
    for name, per_snr in results.items():
        row = name.ljust(28)
        for s in args.snrs:
            row += f"  {per_snr[s][0]:8.2f}"
        print(row)
    print("\ndelta vs default (decay_first/subtract):")
    worst = 0.0
    for name, per_snr in results.items():
        if name == "decay_first/subtract":
            continue
        deltas = [abs(per_snr[s][0] - base[s][0]) for s in args.snrs]
        worst = max(worst, max(deltas))
        print(
            name.ljust(28)
            + "".join(f"  {d:+8.2f}" for d in [per_snr[s][0] - base[s][0] for s in args.snrs])
            + f"   raster diff {np.mean([raster_delta[(name, s)] for s in args.snrs]):.4f}"
        )
    print(f"\nordering ambiguity costs <= {worst:.2f} deg MAE on this MC")
    if args.json:
        print(json.dumps({
            "target": target, "sims": args.sims, "grid": G, "snrs": args.snrs,
            "mae_by_variant": {k: {str(s): v[s] for s in args.snrs} for k, v in results.items()},
            "worst_delta_deg": worst,
        }))


if __name__ == "__main__":
    main()
