"""Reduced internal-rate mode — measured verdict:
**24 kHz is transparent, 12 kHz is refuted.**

The hypothesis: since the u4@12k WIRE is in-band transparent for the
1.6–2.6 kHz bands (experiments/wire_accuracy.py), running the whole pipeline
(encode → RZCC → LIF) at fs_internal ∈ {12k, 24k} should buy 2–4× fewer
sequential LIF steps at unchanged accuracy.

Measured (25 trials × {0, 10} dB, tone target, folded error):

| fs    | matched MAE 0/10 dB | parity-peak MAE 0/10 dB | max delay | τ      |
|-------|---------------------|-------------------------|-----------|--------|
| 48 k  | 0.82° / 0.90°       | 11.3° / 14.0°           | 12.7 smp  | 4.4 smp|
| 24 k  | 0.88° / 0.84°       |  8.9° /  9.6°           |  6.4 smp  | 2.2 smp|
| 12 k  | 2.10° / 1.59°       | 17.5° / 27.3°           |  3.2 smp  | 1.1 smp|

So the deviation gate ("within MC noise at ≥ 0 dB") PASSES at 24 kHz — the
matched estimator calibrates at the same rate it evaluates at, so the
profile warp moves but the accuracy doesn't, and even the reference-parity
peak estimator improves (fewer suppression ties).  24 kHz is shipped as a
documented-deviation mode (`Demo(fs=24_000)`; 48 kHz field input decimates
with `ops.resample.decimate_fir(x, factor=2)` — same Kaiser prototype as
the wire path; see the throughput section this file prints and RESULTS.md).  At 12 kHz two structural effects do bite, which is why the
4× variant stays refuted:

1. **Sub-sample aperture.**  The 7-mic r=4.5 cm array's maximum inter-mic
   delay is 2r/c = 265 µs — 12.7 samples at 48 kHz but only 3.2 at 12 kHz
   (adjacent-mic baselines are 2–6× shorter still).  The RZCC encoder
   quantizes zero-crossing TIMES to the sample grid; DoA information *is*
   those relative timings.  The wire path survives 12 kHz because the
   bandlimited waveform is interpolated back to 48 kHz on-device BEFORE
   spike encoding (ops/resample.py) — encoding on the coarse grid discards
   the sub-sample timing unrecoverably.

2. **Degenerate integer time constants.**  The reference couples the LIF to
   the carrier: τ = 1/(2π·f_mid) ≈ 91 µs (micloc/xylo_snn_localization.py:
   117-122) = 4.4 samples at 48 kHz → dash=2, still 2.2 → dash=1 at 24 kHz,
   but 1.1 samples at 12 kHz — the bitshift decay quantizes toward dash=0,
   i.e. full decay per step: the integrator degenerates to a pass-through.
"""
import json
import sys

import numpy as np
import jax
import jax.numpy as jnp

sys.path.insert(0, ".")
from experiments.common import FS as FS_REF  # noqa: E402

from haghighatshoarmuir2024 import CenterCircularArray  # noqa: E402
from haghighatshoarmuir2024.models.xylo import Demo  # noqa: E402
from haghighatshoarmuir2024.ops.interp import signal_from_template  # noqa: E402

SOUND_SPEED = 340.0


def run_rate(fs: int, num_sims: int, snr_db_vec, num_grid: int = 113, seed: int = 0,
             freq_band=(1600, 1900)):
    geometry = CenterCircularArray(radius=4.5e-2, num_mic=7)
    demo = Demo(
        geometry=geometry,
        freq_bands=[list(freq_band)],
        doa_list=np.linspace(-np.pi, np.pi, num_grid),
        recording_duration=0.25,
        kernel_duration=10e-3,
        bipolar_spikes=True,
        fs=fs,
    )
    demo.calibrate_profiles()
    f_tone = float(np.mean(freq_band))
    t = np.arange(0, 0.25, 1 / fs)
    sig = np.sin(2 * np.pi * f_tone * t).astype(np.float32)
    rng = np.random.default_rng(seed)
    grid = np.asarray(demo.doa_list)

    fwd = jax.jit(jax.vmap(demo._forward_matched_jit))
    out = {"fs": fs, "snr_db": list(snr_db_vec)}
    mae_m, mae_p = [], []
    for snr_db in snr_db_vec:
        doas = rng.uniform(-np.pi, np.pi, size=num_sims)
        frames = np.asarray(
            jax.jit(
                jax.vmap(lambda d: signal_from_template(geometry, t, sig, d, fs=fs))
            )(jnp.asarray(doas))
        ).astype(np.float32)
        p_sig = frames.var(axis=(1, 2), keepdims=True)
        sigma = np.sqrt(p_sig / 10 ** (snr_db / 10))
        frames = frames + sigma * rng.standard_normal(frames.shape).astype(np.float32)
        d_est, rate = fwd(jnp.asarray(frames))
        est_m = np.asarray(d_est)
        est_p = grid[np.argmax(np.asarray(rate), axis=-1)]
        err = lambda e: float(
            np.mean(np.degrees(np.arcsin(np.abs(np.sin(e - doas)))))
        )
        mae_m.append(err(est_m))
        mae_p.append(err(est_p))
    out["matched_mae_deg"] = mae_m
    out["peak_mae_deg"] = mae_p
    # the aperture arithmetic that explains the numbers
    r = 4.5e-2
    out["max_delay_samples"] = 2 * r / SOUND_SPEED * fs
    out["tau_samples"] = fs / (2 * np.pi * f_tone)

    # flagship-style throughput at this rate: 96-frame matched forward,
    # pipelined (block once after all dispatches — bench.py's convention)
    import time

    B = 96
    doas = np.linspace(-np.pi, np.pi, B, endpoint=False)
    frames = np.asarray(
        jax.jit(
            jax.vmap(lambda d: signal_from_template(geometry, t, sig, d, fs=fs))
        )(jnp.asarray(doas))
    ).astype(np.float32)
    frames_j = jnp.asarray(frames)
    # the flagship BATCH program (fused time-major kernels), not the
    # vmapped single-frame form — the first run of this section timed the
    # latter and read 53 ms where the flagship does 7.4 (wrong program,
    # right ratios)
    fwd_b = demo._forward_batch_matched_jit
    jax.block_until_ready(fwd_b(frames_j))
    reps = 30
    t0 = time.perf_counter()
    res = None
    for _ in range(reps):
        res = fwd_b(frames_j)
    jax.block_until_ready(res)
    dt = (time.perf_counter() - t0) / reps
    out["forward_ms_b96"] = dt * 1e3
    out["audio_sec_per_sec"] = B * 0.25 / dt
    return out


def main():
    num_sims = 25 if "--quick" not in sys.argv else 8
    snrs = [0.0, 10.0]
    # --band=hi gates the mode on the HIGHEST reference band (2300-2600 Hz),
    # where tau is smallest (1.56 samples at 24 kHz) — the worst case for
    # the integer time-constant quantization (ROADMAP r5 item b)
    band = (2300, 2600) if "--band=hi" in sys.argv else (1600, 1900)
    rates = (48_000, 24_000) if band != (1600, 1900) else (48_000, 24_000, 12_000)
    rows = [run_rate(fs, num_sims, snrs, freq_band=band) for fs in rates]
    print(json.dumps({"experiment": "reduced_rate_refutation",
                      "band": list(band),
                      "num_sims": num_sims, "rows": rows}, indent=2))
    ref = rows[0]
    print("\n# fs    max_delay(smp)  tau(smp)  MAE@0dB  MAE@10dB  b96-fwd(ms)  audio-s/s",
          file=sys.stderr)
    for r in rows:
        print(
            f"# {r['fs']:6d}  {r['max_delay_samples']:8.1f}  "
            f"{r['tau_samples']:8.1f}  {r['matched_mae_deg'][0]:7.2f}  "
            f"{r['matched_mae_deg'][1]:8.2f}  {r['forward_ms_b96']:9.2f}  "
            f"{r['audio_sec_per_sec']:9.0f}",
            file=sys.stderr,
        )
    # deviation gate: matched MAE within MC noise of 48 kHz
    # at >= 0 dB.  MC noise for 25 folded-error trials at this accuracy is
    # ~0.2-0.3 deg run-to-run; gate at 0.4 deg.
    for r in rows[1:]:
        worst = max(abs(a - b) for a, b in zip(r["matched_mae_deg"],
                                               ref["matched_mae_deg"]))
        verdict = "TRANSPARENT (gate passed)" if worst <= 0.4 else "REFUTED"
        print(f"# fs={r['fs']}: matched-MAE delta vs 48k up to {worst:.2f} deg "
              f"-> {verdict}", file=sys.stderr)
    print("# see module docstring: 24 kHz ships as a documented-deviation "
          "mode; 12 kHz stays refuted (sub-sample aperture + degenerate "
          "integer taus)", file=sys.stderr)


if __name__ == "__main__":
    main()
