"""Instantaneous-phase analyses — numeric twins of the small paper figures
paper_plots/phase_plot.py (phase of overlapping exponentials),
random_phase.py (wideband phase via Hilbert) and chirp_phase_plot.py
(chirp instantaneous frequency recovery)."""
import json

import numpy as np
import jax
import jax.numpy as jnp

from common import FS, chirp_template, fig_lines

from haghighatshoarmuir2024.ops.stht import stht, stht_kernel
from haghighatshoarmuir2024.utils import to_numpy


def _analytic(sig: np.ndarray, kernel_duration: float = 10e-3):
    ker = stht_kernel(int(FS * kernel_duration))
    a = to_numpy(
        jax.jit(lambda s: jnp.squeeze(stht(s, jnp.asarray(ker), axis=0)))(
            jnp.asarray(sig[:, None], dtype=jnp.float32)
        )
    )
    return a, len(ker)


def overlapping_exponentials():
    """Phase of a two-tone sum: instantaneous frequency stays inside the two
    tone frequencies and is pulled toward the stronger component."""
    t = np.arange(0, 0.25, 1 / FS)
    f1, f2 = 1700.0, 1900.0
    sig = np.sin(2 * np.pi * f1 * t) + 0.5 * np.sin(2 * np.pi * f2 * t)
    a, K = _analytic(sig)
    phase = np.unwrap(np.angle(a[2 * K : -2 * K]))
    f_inst = np.diff(phase) / (2 * np.pi) * FS
    # paper_plots/phase_plot.py figure: instantaneous frequency of the
    # two-tone sum vs the component frequencies
    ts = t[2 * K : -2 * K][:-1][: len(f_inst)]
    fig_lines(
        ts,
        {"f_inst": f_inst, f"f1={f1:.0f}": np.full_like(f_inst, f1),
         f"f2={f2:.0f}": np.full_like(f_inst, f2)},
        "phase_plot.pdf", xlabel="t [s]", ylabel="inst. frequency [Hz]",
    )
    return {
        "f_inst_mean": float(f_inst.mean()),
        "f_inst_in_band_frac": float(np.mean((f_inst > f1 - 150) & (f_inst < f2 + 150))),
    }


def random_wideband_phase(seed: int = 0):
    """Bandlimited noise: the phase increments concentrate around the band
    center (the reference's random_phase.py illustration)."""
    from haghighatshoarmuir2024.ops.iir import butter_bandpass, iir_filter

    rng = np.random.default_rng(seed)
    t = np.arange(0, 0.25, 1 / FS)
    b, a = butter_bandpass(2, (1600, 1900), FS)
    sig = np.asarray(iir_filter(b, a, jnp.asarray(rng.standard_normal(len(t))), axis=0, method="scan"))
    an, K = _analytic(sig)
    phase = np.unwrap(np.angle(an[2 * K : -2 * K]))
    f_inst = np.diff(phase) / (2 * np.pi) * FS
    # paper_plots/random_phase.py figure: wideband instantaneous frequency
    # concentrating around the band center
    ts = t[2 * K : -2 * K][:-1][: len(f_inst)]
    fig_lines(ts, {"f_inst (1600-1900 Hz noise)": f_inst}, "random_phase.pdf",
              xlabel="t [s]", ylabel="inst. frequency [Hz]")
    return {
        "f_inst_median": float(np.median(f_inst)),
        "f_inst_iqr": float(np.percentile(f_inst, 75) - np.percentile(f_inst, 25)),
    }


def chirp_phase():
    """Chirp: recovered instantaneous frequency tracks the programmed sweep."""
    t, sig = chirp_template((1600.0, 2000.0), 0.25)
    a, K = _analytic(sig)
    sl = slice(2 * K, len(t) - 2 * K)
    phase = np.unwrap(np.angle(a[sl]))
    f_inst = np.diff(phase) / (2 * np.pi) * FS
    f_true = 1600.0 + (2000.0 - 1600.0) * (t[sl][:-1] / t[-1])
    err = np.abs(f_inst - f_true)
    # paper_plots/chirp_phase_plot.py figure: recovered vs programmed sweep
    fig_lines(t[sl][:-1], {"recovered f_inst": f_inst, "programmed sweep": f_true},
              "chirp_phase_plot.pdf", xlabel="t [s]", ylabel="frequency [Hz]")
    return {"freq_track_mae_hz": float(err.mean()), "freq_track_p95_hz": float(np.percentile(err, 95))}


def main():
    out = {
        "overlapping_exponentials": overlapping_exponentials(),
        "random_wideband_phase": random_wideband_phase(),
        "chirp_phase": chirp_phase(),
    }
    print(json.dumps({"experiment": "phase_analysis", "results": out}, indent=2))
    return out


if __name__ == "__main__":
    main()
