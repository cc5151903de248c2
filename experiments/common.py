"""Shared harness code for the experiment scripts (paper_plots equivalents).

Each reference paper_plots script re-implements template synthesis, beam
pattern computation and the Monte-Carlo accuracy sweep inline; here they are
library functions, and every script is a thin config + main() that prints a
metrics dict (and optionally saves figures when matplotlib is available).
"""
from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from typing import Optional, Tuple

import numpy as np
import jax

# HM2024_PLATFORM=cpu runs an experiment on the host instead of the GPU
# (useful for figure refreshes while the card is busy)
if os.environ.get("HM2024_PLATFORM"):
    jax.config.update("jax_platforms", os.environ["HM2024_PLATFORM"])

import jax.numpy as jnp

FS = 48_000
SPEECH_FLAC = "/root/reference/paper_plots/84-121123-0020.flac"


# ------------------------------------------------------------------ templates
def sinusoid_template(freq: float, duration: float, fs: float = FS):
    t = np.arange(0, duration, 1 / fs)
    return t, np.sin(2 * np.pi * freq * t)


def jittered_sinusoid_template(freq: float, duration: float, fs: float = FS, eps: float = 0.01, seed: int = 0):
    """Sinusoid with small random frequency jitter — stabilizes zero-crossings
    for SNN designs (paper_plots/array_resolution_linear_snn.py:173-181)."""
    rng = np.random.default_rng(seed)
    t = np.arange(0, duration, 1 / fs)
    freq_inst = freq * (1 + eps * rng.standard_normal(len(t)))
    phase = 2 * np.pi * np.cumsum(freq_inst) / fs
    return t, np.sin(phase)


def chirp_template(freq_range, duration: float, fs: float = FS):
    """Linear chirp across the band (paper_plots/target_snn_localization.py:126-134)."""
    f_min, f_max = freq_range
    t = np.arange(0, duration, 1 / fs)
    period = t[-1]
    freq_inst = f_min + (f_max - f_min) * (t % period) / period
    phase = 2 * np.pi * np.cumsum(freq_inst) / fs
    return t, np.sin(phase)


def bandlimited_noise_template(freq_range, duration: float, fs: float = FS, seed: int = 0):
    """Wideband noise filtered to the band (paper_plots/array_resolution.py:194-286)."""
    from haghighatshoarmuir2024.ops.iir import butter_bandpass, iir_filter

    rng = np.random.default_rng(seed)
    t = np.arange(0, duration, 1 / fs)
    noise = rng.standard_normal(len(t))
    b, a = butter_bandpass(2, freq_range, fs)
    sig = np.asarray(iir_filter(b, a, jnp.asarray(noise), axis=0, method="scan"))
    return t, sig


def speech_template(duration: Optional[float] = None, fs: float = FS,
                    segment: int = 0):
    """The LibriSpeech sample used by the reference speech benchmarks
    (paper_plots/84-121123-0020.flac, target_localization.py:146-152), decoded
    with the native FLAC reader; falls back to a synthetic speech-like signal
    (formant-filtered pulse train with syllabic modulation) when unavailable.

    ``segment=k`` returns the (k+1)-th highest-energy NON-OVERLAPPING window
    of ``duration`` seconds (k=0 = the reference-matching best window) — a
    different stretch of the same utterance, for cross-segment calibration
    checks.
    """
    sig = None
    if os.path.exists(SPEECH_FLAC):
        try:
            from haghighatshoarmuir2024.io.flac import read_flac

            data, file_fs = read_flac(SPEECH_FLAC)
            sig = data[:, 0] if data.ndim > 1 else data
            if file_fs != fs:
                t_old = np.arange(len(sig)) / file_fs
                t_new = np.arange(0, t_old[-1], 1 / fs)
                sig = np.interp(t_new, t_old, sig)
        except Exception:
            sig = None
    if sig is None:
        # synthetic speech-like fallback
        rng = np.random.default_rng(0)
        dur = duration or 4.0
        t = np.arange(0, dur, 1 / fs)
        f0 = 120 * (1 + 0.1 * np.sin(2 * np.pi * 2.3 * t))
        glottal = np.sin(2 * np.pi * np.cumsum(f0) / fs) ** 9
        syllable = 0.5 * (1 + np.sin(2 * np.pi * 3.1 * t + rng.uniform(0, np.pi)))
        from haghighatshoarmuir2024.ops.iir import butter_bandpass, iir_filter

        b, a = butter_bandpass(2, (300, 3400), fs)
        sig = np.asarray(iir_filter(b, a, jnp.asarray(glottal * syllable), axis=0, method="scan"))
    if duration is not None and len(sig) > int(duration * fs):
        # truncation picks the HIGHEST-ENERGY window of the sample, not the
        # head — the LibriSpeech recording opens with silence, and a silent
        # template synthesizes a zero array signal
        n = int(duration * fs)
        e = np.concatenate([[0.0], np.cumsum(np.asarray(sig, np.float64) ** 2)])
        win = e[n:] - e[:-n]
        start = 0
        for _ in range(segment + 1):
            if not np.any(np.isfinite(win)) or np.nanmax(win) <= 0:
                raise ValueError(f"sample has no {segment + 1} disjoint windows")
            start = int(np.nanargmax(win))
            # mask every window overlapping the one just taken
            lo = max(0, start - n + 1)
            win[lo : start + n] = -np.inf
        sig = sig[start : start + n]
    t = np.arange(len(sig)) / fs
    sig = sig / (np.abs(sig).max() + 1e-12)
    return t, sig


# --------------------------------------------------------------- beam pattern
def beam_pattern(bf_mat, complex_fold: bool = False):
    """Correlation matrix |bf^H bf| — the beam patterns plotted by
    paper_plots/array_resolution.py (and the 2M-real complex re-fold of
    array_resolution_snn.py:156-160).

    Fully jitted: the fold/matmul/abs run as one program and only the real
    magnitude crosses to the host."""

    @jax.jit
    def _pat(bf):
        if complex_fold:
            m = bf.shape[0] // 2
            bf = jax.lax.complex(bf[:m], bf[m:])
        return jnp.abs(bf.conj().T @ bf)

    return np.asarray(_pat(jnp.asarray(bf_mat)))


def beamwidth_3db(pattern_row: np.ndarray, doa_list: np.ndarray) -> float:
    """-3 dB width (degrees) of one beam pattern row."""
    p = pattern_row / pattern_row.max()
    above = p >= (10 ** (-3 / 20))
    frac = np.mean(above)
    return float(frac * (doa_list.max() - doa_list.min()) * 180 / np.pi)


# ------------------------------------------------------------ MC sweep driver
def snr_sweep_config():
    """The reference's standard sweep: SNR ∈ [-10, 20] dB, 11 points
    (paper_plots/target_localization.py:210-300)."""
    return np.linspace(-10, 20, 11)


def summarize(result) -> dict:
    return {
        "snr_db": [float(s) for s in result["snr_db"]],
        "mae_deg": [float(np.rad2deg(m)) for m in result["mae"]],
        "median_deg": [float(np.rad2deg(m)) for m in result["median"]],
    }


def maybe_savefig(fig, name: str):
    outdir = os.environ.get("HM2024_FIG_DIR")
    if outdir:
        os.makedirs(outdir, exist_ok=True)
        fig.savefig(os.path.join(outdir, name), bbox_inches="tight")


# ------------------------------------------------------------ figure rendering
# The reference's paper_plots scripts emit PDF figures; the twins print
# metrics and additionally render the same figure content when HM2024_FIG_DIR
# is set (headless Agg backend).
def _fig_dir():
    return os.environ.get("HM2024_FIG_DIR")


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def fig_polar_patterns(patterns: dict, doa_list, name: str):
    """Polar beam patterns, one subplot per entry (paper_plots/array_resolution*.py
    figure style): ``patterns[label] = (G,) normalized pattern row``."""
    if not _fig_dir():
        return
    plt = _plt()
    n = len(patterns)
    fig, axes = plt.subplots(
        1, n, subplot_kw={"projection": "polar"}, figsize=(4 * n, 4)
    )
    if n == 1:
        axes = [axes]
    for ax, (label, pat) in zip(axes, patterns.items()):
        pat = np.asarray(pat)
        ax.plot(doa_list, pat / max(pat.max(), 1e-12))
        ax.set_title(label, fontsize=9)
    maybe_savefig(fig, name)
    plt.close(fig)


def fig_mae_vs_snr(curves: dict, name: str, ylabel: str = "MAE [deg]"):
    """MAE-vs-SNR curves (paper_plots/target_*_localization.py figure style):
    ``curves[label] = (snr_db, mae_deg)``."""
    if not _fig_dir():
        return
    plt = _plt()
    fig, ax = plt.subplots(figsize=(6, 4))
    for label, (snr, mae) in curves.items():
        ax.semilogy(snr, mae, marker="o", label=label)
    ax.set_xlabel("SNR [dB]")
    ax.set_ylabel(ylabel)
    ax.grid(True, which="both", alpha=0.3)
    ax.legend()
    maybe_savefig(fig, name)
    plt.close(fig)


def fig_lines(x, ys: dict, name: str, xlabel: str = "", ylabel: str = "", logy=False):
    """Generic line plot: ``ys[label] = values``."""
    if not _fig_dir():
        return
    plt = _plt()
    fig, ax = plt.subplots(figsize=(6, 4))
    for label, y in ys.items():
        (ax.semilogy if logy else ax.plot)(x, y, label=label)
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    ax.grid(True, alpha=0.3)
    if len(ys) > 1:
        ax.legend()
    maybe_savefig(fig, name)
    plt.close(fig)
