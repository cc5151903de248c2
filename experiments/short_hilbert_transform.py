"""STHT quality analysis — twin of paper_plots/short_hilbert_transform.py and
the exploratory checks in tests/hilbert_snn.py:242-326 (kernel frequency
response, STHT-vs-full-Hilbert error, RZCC spike timing illustration).
Prints numeric metrics instead of figures."""
import json

import numpy as np
import jax.numpy as jnp

from common import FS, _fig_dir, _plt, maybe_savefig

from haghighatshoarmuir2024.ops.stht import stht, stht_kernel
from haghighatshoarmuir2024.ops.spikes import rzcc_encode


def kernel_frequency_response(kernel_duration: float):
    """In-band deviation of the STHT kernel from the ideal Hilbert response
    (|H(f)| = 1, phase -90 deg)."""
    ker = stht_kernel(int(FS * kernel_duration))
    nfft = 1 << 16
    H = np.fft.rfft(ker, nfft)
    freqs = np.fft.rfftfreq(nfft, 1 / FS)
    band = (freqs >= 1000) & (freqs <= 4000)
    mag_err = np.abs(np.abs(H[band]) - 1.0)
    return {
        "mag_err_max_inband": float(mag_err.max()),
        "mag_err_mean_inband": float(mag_err.mean()),
    }


def stht_vs_full_hilbert(kernel_duration: float, freq: float = 2000.0):
    """Relative error of the STHT analytic signal vs scipy's full-signal
    Hilbert transform (steady-state region)."""
    from scipy.signal import hilbert

    t = np.arange(0, 0.25, 1 / FS)
    sig = np.sin(2 * np.pi * freq * t)
    ker = stht_kernel(int(FS * kernel_duration))
    a_full = hilbert(sig)
    from haghighatshoarmuir2024.utils import to_numpy
    import jax

    # complex ops run inside one compiled program; only real parts come back
    a_stht = to_numpy(
        jax.jit(lambda s: jnp.squeeze(stht(s, jnp.asarray(ker), axis=0)))(
            jnp.asarray(sig[:, None])
        )
    )
    K = len(ker)
    # compare the steady-state interior; the STHT has K/2 group delay
    sl = slice(2 * K, len(t) - 2 * K)
    err = np.abs(a_stht[sl] - a_full[sl]) / np.abs(a_full[sl]).mean()
    return {"rel_err_mean": float(err.mean()), "rel_err_max": float(err.max())}


def rzcc_spike_timing(freq: float = 2000.0):
    """RZCC spikes land at the zero crossings of the underlying tone
    (paper_plots/rzcc_plots.py illustration, numerically)."""
    t = np.arange(0, 0.05, 1 / FS)
    sig = np.sin(2 * np.pi * freq * t)
    rw = int(FS / freq) // 2
    spikes = np.asarray(rzcc_encode(jnp.asarray(sig[:, None]), rw, bipolar=True))[:, 0]
    pos = np.nonzero(spikes == 1)[0]
    neg = np.nonzero(spikes == -1)[0]
    # paper_plots/rzcc_plots.py figure: the tone with its bipolar RZCC spike
    # train (stems at the zero crossings)
    if _fig_dir():
        plt = _plt()
        fig, ax = plt.subplots(figsize=(7, 3))
        n = int(FS / freq * 8)  # ~8 periods
        ax.plot(t[:n] * 1e3, sig[:n], lw=1, label=f"{freq:.0f} Hz tone")
        for idx, linefmt, markerfmt, lbl in (
            (pos, "g-", "g^", "+1 spikes"),
            (neg, "r-", "rv", "-1 spikes"),
        ):
            sel = idx[idx < n]
            ax.stem(
                t[sel] * 1e3, spikes[sel] * 0.9,
                linefmt=linefmt, markerfmt=markerfmt, basefmt=" ", label=lbl,
            )
        ax.set_xlabel("t [ms]")
        ax.legend(loc="upper right", fontsize=8)
        maybe_savefig(fig, "rzcc_plots.pdf")
        plt.close(fig)
    # +1 spikes (peaks of cumsum) sit at downward zero crossings of sin:
    # phase ~ pi mod 2pi -> t*freq mod 1 ~ 0.5
    phases = (t[pos] * freq) % 1.0
    return {
        "num_pos_spikes": int(len(pos)),
        "phase_mean": float(phases[2:].mean()),
        "phase_std": float(phases[2:].std()),
    }


def main():
    # paper_plots/short_hilbert_transform.py figure: |H(f)| of the STHT
    # kernel per duration vs the ideal Hilbert response
    if _fig_dir():
        plt = _plt()
        fig, ax = plt.subplots(figsize=(6, 4))
        nfft = 1 << 16
        freqs = np.fft.rfftfreq(nfft, 1 / FS)
        for d in (5e-3, 10e-3, 20e-3):
            ker = stht_kernel(int(FS * d))
            H = np.fft.rfft(ker, nfft)
            ax.plot(freqs / 1e3, np.abs(H), lw=1, label=f"{d*1e3:.0f} ms kernel")
        ax.axhline(1.0, color="k", ls="--", lw=0.8, label="ideal Hilbert")
        ax.set_xlim(0, 10)
        ax.set_xlabel("frequency [kHz]")
        ax.set_ylabel("|H(f)|")
        ax.legend(fontsize=8)
        maybe_savefig(fig, "short_hilbert_transform.pdf")
        plt.close(fig)
    out = {
        "kernel_response": {
            f"{int(d*1e3)}ms": kernel_frequency_response(d) for d in (5e-3, 10e-3, 20e-3)
        },
        "stht_vs_hilbert": {
            f"{int(d*1e3)}ms": stht_vs_full_hilbert(d) for d in (5e-3, 10e-3, 20e-3)
        },
        "rzcc_timing": rzcc_spike_timing(),
    }
    print(json.dumps({"experiment": "short_hilbert_transform", "results": out}, indent=2))
    return out


if __name__ == "__main__":
    main()
