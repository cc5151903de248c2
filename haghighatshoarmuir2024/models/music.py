"""Narrowband "MUSIC" beamformer — JAX twin of micloc/music_beamformer.py.

Despite the reference class name there is no noise-subspace projection: the
algorithm is Bartlett beamforming on the dominant FFT bins
(micloc/music_beamformer.py:91-186).  Per frame: order-1 bandpass → framed FFT
→ restrict bins to the band → pick ``num_active_freq`` dominant bins by mean
power → accumulate ``mean |A(f)^H X(f)|^2`` over FFT sub-frames.

Accelerator mapping: the in-band bin set is static (computed from nfft/fs on the
host), the dominant-bin selection is a top-k gather, and the per-frequency
steering correlations collapse into one einsum across frequencies, mics, DoAs
and sub-frames.
"""
from __future__ import annotations

import functools
import numpy as np
import jax
import jax.numpy as jnp

from ..config import FS
from ..geometry import ArrayGeometry
from ..ops.filterbank import ButterworthFilterbank
from ..ops.interp import received_signal


@functools.partial(
    jax.jit,
    static_argnames=(
        "ba", "num_active_freq", "num_fft_bin", "num_fft_frames", "num_sources",
    ),
)
def _beamforming_core(
    sig_in, delays, freq_sel, bin_index, ba, num_active_freq, num_fft_bin,
    num_fft_frames, num_sources=0,
):
    """Angular power spectrum of one signal frame.

    ``num_sources == 0`` reproduces the reference algorithm exactly: Bartlett
    power on dominant bins (micloc/music_beamformer.py:91-186 — despite its
    class name the reference never forms a noise subspace).  ``num_sources >=
    1`` is the beyond-parity TRUE-MUSIC path: per dominant bin, the M×M
    narrowband covariance over FFT sub-frames is eigendecomposed, the
    ``M − num_sources`` smallest eigenvectors span the noise subspace, and the
    pseudospectrum ``1 / (a^H E_n E_n^H a)`` is accumulated across bins.

    Args:
        sig_in: (T, M).
        delays: (M, G) non-normalized steering delays.
        freq_sel: (num_sel,) in-band FFT bin frequencies (static host values).
        bin_index: (num_sel,) static in-band bin indices.
    """
    b = np.asarray(ba[0])
    a = np.asarray(ba[1])
    from ..ops.iir import iir_filter

    T, num_chan = sig_in.shape
    sig_filt = iir_filter(b, a, sig_in, axis=0, method="scan")

    sig_fft_len = num_fft_frames * num_fft_bin
    # zero-pad when shorter, truncate when longer (micloc/music_beamformer.py:136-144)
    sig_adj = jnp.zeros((sig_fft_len, num_chan), sig_filt.dtype)
    ncopy = min(T, sig_fft_len)
    sig_adj = sig_adj.at[:ncopy].set(sig_filt[:ncopy])

    # (M, F_frames, nfft)
    sig_fft = jnp.fft.fft(
        sig_adj.T.reshape(num_chan, num_fft_frames, num_fft_bin), axis=-1
    )
    sig_sel = sig_fft[:, :, bin_index]  # (M, F_frames, num_sel)

    power = jnp.mean(jnp.abs(sig_sel) ** 2, axis=(0, 1))  # (num_sel,)
    top = jnp.argsort(power)[-num_active_freq:]

    freqs = freq_sel[top]  # (K,)
    X = sig_sel[:, :, top]  # (M, F_frames, K)

    # steering vectors at the active frequencies: (K, M, G)
    arr = jnp.exp(-1j * 2 * jnp.pi * freqs[:, None, None] * delays[None, :, :])

    if num_sources > 0:
        # ---- true MUSIC: noise-subspace pseudospectrum per dominant bin
        Xk = jnp.moveaxis(X, -1, 0)  # (K, M, F_frames)
        R = jnp.einsum(
            "kmf,knf->kmn", Xk, Xk.conj(),
            precision=jax.lax.Precision.HIGHEST,
        ) / X.shape[1]
        _, evecs = jnp.linalg.eigh(R)  # ascending eigenvalues
        noise = evecs[:, :, : num_chan - num_sources]  # (K, M, M-S)
        # c[k, n, g] = E_n^H a: noise-subspace leakage of each steering vector
        c = jnp.einsum(
            "kmn,kmg->kng", noise.conj(), arr,
            precision=jax.lax.Precision.HIGHEST,
        )
        denom = jnp.sum(jnp.abs(c) ** 2, axis=1)  # (K, G)
        # steering vectors are unnormalized (|a|^2 = M); scale-free argmax
        return jnp.sum(1.0 / jnp.maximum(denom, 1e-12), axis=0)

    # sum_f mean_frames |A(f)^H X(f)|^2 -> (G,)
    Y = jnp.einsum(
        "kmg,mfk->kgf", arr.conj(), X,
        precision=jax.lax.Precision.HIGHEST,  # not TF32
    )
    return jnp.sum(jnp.mean(jnp.abs(Y) ** 2, axis=-1), axis=0)


class MUSIC:
    """Narrowband beamformer (micloc/music_beamformer.py:22-335)."""

    def __init__(
        self,
        geometry: ArrayGeometry,
        freq_range,
        doa_list,
        frame_duration: float = 0.25,
        fs: float = FS,
    ):
        # persistent compiled executables (utils/cache.py)
        from ..utils.cache import enable_persistent_compilation_cache

        enable_persistent_compilation_cache()

        freq_range = np.asarray(freq_range, dtype=np.float64)
        if len(freq_range) != 2 or freq_range[0] > freq_range[1]:
            raise ValueError(
                "frequency range should be a list containing the minimum and maximum frequency!"
            )
        self.freq_range = freq_range
        self.doa_list = np.asarray(doa_list, dtype=np.float64)
        self.frame_duration = frame_duration
        self.fs = fs
        self.filterbank = ButterworthFilterbank(freq_bands=[freq_range], order=1, fs=fs)
        self._ba = (
            tuple(self.filterbank.ba_list[0][0].tolist()),
            tuple(self.filterbank.ba_list[0][1].tolist()),
        )
        self.geometry = geometry
        # non-normalized steering delays, (M, G) (micloc/music_beamformer.py:76-81)
        self.delays = self.geometry.delays_np(self.doa_list, normalized=False).T

    @classmethod
    def from_config(cls, config, geometry: ArrayGeometry, doa_list):
        """Construct from a :class:`~haghighatshoarmuir2024.config.MUSICConfig`."""
        return cls(
            geometry=geometry,
            freq_range=config.freq_range,
            doa_list=doa_list,
            frame_duration=config.frame_duration,
            fs=config.fs,
        )

    def array_response(self, freq_list):
        """Steering tensor ``num_freq x num_mic x num_DoA``
        (micloc/music_beamformer.py:64-89)."""
        freqs = jnp.asarray(freq_list)
        d = jnp.asarray(self.delays)
        return jnp.exp(-1j * 2 * jnp.pi * freqs[:, None, None] * d[None, :, :])

    def _bins(self, num_fft_bin: int):
        """Static in-band FFT bin selection.  NOTE the reference's quirky
        frequency grid ``np.linspace(0, fs, nfft)`` includes the endpoint, so
        the bin spacing is fs/(nfft-1) (micloc/music_beamformer.py:129);
        reproduced exactly."""
        freq_vec = np.linspace(0, self.fs, num_fft_bin)
        fmin, fmax = self.freq_range
        mask = (fmin <= freq_vec) & (freq_vec <= fmax)
        return np.nonzero(mask)[0], freq_vec[mask]

    def beamforming(
        self, sig_in, num_active_freq: int, num_fft_bin: int, num_sources: int = 0
    ):
        """Angular power spectrum (num_DoA,) of one frame
        (micloc/music_beamformer.py:91-186).

        ``num_sources=0`` (default) is the reference-parity Bartlett path;
        ``num_sources>=1`` computes the true noise-subspace MUSIC
        pseudospectrum (beyond-parity option — the reference's class is named
        MUSIC but never eigendecomposes; see module docstring)."""
        sig_in = jnp.asarray(sig_in)
        min_freq_spacing = self.fs / num_fft_bin
        fmin, fmax = self.freq_range
        max_num_freq = int((fmax - fmin) / min_freq_spacing)
        if num_active_freq > max_num_freq:
            raise ValueError(
                "number of frequencies is quite large: it may happen that most of "
                "these frequencies contain noise!"
            )
        T, num_chan = sig_in.shape
        if num_chan != len(self.geometry):
            raise ValueError("input signal should be of dim `T x num_mic`!")

        if num_sources < 0 or num_sources >= len(self.geometry):
            raise ValueError(
                "num_sources must be in [0, num_mic) — 0 selects the "
                "reference-parity Bartlett path"
            )
        num_fft_frames = max(1, T // num_fft_bin)
        bin_index, freq_sel = self._bins(num_fft_bin)
        return _beamforming_core(
            sig_in,
            jnp.asarray(self.delays),
            jnp.asarray(freq_sel),
            jnp.asarray(bin_index),
            ba=self._ba,
            num_active_freq=num_active_freq,
            num_fft_bin=num_fft_bin,
            num_fft_frames=num_fft_frames,
            num_sources=num_sources,
        )

    def apply_to_signal(
        self, sig_in, num_active_freq: int, duration_overlap: float, num_fft_bin: int,
        num_sources: int = 0,
    ):
        """Sliding-frame angular power spectrum, (num_frames, num_DoA)
        (micloc/music_beamformer.py:188-261)."""
        sig_in = jnp.asarray(sig_in)
        T, num_chan = sig_in.shape
        if num_chan != len(self.geometry):
            raise ValueError(
                "number of channels in the input signal should be the same as the "
                "number of microphones!"
            )
        num_samples_frame = int(self.fs * self.frame_duration)
        num_sample_overlap = int(self.fs * duration_overlap)
        if num_sample_overlap >= num_samples_frame:
            raise ValueError(
                "duration of overlap window is larger than the duration of a single frame!"
            )
        num_samples_fresh = num_samples_frame - num_sample_overlap

        num_full = max(0, (T - num_samples_frame) // num_samples_fresh + 1)
        out = []
        if num_full > 0:
            starts = np.arange(num_full) * num_samples_fresh
            frames = jnp.stack([sig_in[s : s + num_samples_frame] for s in starts])
            bf = jax.vmap(
                lambda f: self.beamforming(f, num_active_freq, num_fft_bin, num_sources)
            )(frames)
            out.append(bf)

        start_idx = num_full * num_samples_fresh
        if (T - start_idx) > 0.5 * num_samples_frame:
            tail = self.beamforming(
                sig_in[start_idx:T], num_active_freq, num_fft_bin, num_sources
            )
            out.append(tail[None])
        return jnp.concatenate(out, axis=0) if out else jnp.zeros((0, len(self.doa_list)))

    def apply_to_template(
        self,
        template,
        num_active_freq: int,
        duration_overlap: float,
        num_fft_bin: int,
        snr_db: float,
        key=None,
        num_sources: int = 0,
    ):
        """Simulation harness + sliding-frame beamforming
        (micloc/music_beamformer.py:263-335)."""
        time_temp, sig_temp, doa_temp = template
        time_temp = np.asarray(time_temp, dtype=np.float64)
        sig_np = np.asarray(sig_temp, dtype=np.float64)
        time_in = np.arange(time_temp.min(), time_temp.max(), step=1.0 / self.fs)
        sig_in = np.interp(time_in, time_temp, sig_np)
        if np.ndim(doa_temp) == 0:
            doa_in = float(doa_temp)
        else:
            doa_in = np.interp(time_in, time_temp, np.asarray(doa_temp, dtype=np.float64))

        if key is None:
            key = jax.random.PRNGKey(np.random.randint(0, 2**31 - 1))
        sig_in_vec = received_signal(
            self.geometry,
            jnp.asarray(time_in),
            jnp.asarray(sig_in),
            jnp.asarray(doa_in),
            snr_db=snr_db,
            key=key,
            fs=self.fs,
        )
        return self.apply_to_signal(
            sig_in=sig_in_vec,
            num_active_freq=num_active_freq,
            duration_overlap=duration_overlap,
            num_fft_bin=num_fft_bin,
            num_sources=num_sources,
        )
