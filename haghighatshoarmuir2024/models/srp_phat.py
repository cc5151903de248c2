"""SRP-PHAT baseline: classical GCC-PHAT steered-response-power DoA.

BEYOND-PARITY model family: the reference ships Hilbert / SNN / MUSIC
estimators only (micloc/{beamformer,snn_beamformer,music_beamformer}.py);
a phase-transform TDoA baseline is the standard classical comparison point
for microphone-array localization (see PAPERS.md: GCC-PHAT close-microphone
study arXiv:1811.11787, SVD-PHAT arXiv:1811.11785).  Including it lets a
user benchmark the SNN pipelines against the textbook method inside one
framework, on the same geometry/propagation/SNR conventions.

Accelerator-first formulation: instead of per-pair IFFTs + fractional-delay peak
interpolation (the CPU-classical route), the steered power is evaluated
directly in the frequency domain as ONE complex contraction

    P(theta) = sum_{pairs p} sum_{bins f} Re[ R_p(f) * exp(+j 2 pi f
               (d_i(theta) - d_j(theta))) ]

i.e. a (pairs*bins) x grid matmul, batched over frames.  The
whitened cross-spectra R_p(f) = X_i X_j^* / |X_i X_j^*| use only in-band
bins (PHAT over the band of interest).  Complex math stays inside jit.

Synthesis convention: the steering is PHYSICAL — like MUSIC's, it matches
audio propagated as ``s(t - delay)`` (``signal_from_template(...,
delay_sign=-1)`` or ``received_signal``); the xylo/Hilbert harnesses' plus
convention mirrors every SRP estimate by 180 deg (measured — the folded
error metric hides it).  See ops/interp.signal_from_template.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..config import FS


class SRPPHAT:
    """GCC-PHAT steered-response-power localizer on a DoA grid.

    Args:
      geometry: ArrayGeometry (time-of-arrival provider, ``delays_np``).
      freq_range: [f_lo, f_hi] band used for the phase transform.
      doa_list: grid of candidate DoAs (radians).
      fs: sample rate.
      frame_duration: analysis frame length in seconds (sets the FFT size;
        one frame = one rFFT, no overlap — matching the reference pipelines'
        one-frame-one-estimate convention).
    """

    def __init__(self, geometry, freq_range, doa_list,
                 fs: float = FS, frame_duration: float = 0.25):
        # persistent compiled executables (utils/cache.py)
        from ..utils.cache import enable_persistent_compilation_cache

        enable_persistent_compilation_cache()

        self.geometry = geometry
        self.freq_range = [float(freq_range[0]), float(freq_range[1])]
        if self.freq_range[0] >= self.freq_range[1]:
            raise ValueError("freq_range must be increasing")
        self.doa_list = np.asarray(doa_list, np.float64)
        self.fs = float(fs)
        self.T = int(round(frame_duration * fs))
        M = len(geometry)

        # mic pairs (i < j), excluding the reference's duplicated endpoint
        # mic pairing with itself (identical delays carry no TDoA info but
        # are harmless; keep all i<j pairs for simplicity)
        self._pairs = [(i, j) for i in range(M) for j in range(i + 1, M)]

        # in-band rFFT bins of a T-sample frame
        freqs = np.fft.rfftfreq(self.T, 1.0 / self.fs)
        self._bins = np.flatnonzero(
            (freqs >= self.freq_range[0]) & (freqs <= self.freq_range[1])
        )
        if self._bins.size == 0:
            raise ValueError("freq_range contains no FFT bins at this frame size")
        fband = freqs[self._bins]  # (F,)

        # steering phases: (P, F, G) complex64 — exp(+j 2 pi f tau_p(theta))
        d = geometry.delays_np(self.doa_list, normalized=True).T  # (M, G)
        tau = np.stack([d[i] - d[j] for (i, j) in self._pairs])  # (P, G)
        phase = 2.0 * np.pi * fband[None, :, None] * tau[:, None, :]
        # Steering stored as real cos/sin planes, NOT complex64, so no complex
        # array crosses the host/device boundary.  The complex contraction Re{R^T S} = Re(R)·cos − Im(R)·sin runs as two
        # float32 matmuls; complex math stays strictly inside jit.
        G = len(self.doa_list)
        self._steer_re = np.cos(phase).astype(np.float32).reshape(-1, G)
        self._steer_im = np.sin(phase).astype(np.float32).reshape(-1, G)
        self._pair_i = np.array([p[0] for p in self._pairs])
        self._pair_j = np.array([p[1] for p in self._pairs])

    # ------------------------------------------------------------------ jits
    def _power_impl(self, sig_in, steer_re, steer_im):
        """(T, M) float32 -> (G,) steered response power."""
        X = jnp.fft.rfft(sig_in, axis=0)  # (Tf, M) complex
        Xb = X[jnp.asarray(self._bins)]  # (F, M)
        Xi = Xb[:, jnp.asarray(self._pair_i)]  # (F, P)
        Xj = Xb[:, jnp.asarray(self._pair_j)]
        cross = Xi * jnp.conj(Xj)  # (F, P)
        R = cross / jnp.maximum(jnp.abs(cross), 1e-12)  # PHAT whitening
        Rf = jnp.transpose(R).reshape(-1)  # (P*F,)
        # Re{R^T steer} as two real matmuls (complex stays inside jit)
        P = (
            jnp.matmul(jnp.real(Rf)[None, :], steer_re,
                       precision=jax.lax.Precision.HIGHEST)
            - jnp.matmul(jnp.imag(Rf)[None, :], steer_im,
                         precision=jax.lax.Precision.HIGHEST)
        )[0]
        return P / len(self._pairs)

    @property
    def _power_jit(self):
        if not hasattr(self, "_pj"):
            self._pj = jax.jit(self._power_impl)
            self._pj_batch = jax.jit(
                jax.vmap(self._power_impl, in_axes=(0, None, None))
            )
        return self._pj, self._pj_batch

    def apply_to_signal(self, sig_in):
        """(T, M) or (B, T, M) audio -> (G,) / (B, G) angular power."""
        sig_in = jnp.asarray(sig_in, jnp.float32)
        single, batch = self._power_jit
        if sig_in.ndim == 3:
            return batch(sig_in, self._steer_re, self._steer_im)
        return single(sig_in, self._steer_re, self._steer_im)

    def estimate(self, sig_in):
        """DoA estimate(s): argmax of the steered power."""
        p = self.apply_to_signal(sig_in)
        return jnp.asarray(self.doa_list)[jnp.argmax(p, axis=-1)]

    def apply_to_template(self, template, snr_db: float, key=None):
        """Same contract as the other families: (t, sig, doa) template +
        white noise at ``snr_db`` -> (G,) angular power."""
        from ..ops.interp import signal_from_template

        t, sig, doa = template
        sig_in = signal_from_template(
            self.geometry, jnp.asarray(t), jnp.asarray(sig, jnp.float32),
            jnp.asarray(doa), fs=self.fs,
        )
        if key is not None:
            pow_sig = jnp.mean(sig_in**2)
            sigma = jnp.sqrt(pow_sig / 10.0 ** (snr_db / 10.0))
            sig_in = sig_in + sigma * jax.random.normal(key, sig_in.shape)
        return self.apply_to_signal(sig_in)
