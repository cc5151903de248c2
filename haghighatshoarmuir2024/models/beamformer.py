"""Hilbert (STHT) beamformer — JAX twin of micloc/beamformer.py.

Design is one batched program: the DoA grid is vmapped (in memory-bounded
chunks) through delay-interpolation → STHT → covariance, followed by a batched
``eigh`` over all covariances — replacing the reference's per-angle Python loop
with per-angle LAPACK SVDs (micloc/beamformer.py:113-192).

Quirk reproduced deliberately: in the reference's design loop the bandpass
filter output is computed but *never used* — the covariance is formed from the
unfiltered analytic signal (micloc/beamformer.py:136-150).  We skip the dead
filtering; the bandpass is applied in ``apply_to_signal`` exactly as the
reference does (micloc/beamformer.py:285-287).
"""
from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import jax
import jax.numpy as jnp

from ..config import FS
from ..geometry import ArrayGeometry
from ..ops.batching import chunked_vmap
from ..ops.iir import butter_bandpass, iir_filter
from ..ops.interp import interp_uniform, received_signal, resample_to_fs
from ..ops.linalg import generalized_top_eigvec, top_eigvec_psd
from ..ops.stht import stht, stht_kernel


@functools.partial(jax.jit, static_argnames=("fs", "stable_part", "chunk"))
def _design_covariances(sig_temp, t0, delays, kernel, fs, stable_part, chunk):
    """Batched per-DoA covariance of the analytic array signal.

    Args:
        sig_temp: (T,) template resampled to fs.
        t0: template start time.
        delays: (G, M) normalized per-DoA delays.
        kernel: (K,) STHT kernel.
        stable_part: transient samples dropped before the covariance
            (min(K, T//2), micloc/beamformer.py:141-143).

    Returns:
        (G, M, M) complex covariance tensor.
    """
    T = sig_temp.shape[0]
    t = t0 + jnp.arange(T, dtype=sig_temp.dtype) / fs

    def one(delay_m):
        tq = jnp.maximum(t[:, None] - delay_m[None, :], t0)
        X = interp_uniform(tq, sig_temp, t0, 1.0 / fs)  # (T, M)
        Xh = stht(X, kernel, axis=0)
        Xs = Xh[stable_part:]
        return jnp.einsum(
            "tm,tn->mn", Xs.conj(), Xs,
            precision=jax.lax.Precision.HIGHEST,  # not TF32
        ) / Xs.shape[0]

    return chunked_vmap(one, delays, chunk)


@functools.partial(jax.jit, static_argnames=())
def _bf_from_covs(cov):
    return top_eigvec_psd(cov)


@jax.jit
def _bf_from_covs_interference(cov):
    """Generalized-eigenproblem design with diagonal loading
    (micloc/beamformer.py:165-190)."""
    cov_sum = jnp.sum(cov, axis=0)
    n = cov_sum.shape[-1]
    loading = jnp.mean(jnp.real(jnp.diagonal(cov_sum))) / 10.0
    cov_sum = cov_sum + loading * jnp.eye(n, dtype=cov.dtype)
    return jax.vmap(lambda C: generalized_top_eigvec(C, cov_sum - C))(cov)


@functools.partial(jax.jit, static_argnames=("ba",))
def _apply_core(sig_in, bf_mat, kernel, ba):
    b, a = np.asarray(ba[0]), np.asarray(ba[1])
    sig_h = stht(sig_in, kernel, axis=0)
    sig_h = iir_filter(b, a, sig_h, axis=0, method="scan")
    return jnp.matmul(sig_h, bf_mat.conj(), precision=jax.lax.Precision.HIGHEST)


class Beamformer:
    """Super-resolution Hilbert beamformer (micloc/beamformer.py:26-292)."""

    def __init__(
        self,
        geometry: ArrayGeometry,
        kernel_duration: float,
        freq_range,
        fs: float = FS,
        design_chunk: int = 64,
    ):
        # persistent compiled executables (utils/cache.py)
        from ..utils.cache import enable_persistent_compilation_cache

        enable_persistent_compilation_cache()

        self.geometry = geometry
        self.kernel_duration = kernel_duration
        self.fs = fs
        self.design_chunk = design_chunk

        ker_len = int(fs * kernel_duration)
        self.kernel = stht_kernel(ker_len)

        freq_range = np.asarray(freq_range, dtype=np.float64)
        if len(freq_range) != 2 or freq_range[0] > freq_range[1]:
            raise ValueError(
                "freq_range should be a vector consisting of two frequencies f_low < f_high!"
            )
        self.freq_range = freq_range
        self.bandpass_filter = butter_bandpass(2, freq_range, fs)
        # hashable static form for jit
        self._ba = (
            tuple(self.bandpass_filter[0].tolist()),
            tuple(self.bandpass_filter[1].tolist()),
        )

    @classmethod
    def from_config(cls, config, geometry: ArrayGeometry):
        """Construct from a :class:`~haghighatshoarmuir2024.config.BeamformerConfig`."""
        return cls(
            geometry=geometry,
            kernel_duration=config.kernel_duration,
            freq_range=config.freq_range,
            fs=config.fs,
            design_chunk=config.design_chunk,
        )

    # ------------------------------------------------------------------ design
    def design_from_template(
        self, template: Tuple[np.ndarray, np.ndarray], doa_list, interference_removal: bool = False
    ):
        """Design beamforming vectors for each DoA in ``doa_list``.

        Returns ``(bf_mat [M x G], cov_mats [G x M x M])`` — same contract as
        micloc/beamformer.py:73-192 (which returns the covariances as a list).
        """
        time_temp, sig_temp = template
        time_temp, sig_temp = resample_to_fs(time_temp, sig_temp, self.fs)

        doa_list = np.asarray(doa_list, dtype=np.float64)
        delays = self.geometry.delays_np(doa_list, normalized=True)  # (G, M)

        T = len(sig_temp)
        stable_part = min(len(self.kernel), T // 2)

        cov = _design_covariances(
            jnp.asarray(sig_temp),
            jnp.asarray(time_temp[0]),
            jnp.asarray(delays),
            jnp.asarray(self.kernel),
            fs=float(self.fs),
            stable_part=stable_part,
            chunk=self.design_chunk,
        )
        if interference_removal:
            bf = _bf_from_covs_interference(cov)
        else:
            bf = _bf_from_covs(cov)
        return bf.T, cov

    # ------------------------------------------------------------------- apply
    def apply_to_signal(self, bf_mat, sig_in):
        """STHT → bandpass → beamforming matmul; output ``T x G`` complex
        (micloc/beamformer.py:260-292)."""
        bf_mat = jnp.asarray(bf_mat)
        sig_in = jnp.asarray(sig_in)
        num_mic, _ = bf_mat.shape
        T, num_chan = sig_in.shape
        if num_chan != num_mic:
            raise ValueError(
                f"number of channels in the input signal {num_chan} should be the same "
                f"as the number of microphones {num_mic}!"
            )
        return _apply_core(sig_in, bf_mat, jnp.asarray(self.kernel), self._ba)

    def apply_to_template(self, bf_mat, template, snr_db: float, key=None):
        """Simulation harness: delayed copies + AWGN + ``apply_to_signal``
        (micloc/beamformer.py:194-258).  ``key`` is the noise PRNG key (the
        reference uses the global NumPy RNG)."""
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
        return self.apply_to_signal(bf_mat=bf_mat, sig_in=sig_in_vec)
