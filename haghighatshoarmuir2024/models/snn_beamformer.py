"""Float32-level SNN Hilbert beamformer — JAX twin of micloc/snn_beamformer.py.

Per-DoA design chain (delay-interp → STHT → bandpass → real-stack → RZCC spike
encoding → LIF filtering → covariance) is one vmapped jitted program over the
DoA grid; the per-DoA eigenproblem (bipolar complex fold, or the DC-removed
conditional singular vector for unipolar spikes) is batched over the grid.
The reference runs this serially per angle with scipy/LAPACK
(micloc/snn_beamformer.py:82-211).
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
from ..ops.lif import lif_filter, lif_impulse_response
from ..ops.linalg import (
    dc_removed_sing_vec,
    fold_complex_cov,
    top_eigvec_psd,
    unfold_complex_vec,
)
from ..ops.spikes import ZeroCrossingSpikeEncoder, rzcc_encode
from ..ops.stht import stht, stht_kernel


@functools.partial(
    jax.jit,
    static_argnames=("ba", "fs", "robust_width", "bipolar", "chunk"),
)
def _design_covariances(
    sig_temp, t0, delays, kernel, neuron_ir, ba, fs, robust_width, bipolar, chunk
):
    """(G, 2M, 2M) covariance tensor of the LIF-filtered spike trains."""
    b = np.asarray(ba[0])
    a = np.asarray(ba[1])
    T = sig_temp.shape[0]
    t = t0 + jnp.arange(T, dtype=sig_temp.dtype) / fs

    def one(delay_m):
        d = delay_m - jnp.min(delay_m)
        tq = jnp.maximum(t[:, None] - d[None, :], t0)
        X = interp_uniform(tq, sig_temp, t0, 1.0 / fs)  # (T, M)
        Xh = stht(X, kernel, axis=0)
        Xh = iir_filter(b, a, Xh, axis=0, method="scan")
        Xr = jnp.concatenate([Xh.real, Xh.imag], axis=1)  # (T, 2M)
        spikes = rzcc_encode(Xr, robust_width, bipolar)
        vmem = lif_filter(spikes, neuron_ir)
        stable = vmem.shape[0] // 4
        vs = vmem[stable:]
        return jnp.einsum(
            "tm,tn->mn", vs, vs,
            precision=jax.lax.Precision.HIGHEST,  # not TF32
        ) / vs.shape[0]

    return chunked_vmap(one, delays, chunk)


@functools.partial(jax.jit, static_argnames=("bipolar",))
def _bf_from_covs(cov, bipolar):
    if bipolar:
        C_comp = fold_complex_cov(cov)
        u = top_eigvec_psd(C_comp)
        return unfold_complex_vec(u)
    return jax.vmap(dc_removed_sing_vec)(cov)


@functools.partial(jax.jit, static_argnames=("ba", "robust_width", "bipolar"))
def _apply_core(sig_in, bf_mat, kernel, neuron_ir, ba, robust_width, bipolar):
    b = np.asarray(ba[0])
    a = np.asarray(ba[1])
    sig_h = stht(sig_in, kernel, axis=0)
    sig_h = iir_filter(b, a, sig_h, axis=0, method="scan")
    sig_real = jnp.concatenate([sig_h.real, sig_h.imag], axis=1)
    spikes = rzcc_encode(sig_real, robust_width, bipolar)
    vmem = lif_filter(spikes, neuron_ir)
    return jnp.matmul(vmem, bf_mat, precision=jax.lax.Precision.HIGHEST)


class SNNBeamformer:
    """SNN beamformer with RZCC spike input (micloc/snn_beamformer.py:24-422)."""

    def __init__(
        self,
        geometry: ArrayGeometry,
        kernel_duration: float,
        freq_range,
        tau_vec,
        bipolar_spikes: bool = False,
        fs: float = FS,
        design_chunk: int = 32,
    ):
        # persistent compiled executables (utils/cache.py)
        from ..utils.cache import enable_persistent_compilation_cache

        enable_persistent_compilation_cache()

        self.geometry = geometry
        self.fs = fs
        self.design_chunk = design_chunk

        self.kernel_duration = kernel_duration
        self.kernel_length = int(fs * kernel_duration)
        self.kernel = stht_kernel(self.kernel_length)

        self.tau_vec = np.asarray(tau_vec, dtype=np.float64)

        freq_range = np.asarray(freq_range, dtype=np.float64)
        if len(freq_range) != 2 or freq_range[0] > freq_range[1]:
            raise ValueError(
                "freq_range should be a vector consisting of two frequencies f_low < f_high!"
            )
        self.freq_range = freq_range
        self.bandpass_filter = butter_bandpass(2, freq_range, fs)
        self._ba = (
            tuple(self.bandpass_filter[0].tolist()),
            tuple(self.bandpass_filter[1].tolist()),
        )

        # RZCC robust width = half the zero-crossing distance at f_high
        # (micloc/snn_beamformer.py:74-76)
        zc_dist = int(fs / freq_range[1])
        self.robust_width = zc_dist // 2
        self.bipolar_spikes = bool(bipolar_spikes)
        self.spk_encoder = ZeroCrossingSpikeEncoder(
            fs=fs, robust_width=self.robust_width, bipolar=self.bipolar_spikes
        )

    @classmethod
    def from_config(cls, config, geometry: ArrayGeometry):
        """Construct from a :class:`~haghighatshoarmuir2024.config.SNNBeamformerConfig`."""
        return cls(
            geometry=geometry,
            kernel_duration=config.kernel_duration,
            freq_range=config.freq_range,
            tau_vec=[config.tau_syn, config.tau_mem],
            bipolar_spikes=config.bipolar_spikes,
            fs=config.fs,
            design_chunk=config.design_chunk,
        )

    def _neuron_ir(self, T: int) -> np.ndarray:
        tau_syn, tau_mem = float(self.tau_vec[0]), float(self.tau_vec[1])
        return lif_impulse_response(tau_syn, tau_mem, self.fs, max_len=T)

    # ------------------------------------------------------------------ design
    def design_from_template(self, template: Tuple[np.ndarray, np.ndarray], doa_list):
        """Beamforming matrix of dim ``2M x G`` (micloc/snn_beamformer.py:82-211)."""
        time_temp, sig_temp = template
        time_temp, sig_temp = resample_to_fs(time_temp, sig_temp, self.fs)
        doa_list = np.asarray(doa_list, dtype=np.float64)
        delays = self.geometry.delays_np(doa_list, normalized=True)

        neuron_ir = self._neuron_ir(len(sig_temp))
        cov = _design_covariances(
            jnp.asarray(sig_temp),
            jnp.asarray(time_temp[0]),
            jnp.asarray(delays),
            jnp.asarray(self.kernel),
            jnp.asarray(neuron_ir),
            ba=self._ba,
            fs=float(self.fs),
            robust_width=self.robust_width,
            bipolar=self.bipolar_spikes,
            chunk=self.design_chunk,
        )
        bf = _bf_from_covs(cov, self.bipolar_spikes)
        return bf.T  # (2M, G)

    # ------------------------------------------------------------------- apply
    def apply_to_signal(self, bf_mat, sig_in_vec):
        """(time, T x M signal) → LIF membrane after beamforming, ``T x G``
        (micloc/snn_beamformer.py:283-370)."""
        time_vec, sig_in = sig_in_vec
        time_vec = np.asarray(time_vec, dtype=np.float64)

        bf_mat = jnp.asarray(bf_mat)
        twice_num_mic, _ = bf_mat.shape
        num_mic = twice_num_mic // 2
        T, num_chan = np.shape(sig_in)
        if num_chan != num_mic:
            raise ValueError(
                f"number of channels in the input signal {num_chan} should be the same "
                f"as the number of microphones {num_mic}!"
            )

        # resample on host if the grid is not uniform at 1/fs
        # (micloc/snn_beamformer.py:308-321)
        if not np.allclose(np.diff(time_vec), 1.0 / self.fs):
            sig_np = np.asarray(sig_in, dtype=np.float64)
            time_new = np.arange(time_vec[0], time_vec[-1], step=1.0 / self.fs)
            sig_in = np.stack(
                [np.interp(time_new, time_vec, sig_np[:, m]) for m in range(num_mic)],
                axis=1,
            )
            time_vec = time_new

        neuron_ir = self._neuron_ir(len(time_vec))
        return _apply_core(
            jnp.asarray(sig_in),
            bf_mat,
            jnp.asarray(self.kernel),
            jnp.asarray(neuron_ir),
            ba=self._ba,
            robust_width=self.robust_width,
            bipolar=self.bipolar_spikes,
        )

    def apply_to_template(self, bf_mat, template, snr_db: float, key=None):
        """Simulation harness + ``apply_to_signal`` (micloc/snn_beamformer.py:213-281)."""
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
        return self.apply_to_signal(bf_mat=bf_mat, sig_in_vec=(time_in, sig_in_vec))
