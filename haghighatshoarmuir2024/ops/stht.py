"""Short-Time Hilbert Transform (STHT).

The reference constructs a kernel-duration FIR approximation of the Hilbert
transform — ``fftshift(imag(hilbert(impulse)))`` — and forms the analytic
signal as ``roll(x, K//2) + 1j * lfilter(kernel, [1], x)``
(reference: micloc/beamformer.py:47-52,131-134 and micloc/snn_beamformer.py:48-53,156-160).

Kernel construction is a one-shot host computation; the application is a causal
FIR convolution plus a circular roll, both jittable.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from .fir import fir_filter


def stht_kernel(kernel_length: int) -> np.ndarray:
    """FIR Hilbert kernel of length ``kernel_length`` (host-side, float64).

    Equivalent to ``np.fft.fftshift(np.imag(scipy.signal.hilbert(impulse)))``
    (micloc/beamformer.py:48-52) without requiring scipy: the analytic signal
    of a unit impulse is ifft of the one-sided spectrum window.
    """
    n = int(kernel_length)
    h = np.zeros(n)
    if n % 2 == 0:
        h[0] = h[n // 2] = 1
        h[1 : n // 2] = 2
    else:
        h[0] = 1
        h[1 : (n + 1) // 2] = 2
    # impulse at index 0 -> fft == ones
    analytic = np.fft.ifft(h.astype(complex))
    return np.fft.fftshift(np.imag(analytic))


def stht(x, kernel, axis: int = 0, method: str = "fft"):
    """Analytic signal via the STHT: ``roll(x, K//2, axis) + 1j*FIR(kernel, x)``.

    The in-phase part is rolled by the kernel group delay so it lines up with
    the quadrature output of the causal FIR (micloc/beamformer.py:131-134).
    Matches the reference's wrap-around ``np.roll`` semantics exactly.

    ``method="fft"`` runs the quadrature FIR as a padded FFT convolution;
    ``method="conv"`` exploits the discrete Hilbert kernel's structure — every
    even-index tap is exactly zero — as a dilation-2 ``lax.conv``
    at half the taps (float32, HIGHEST precision; numerically equivalent to
    the FFT path to ~1e-6 relative).
    """
    kernel = jnp.asarray(kernel)
    x = jnp.asarray(x)
    K = kernel.shape[0]
    inphase = jnp.roll(x, K // 2, axis=axis)
    if method == "conv":
        quad = _hilbert_quad_conv(kernel, x, axis=axis)
    else:
        quad = fir_filter(kernel, x, axis=axis, method=method if method != "fft" else "fft")
    return inphase + 1j * quad


def _hilbert_quad_conv(kernel, x, axis: int = 0):
    """Quadrature FIR via a dilation-2 convolution over the odd taps.

    For an even-length discrete Hilbert kernel, taps at even offsets vanish
    identically (odd symmetry of the ideal response), so
    ``y[t] = sum_j c[j] x[t-1-2j]`` with ``c[j] = kernel[2j+1]`` — a causal
    rhs-dilated convolution followed by a one-sample shift.
    """
    x = jnp.asarray(x)
    kernel = jnp.asarray(kernel, x.dtype)
    K = kernel.shape[0]
    if K % 2 != 0:
        return fir_filter(kernel, x, axis=axis, method="direct")
    c = kernel[1::2]  # (K//2,) odd taps
    xt = jnp.moveaxis(x, axis, -1)
    batch_shape = xt.shape[:-1]
    T = xt.shape[-1]
    xb = xt.reshape((-1, 1, T))
    rhs = c[::-1].reshape((1, 1, K // 2))
    w = jax.lax.conv_general_dilated(
        xb,
        rhs,
        window_strides=(1,),
        padding=[(K - 2, 0)],
        rhs_dilation=(2,),
        dimension_numbers=("NCW", "IOW", "NCW"),
        precision=jax.lax.Precision.HIGHEST,
    )
    w = w.reshape(batch_shape + (T,))
    y = jnp.concatenate([jnp.zeros(batch_shape + (1,), w.dtype), w[..., :-1]], axis=-1)
    return jnp.moveaxis(y, -1, axis)
