"""Causal FIR filtering on the time axis.

JAX replacement for the FIR path of ``scipy.signal.lfilter(b, [1], x)``
(reference call sites: micloc/beamformer.py:132-134, micloc/snn_beamformer.py:158-160,
micloc/xylo_snn_localization.py:329-331 — the STHT kernel and the LIF
impulse-response filters).

Two implementations:

* ``method="fft"`` — zero-padded FFT convolution.  One large batched FFT maps
  well onto XLA's FFT; this is the default for long kernels (the STHT
  kernel is 480-960 taps).
* ``method="direct"`` — ``lax.conv_general_dilated`` with causal (left) padding;
  better for short kernels (the LIF kernel is ~40 taps) and exact in the same
  sense as scipy's direct form.

Both compute y[t] = sum_k b[k] x[t-k] with zero initial conditions, matching
``scipy.signal.lfilter(b, [1], x, axis=0)``.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..config import on_accelerator


def _next_pow2(n: int) -> int:
    return 1 << (int(n) - 1).bit_length()


def fir_filter(b, x, axis: int = 0, method: str = "auto"):
    """Causal FIR filter along ``axis`` with zero initial state.

    Args:
        b: (K,) filter taps.
        x: real or complex input array.
        axis: time axis.
        method: "auto" | "fft" | "direct".

    Returns:
        Array with the same shape and dtype-kind as ``x``.
    """
    b = jnp.asarray(b)
    x = jnp.asarray(x)
    K = b.shape[0]

    if method == "auto":
        # XLA:CPU LANDMINE (jaxlib 0.9.0, measured here): the direct
        # conv_general_dilated path with short kernels (< ~40 taps) inside
        # fused programs CORRUPTS MEMORY on the CPU backend — the SNN design
        # body (interp→STHT→IIR→RZCC→LIF-FIR→einsum) segfaults either at
        # execution or in a LATER unrelated XLA compile, depending on
        # allocator state; forcing this FIR onto the FFT path removes every
        # crash while all stages pass individually either way.  CPU is the
        # golden-test backend, so auto never picks "direct" there ("direct"
        # stays available explicitly).
        if not on_accelerator():
            method = "fft"
        else:
            method = "direct" if K <= 64 else "fft"

    if jnp.iscomplexobj(x) and not jnp.iscomplexobj(b):
        # filter real/imag parts independently (linearity)
        re = fir_filter(b, x.real, axis=axis, method=method)
        im = fir_filter(b, x.imag, axis=axis, method=method)
        return re + 1j * im

    x = jnp.moveaxis(x, axis, -1)
    T = x.shape[-1]

    if method == "fft":
        n = _next_pow2(T + K - 1)
        if jnp.iscomplexobj(x) or jnp.iscomplexobj(b):
            y = jnp.fft.ifft(jnp.fft.fft(x, n=n) * jnp.fft.fft(b.astype(x.dtype), n=n))
            y = y[..., :T]
            if not jnp.iscomplexobj(x):
                y = y.real
        else:
            X = jnp.fft.rfft(x, n=n)
            B = jnp.fft.rfft(b.astype(x.dtype), n=n)
            y = jnp.fft.irfft(X * B, n=n)[..., :T]
        y = y.astype(x.dtype)
    elif method == "direct":
        batch_shape = x.shape[:-1]
        xb = x.reshape((-1, 1, T))
        # conv_general_dilated computes cross-correlation; flip taps for convolution.
        rhs = b[::-1].astype(x.dtype).reshape((1, 1, K))
        y = jax.lax.conv_general_dilated(
            xb,
            rhs,
            window_strides=(1,),
            padding=[(K - 1, 0)],
            dimension_numbers=("NCW", "IOW", "NCW"),
        )
        y = y.reshape(batch_shape + (T,)).astype(x.dtype)
    else:
        raise ValueError(f"unknown FIR method: {method}")

    return jnp.moveaxis(y, -1, axis)


def moving_average_full(x, win_size: int):
    """``np.convolve(ones(win), x, mode='full')`` equivalent used by
    ``find_peak_location`` (reference: micloc/utils.py:110-112)."""
    x = jnp.asarray(x)
    T = x.shape[0]
    xp = jnp.pad(x, (win_size - 1, win_size - 1))
    w = jnp.cumsum(xp)
    # sliding-window sum of length win_size over the padded signal
    out = w[win_size - 1 :] - jnp.concatenate([jnp.zeros((1,), w.dtype), w[: T + win_size - 2]])
    return out
