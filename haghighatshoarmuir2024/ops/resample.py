"""Wire-rate resampling for the serving path: 4x fewer bytes on the wire.

The reference never faces a wire (micloc/record.py:54-60 hands sox float
frames straight to the pipeline in-process).  The serving daemon's
socket and host->device bytes scale with the wire rate.

The localization bands live at 1.6-2.6 kHz while the pipeline samples at
48 kHz (micloc/xylo_snn_localization.py:685-741 defaults) — the wire is
~9x oversampled for the content the beamformer uses.  This module lets a
client ship audio at fs/4 (12 kHz, Nyquist 6 kHz >> 2.6 kHz band edge) and
reconstructs the 48 kHz stream ON DEVICE with a polyphase FIR interpolator,
so the full pipeline still runs at the reference's 48 kHz and the DoA path
is unchanged.  In-band (<= 2.6 kHz) the decimate->upsample round trip is
transparent to ~1e-3 relative amplitude (passband edge 2.6 kHz sits at the
flat part of the Kaiser design below); combined with the mu-law u8/u4 wire
(ops/mulaw.py) the wire shrinks up to 16x vs float32.

Streaming form: `upsample_poly_stream` carries the last `K = taps_per_phase
- 1` wire-rate samples per stream so chunk-seam outputs equal the offline
filter bit-for-bit (same VALID correlations over the same windows) — tested
in tests/test_resample.py.
"""
from __future__ import annotations

import numpy as np

UPSAMPLE_FACTOR = 4
TAPS_PER_PHASE = 16


def design_upsample_fir(
    factor: int = UPSAMPLE_FACTOR,
    taps_per_phase: int = TAPS_PER_PHASE,
    cutoff_frac: float = 0.09375,  # 4.5 kHz at fs=48k: band edge 2.6k in passband
    beta: float = 8.0,
) -> np.ndarray:
    """Kaiser-windowed sinc lowpass, length factor*taps_per_phase, gain
    `factor` in the passband (compensates the zero-stuffing power loss).

    Default: 64 taps at the 48 kHz rate, cutoff 4.5 kHz, beta 8 (~80 dB
    stopband starting ~6.4 kHz) — images of the 1.6-2.6 kHz content land at
    >= 9.4 kHz, deep in the stopband.
    """
    L = factor * taps_per_phase
    n = np.arange(L, dtype=np.float64) - (L - 1) / 2.0
    h = 2.0 * cutoff_frac * np.sinc(2.0 * cutoff_frac * n)
    h *= np.kaiser(L, beta)
    # unit DC gain for the unstuffed stream, then x`factor` for zero-stuffing
    h *= factor / np.sum(h)
    return h.astype(np.float32)


def decimate_fir(x: np.ndarray, factor: int = UPSAMPLE_FACTOR,
                 h: np.ndarray | None = None) -> np.ndarray:
    """Host-side (client) anti-aliased decimation along axis 0.

    Uses the same Kaiser prototype as the interpolator (without its x4
    gain): stopband from ~6.4 kHz keeps folded components out of the
    1.6-2.6 kHz band.  Causal alignment (output m taps history before it),
    matching `upsample_poly` on the other end — the round trip is a pure
    (L-1)-sample group delay at 48 kHz, identical on every mic, which the
    DoA path cannot see (it only uses inter-mic delays).
    """
    if h is None:
        h = design_upsample_fir(factor) / np.float32(factor)
    x = np.asarray(x, np.float32)
    flat = x.reshape(x.shape[0], -1)
    out = np.empty((x.shape[0], flat.shape[1]), np.float32)
    for c in range(flat.shape[1]):
        out[:, c] = np.convolve(flat[:, c], np.asarray(h, np.float32))[: x.shape[0]]
    return out.reshape(x.shape)[::factor].astype(np.float32)


def upsample_poly(x_wire: np.ndarray, h: np.ndarray,
                  factor: int = UPSAMPLE_FACTOR) -> np.ndarray:
    """Offline polyphase interpolation reference (host, numpy): zero-stuff
    by `factor`, causal FIR `h`, length factor*T_wire out.  Golden for the
    streaming device form."""
    x = np.asarray(x_wire, np.float32)
    T = x.shape[0]
    z = np.zeros((T * factor,) + x.shape[1:], np.float32)
    z[::factor] = x
    flat = z.reshape(z.shape[0], -1)
    out = np.empty_like(flat)
    for c in range(flat.shape[1]):
        out[:, c] = np.convolve(flat[:, c], h.astype(np.float32))[: z.shape[0]]
    return out.reshape(z.shape)


def upsample_poly_stream(x_wire, carry, h_phases, factor: int = UPSAMPLE_FACTOR):
    """Streaming polyphase interpolation (device, jittable).

    Args:
      x_wire:   (B, Tw, M) float32 wire-rate chunk.
      carry:    (B, K, M) float32, K = taps_per_phase - 1 previous wire
                samples (zeros at stream start).
      h_phases: (factor, taps_per_phase) float32 NUMPY phase table,
                ``h_phases[p, k] = h[factor*k + p]`` — pass via
                :func:`phase_table`.  Kept numpy so jit embeds it as a
                literal (stable compile-cache keys).
    Returns:
      (y, new_carry): y (B, factor*Tw, M) 48 kHz chunk equal to the offline
      `upsample_poly` of the concatenated stream; new_carry (B, K, M).
    """
    import jax.numpy as jnp
    from jax import lax

    P, Kp = h_phases.shape
    B, Tw, M = x_wire.shape
    K = Kp - 1
    x_ext = jnp.concatenate([carry, x_wire], axis=1)  # (B, K+Tw, M)
    # y[b, factor*i + p, m] = sum_k h[factor*k + p] * x[b, i - k, m]
    # == VALID correlation of x_ext with the reversed phase kernel.
    # One conv call, phases as output channels, mics as feature groups.
    lhs = jnp.transpose(x_ext, (0, 2, 1))  # (B, M, K+Tw)
    rhs = jnp.asarray(
        np.tile(h_phases[:, ::-1].astype(np.float32), (M, 1))[:, None, :]
    )  # (M*P, 1, Kp): group g (mic) gets rows g*P..g*P+P-1
    out = lax.conv_general_dilated(
        lhs, rhs, window_strides=(1,), padding="VALID",
        feature_group_count=M,
        precision=lax.Precision.HIGHEST,
    )  # (B, M*P, Tw)
    out = out.reshape(B, M, P, Tw)
    y = jnp.transpose(out, (0, 3, 2, 1)).reshape(B, Tw * P, M)
    new_carry = x_ext[:, Tw:, :] if Tw >= K else x_ext[:, -K:, :]
    return y, new_carry


def phase_table(h: np.ndarray, factor: int = UPSAMPLE_FACTOR) -> np.ndarray:
    """(factor, taps_per_phase) polyphase decomposition of `h` (numpy)."""
    h = np.asarray(h, np.float32)
    assert h.size % factor == 0
    return h.reshape(-1, factor).T.copy()
