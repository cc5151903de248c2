"""Wire-rate resampling (ops/resample.py): the 4x serving wire reduction.

The serving daemon's measured ceiling is host->device upload bandwidth
(runtime/server.py), and the 1.6-2.6 kHz localization bands are ~9x
oversampled at the reference's 48 kHz (micloc/xylo_snn_localization.py
defaults) — so the wire can run at fs/4 with an on-device polyphase
reconstruction.  These tests pin (a) streaming == offline interpolation at
chunk seams, (b) in-band transparency of the decimate->upsample round trip,
(c) the filter design invariants.
"""
import numpy as np
import jax
import jax.numpy as jnp

from haghighatshoarmuir2024.ops.resample import (
    TAPS_PER_PHASE,
    decimate_fir,
    design_upsample_fir,
    phase_table,
    upsample_poly,
    upsample_poly_stream,
)


def test_filter_design_invariants():
    h = design_upsample_fir(4)
    assert h.shape == (4 * TAPS_PER_PHASE,)
    # DC gain = factor (zero-stuffed stream comes back at unit amplitude)
    assert np.isclose(h.sum(), 4.0, atol=1e-6)
    # stopband: images of the 1.6-2.6 kHz band land at >= 9.4 kHz
    w = np.fft.rfftfreq(8192, 1 / 48000.0)
    H = np.abs(np.fft.rfft(h, 8192))
    stop = H[w >= 9400]
    assert 20 * np.log10(stop.max() / 4.0 + 1e-12) < -60.0
    # passband flat where the bands live
    band = H[(w >= 1600) & (w <= 2600)]
    assert np.all(np.abs(band / 4.0 - 1.0) < 1e-3)


def test_streaming_equals_offline_at_seams():
    rng = np.random.default_rng(0)
    B, Tw, M, F = 2, 480, 3, 4
    x = rng.standard_normal((B, Tw, M)).astype(np.float32)
    h = design_upsample_fir(F)
    hp = phase_table(h, F)

    # offline golden (numpy convolve of the zero-stuffed full stream)
    gold = np.stack([upsample_poly(x[b], h, F) for b in range(B)])

    # streaming: 4 chunks of 120 wire samples with carried state
    K = TAPS_PER_PHASE - 1
    carry = jnp.zeros((B, K, M), jnp.float32)
    outs = []
    step = jax.jit(lambda xc, c: upsample_poly_stream(xc, c, hp, F))
    for s in range(0, Tw, 120):
        y, carry = step(jnp.asarray(x[:, s : s + 120]), carry)
        outs.append(np.asarray(y))
    got = np.concatenate(outs, axis=1)
    assert got.shape == (B, Tw * F, M)
    np.testing.assert_allclose(got, gold, rtol=0, atol=2e-5)

    # chunked == one-shot through the SAME device op (seams are invisible)
    y1, _ = step(jnp.asarray(x), jnp.zeros((B, K, M), jnp.float32))
    np.testing.assert_allclose(got, np.asarray(y1), rtol=0, atol=2e-5)


def test_roundtrip_inband_transparent():
    """decimate(48k -> 12k) then upsample(12k -> 48k) is a pure group delay
    for in-band content: the DoA front end (which only uses inter-mic
    timing of the bandpassed signal) cannot tell the difference."""
    fs, F = 48000, 4
    t = np.arange(0, 0.5, 1 / fs)
    for f0 in (1650.0, 2100.0, 2600.0):
        x = np.sin(2 * np.pi * f0 * t).astype(np.float32)[:, None]
        xw = decimate_fir(x, F)
        h = design_upsample_fir(F)
        y = upsample_poly(xw, h, F)[:, 0]
        # both filters are linear-phase length-64: total delay 63 samples
        d = 63
        err = y[d + 2000 : d + 20000] - x[2000:20000, 0]
        rel = np.sqrt((err**2).mean() / (x**2).mean())
        assert rel < 2e-3, (f0, rel)


def test_decimate_rejects_folding_noise():
    """Broadband noise that would fold onto the band is attenuated by the
    anti-alias stage (the folded region 9.4-10.4 kHz maps onto 1.6-2.6 kHz)."""
    fs, F = 48000, 4
    t = np.arange(0, 0.5, 1 / fs)
    x = np.sin(2 * np.pi * 9900.0 * t).astype(np.float32)[:, None]  # folds to 2.1k
    xw = decimate_fir(x, F)
    assert np.sqrt((xw**2).mean()) < 2e-3  # > 50 dB down
