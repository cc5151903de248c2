"""Mu-law wire codec (ops/mulaw.py): exact-log companding, 8-bit wire."""
import numpy as np

from haghighatshoarmuir2024.ops.mulaw import (
    MU,
    mulaw_decode,
    mulaw_decode_table,
    mulaw_encode,
)


def test_roundtrip_snr_on_audio():
    rng = np.random.default_rng(0)
    t = np.arange(12000) / 48000.0
    x = 0.5 * np.sin(2 * np.pi * 1750 * t) + 0.05 * rng.standard_normal(12000)
    x = np.clip(x, -1, 1).astype(np.float32)
    y = mulaw_decode(mulaw_encode(x))
    snr = 10 * np.log10((x**2).mean() / ((x - y) ** 2).mean() + 1e-30)
    assert snr > 30.0, snr  # companded SNR beats the nominal 27 dB on audio


def test_codes_are_centroids_and_monotone():
    table = mulaw_decode_table()
    assert table.shape == (256,) and table.dtype == np.float32
    pos, neg = table[:128], table[128:]
    assert np.all(np.diff(pos) > 0)  # strictly increasing magnitudes
    assert np.allclose(neg, -pos)  # sign symmetry
    assert pos[0] == 0.0 and np.isclose(pos[127], 1.0)
    # decode(encode(level)) is exact on the representable levels
    assert np.array_equal(mulaw_decode(mulaw_encode(table)), table)


def test_encode_accepts_int16():
    x16 = (np.linspace(-1, 1, 1001) * 32767).astype(np.int16)
    y = mulaw_decode(mulaw_encode(x16))
    # worst case is half a code step at full scale: ln(1+MU)*(1+1/MU)/(2*127)
    assert np.max(np.abs(y - x16.astype(np.float32) / 32768.0)) < 0.023


def test_extremes_and_zero():
    assert mulaw_encode(np.float32(0.0)) == 0
    assert mulaw_decode(np.uint8(127)) == 1.0
    assert mulaw_decode(np.uint8(255)) == -1.0


def test_mulaw4_roundtrip_and_tables():
    from haghighatshoarmuir2024.ops.mulaw import (
        mulaw4_decode,
        mulaw4_decode_table,
        mulaw4_encode,
        pack4,
        unpack4,
    )

    table = mulaw4_decode_table()
    assert table.shape == (16,) and table.dtype == np.float32
    pos, neg = table[:8], table[8:]
    assert np.all(np.diff(pos) > 0) and np.allclose(neg, -pos)
    assert pos[0] == 0.0 and np.isclose(pos[7], 1.0)
    assert np.array_equal(mulaw4_decode(mulaw4_encode(table)), table)

    rng = np.random.default_rng(0)
    t = np.arange(12000) / 48000.0
    x = 0.5 * np.sin(2 * np.pi * 1750 * t) + 0.05 * rng.standard_normal(12000)
    x = np.clip(x, -1, 1).astype(np.float32)
    y = mulaw4_decode(mulaw4_encode(x))
    snr = 10 * np.log10((x**2).mean() / ((x - y) ** 2).mean() + 1e-30)
    assert snr > 12.0, snr  # broadband; in-band is ~9 dB better post-bandpass

    # pack/unpack is a lossless byte-layout transform
    codes = mulaw4_encode(x.reshape(-1, 4))  # (3000, 4)
    assert np.array_equal(unpack4(pack4(codes)), codes)
    assert pack4(codes).shape == (1500, 4)
