"""24 kHz reduced internal-rate mode (documented deviation, round 5).

experiments/reduced_rate.py measured the gate: matched MAE at
fs=24 kHz is within MC noise of 48 kHz (0.88/0.84 vs 0.82/0.90 deg at
0/10 dB) while 12 kHz degrades (2.1 deg, sub-sample aperture + degenerate
integer taus — see the experiment's docstring).  These tests pin the mode's
functional contract on CPU: the design is nondegenerate at 24 kHz, the
matched estimator localizes, and a 48 kHz field recording reaches the same
answer through `ops.resample.decimate_fir(·, factor=2)`.

Reference N/A: micloc hardcodes fs=48 kHz everywhere
(micloc/xylo_snn_localization.py:689); the rate is a config field here.
"""
import numpy as np
import pytest

from haghighatshoarmuir2024 import CenterCircularArray
from haghighatshoarmuir2024.models.xylo import Demo
from haghighatshoarmuir2024.ops.interp import signal_from_template
from haghighatshoarmuir2024.ops.resample import decimate_fir

FS24 = 24_000


@pytest.fixture(scope="module")
def demo24():
    geometry = CenterCircularArray(radius=4.5e-2, num_mic=7)
    d = Demo(
        geometry=geometry,
        freq_bands=[[1600, 1900]],
        doa_list=np.linspace(-np.pi, np.pi, 57),
        recording_duration=0.25,
        kernel_duration=10e-3,
        bipolar_spikes=True,
        fs=FS24,
        design_chunk=16,
    )
    d.calibrate_profiles()
    return d


def test_taus_nondegenerate_at_24k(demo24):
    """tau = 1/(2 pi f_mid) is 2.2 samples at 24 kHz — the bitshift decay
    must stay an integrator (dash >= 1), unlike 12 kHz where it collapses
    toward a pass-through."""
    cfg = demo24.xylo_config
    assert np.all(np.asarray(cfg.dash_syn) >= 1)
    assert np.all(np.asarray(cfg.dash_mem) >= 1)


def test_matched_estimator_localizes_at_24k(demo24):
    t = np.arange(0, 0.25, 1 / FS24)
    sig = np.sin(2 * np.pi * 1750 * t)
    rng = np.random.default_rng(0)
    for doa_true in (-1.8, 0.6):
        sig_in = np.asarray(
            signal_from_template(demo24.geometry, t, sig, doa_true, fs=FS24)
        )
        noisy = sig_in + 0.1 * rng.standard_normal(sig_in.shape).astype(np.float32)
        est, _ = demo24._forward_matched_jit(np.asarray(noisy, np.float32))
        err = np.rad2deg(np.arcsin(abs(np.sin(float(est) - doa_true))))
        # grid step is 360/57 = 6.3 deg; matched answer must land on the
        # nearest grid point
        assert err < 4.0, (doa_true, float(est), err)


def test_48k_field_input_decimates_to_24k_mode(demo24):
    """Field recordings stay 48 kHz; the mode's ingest contract is
    decimate_fir(x, 2) (same Kaiser prototype as the serving wire path).
    The decimated frame must reach the same grid answer as the native
    24 kHz synthesis."""
    fs48 = 48_000
    t48 = np.arange(0, 0.25, 1 / fs48)
    sig48 = np.sin(2 * np.pi * 1750 * t48)
    doa_true = 0.6
    sig_in48 = np.asarray(
        signal_from_template(demo24.geometry, t48, sig48, doa_true, fs=fs48)
    )
    dec = decimate_fir(sig_in48, factor=2)
    assert dec.shape[0] == sig_in48.shape[0] // 2
    est, _ = demo24._forward_matched_jit(np.asarray(dec, np.float32))
    err = np.rad2deg(np.arcsin(abs(np.sin(float(est) - doa_true))))
    assert err < 4.0, (float(est), err)
