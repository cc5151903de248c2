"""SRP-PHAT baseline (models/srp_phat.py): classical GCC-PHAT steered power.

Beyond-parity family (the reference has no TDoA baseline); correctness is
pinned against first principles — a whitened narrowband-ish source must peak
at its true DoA, the transform must be amplitude-invariant, and the
frequency-domain contraction must equal a direct per-pair GCC evaluation.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from haghighatshoarmuir2024 import CenterCircularArray
from haghighatshoarmuir2024.models import SRPPHAT
from haghighatshoarmuir2024.ops.interp import signal_from_template

FS = 48_000


@pytest.fixture(scope="module")
def srp():
    geo = CenterCircularArray(radius=4.5e-2, num_mic=7)
    return SRPPHAT(geo, freq_range=[1400, 2800],
                   doa_list=np.linspace(-np.pi, np.pi, 225),
                   fs=FS, frame_duration=0.25)


def _frame(srp, doa, snr_db, seed, f0=1750.0, bw=600.0):
    """Band-limited noise-modulated tone frame at a given DoA and SNR."""
    rng = np.random.default_rng(seed)
    t = np.arange(srp.T) / FS
    # sum of in-band tones: broadbandish within the analysis band
    sig = sum(np.sin(2 * np.pi * (f0 + df) * t + rng.uniform(0, 2 * np.pi))
              for df in np.linspace(-bw / 2, bw / 2, 7))
    # t - delay: SRP's physical steering convention (plus-convention audio
    # mirrors every estimate by 180 deg — see ops/interp.signal_from_template)
    clean = np.asarray(
        signal_from_template(srp.geometry, t, np.asarray(sig), doa, fs=FS,
                             delay_sign=-1)
    )
    sigma = np.sqrt((clean**2).mean() / 10 ** (snr_db / 10))
    return (clean + sigma * rng.standard_normal(clean.shape)).astype(np.float32)


def _folded_deg(a, b):
    return np.rad2deg(np.arcsin(np.abs(np.sin(a - b))))


def test_recovers_doa_across_grid(srp):
    for seed, doa in enumerate(np.linspace(-3.0, 3.0, 7)):
        x = _frame(srp, doa, snr_db=10.0, seed=seed)
        est = float(srp.estimate(x))
        # UNFOLDED: the correct side of the circle, not just the folded
        # error (which hides the 180-deg mirror a wrong synthesis
        # convention produces)
        err = np.abs(np.arctan2(np.sin(est - doa), np.cos(est - doa)))
        assert np.rad2deg(err) < 3.0, (doa, est)


def test_batched_equals_single(srp):
    xs = np.stack([_frame(srp, d, 10.0, seed=i)
                   for i, d in enumerate([-1.2, 0.3, 2.1])])
    pb = np.asarray(srp.apply_to_signal(xs))
    for i in range(3):
        ps = np.asarray(srp.apply_to_signal(xs[i]))
        # batched FFT/matmul numerics differ from single-frame at float32
        # rounding level; the spectrum scale is O(bins) ~ 350
        np.testing.assert_allclose(pb[i], ps, rtol=0, atol=2e-3)
        assert np.argmax(pb[i]) == np.argmax(ps)


def test_phat_amplitude_invariance(srp):
    """The phase transform discards magnitude: scaling the input leaves the
    angular spectrum unchanged (up to float rounding)."""
    x = _frame(srp, 0.8, snr_db=20.0, seed=3)
    p1 = np.asarray(srp.apply_to_signal(x))
    p2 = np.asarray(srp.apply_to_signal(37.5 * x))
    # float32 rounding: the spectrum scale is O(100), so allow a small
    # relative term alongside the absolute floor
    np.testing.assert_allclose(p1, p2, rtol=1e-5, atol=1e-4)


def test_matches_direct_gcc_reference(srp):
    """The (pairs*bins) x grid contraction equals the textbook per-pair
    GCC-PHAT evaluation with numpy at float64."""
    x = _frame(srp, -0.9, snr_db=5.0, seed=4)
    got = np.asarray(srp.apply_to_signal(x), np.float64)

    X = np.fft.rfft(np.asarray(x, np.float64), axis=0)
    freqs = np.fft.rfftfreq(srp.T, 1 / FS)
    bins = srp._bins
    d = srp.geometry.delays_np(srp.doa_list, normalized=True).T  # (M, G)
    ref = np.zeros(len(srp.doa_list))
    for (i, j) in srp._pairs:
        cross = X[bins, i] * np.conj(X[bins, j])
        R = cross / np.maximum(np.abs(cross), 1e-12)
        tau = d[i] - d[j]  # (G,)
        steer = np.exp(1j * 2 * np.pi * freqs[bins][:, None] * tau[None, :])
        ref += np.real(R[None, :] @ steer)[0]
    ref /= len(srp._pairs)
    np.testing.assert_allclose(got, ref, rtol=0, atol=5e-4)


def test_apply_to_template_contract(srp):
    p = np.asarray(srp.apply_to_template(
        (np.arange(srp.T) / FS,
         np.sin(2 * np.pi * 1750 * np.arange(srp.T) / FS), 1.1),
        snr_db=10.0, key=jax.random.PRNGKey(0),
    ))
    assert p.shape == (len(srp.doa_list),)
    est = srp.doa_list[int(np.argmax(p))]
    # single tone: PHAT over the band still peaks at the true DoA
    assert _folded_deg(est, 1.1) < 5.0


def test_rejects_bad_config():
    geo = CenterCircularArray(radius=4.5e-2, num_mic=7)
    with pytest.raises(ValueError):
        SRPPHAT(geo, freq_range=[2800, 1400], doa_list=[0.0], fs=FS)
    with pytest.raises(ValueError):
        # 0.01 s frame -> 100 Hz bins; (1401, 1449) straddles none
        SRPPHAT(geo, freq_range=[1401, 1449], doa_list=[0.0], fs=FS,
                frame_duration=0.01)
