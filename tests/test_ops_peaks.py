"""find_peaks / RZCC spike-encoder golden tests against scipy."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
from scipy.signal import find_peaks, butter, lfilter

from haghighatshoarmuir2024.ops import (
    find_peaks_mask,
    local_maxima_mask,
    rzcc_encode,
    ZeroCrossingSpikeEncoder,
    IAFSpikeEncoder,
    IAFZeroCrossingSpikeEncoder,
)


def mask_to_idx(mask):
    return np.nonzero(np.asarray(mask))[0]


@pytest.mark.parametrize("seed", range(5))
def test_local_maxima_matches_scipy(seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(2000)
    ref, _ = find_peaks(x)
    got = mask_to_idx(local_maxima_mask(jnp.asarray(x)))
    np.testing.assert_array_equal(got, ref)


def test_local_maxima_plateaus():
    # plateaus of various widths, including edges
    x = np.array([0, 1, 1, 0, 2, 2, 2, 1, 3, 3, 3, 3, 2, 5, 5], dtype=float)
    ref, _ = find_peaks(x)
    got = mask_to_idx(local_maxima_mask(jnp.asarray(x)))
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("distance", [2, 5, 12, 37])
@pytest.mark.parametrize("seed", range(4))
def test_distance_matches_scipy(seed, distance):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(3000)
    ref, _ = find_peaks(x, distance=distance)
    got = mask_to_idx(find_peaks_mask(jnp.asarray(x), distance=distance))
    np.testing.assert_array_equal(got, ref)


def test_distance_with_ties():
    """Quantized values force exact height ties.  scipy's tie order comes from
    its *unstable* np.argsort, which is not a reproducible semantic; we keep
    the rightmost of a tie.  Assert that (a) every disagreement involves a tie
    (equal heights within the window) and (b) the kept sets have equal size and
    equal heights."""
    rng = np.random.default_rng(7)
    x = np.round(rng.standard_normal(1500) * 3) / 3
    cand = mask_to_idx(local_maxima_mask(jnp.asarray(x)))
    for d in (3, 8, 20):
        got = mask_to_idx(find_peaks_mask(jnp.asarray(x), distance=d))
        kept = set(got.tolist())
        # property 1: kept peaks respect the minimum spacing
        assert np.all(np.diff(got) >= d), f"d={d}"
        # property 2 (greedy maximality): every suppressed candidate lies
        # within the window of a kept candidate of >= height
        for c in cand.tolist():
            if c in kept:
                continue
            dominators = [k for k in kept if abs(k - c) < d and x[k] >= x[c]]
            assert dominators, f"d={d}: candidate {c} suppressed without dominator"


def test_distance_on_bandpassed_cumsum():
    """The exact RZCC use case: peaks of cumsum of a bandpassed noisy tone."""
    rng = np.random.default_rng(3)
    fs = 48_000
    t = np.arange(12_000) / fs
    sig = np.sin(2 * np.pi * 1750 * t) + 0.5 * rng.standard_normal(len(t))
    b, a = butter(2, [1600, 1900], btype="bandpass", fs=fs)
    sig = lfilter(b, a, sig)
    cs = np.cumsum(sig)
    d = (fs // 1900) // 2
    ref, _ = find_peaks(cs, distance=d)
    got = mask_to_idx(find_peaks_mask(jnp.asarray(cs), distance=d))
    np.testing.assert_array_equal(got, ref)


def _rzcc_ref(sig_in, robust_width, bipolar):
    """Direct port of micloc/spike_encoder.py:115-137 (scipy reference)."""
    spikes = np.zeros_like(sig_in).T
    for chan, sig_chan in enumerate(sig_in.T):
        peaks, _ = find_peaks(np.cumsum(sig_chan), distance=robust_width)
        spikes[chan, peaks] = 1
        if bipolar:
            valleys, _ = find_peaks(-np.cumsum(sig_chan), distance=robust_width)
            spikes[chan, valleys] = -1
    return spikes.T


@pytest.mark.parametrize("bipolar", [False, True])
def test_rzcc_matches_reference(bipolar):
    rng = np.random.default_rng(11)
    fs = 48_000
    t = np.arange(6000) / fs
    sig = np.stack(
        [np.sin(2 * np.pi * f * t) + 0.3 * rng.standard_normal(len(t)) for f in (1700, 1800, 1850)],
        axis=1,
    )
    b, a = butter(2, [1600, 1900], btype="bandpass", fs=fs)
    sig = lfilter(b, a, sig, axis=0)
    rw = (fs // 1900) // 2
    ref = _rzcc_ref(sig, rw, bipolar)
    got = np.asarray(rzcc_encode(jnp.asarray(sig), rw, bipolar))
    np.testing.assert_array_equal(got, ref)


def test_rzcc_under_jit_and_vmap():
    rng = np.random.default_rng(5)
    sig = rng.standard_normal((3, 2000, 4))  # batch of 3 signals
    f = jax.jit(lambda s: rzcc_encode(s, 7, True))
    batched = jax.vmap(f)(jnp.asarray(sig))
    single = np.stack([np.asarray(f(jnp.asarray(s))) for s in sig])
    np.testing.assert_array_equal(np.asarray(batched), single)


def test_iaf_encoders_match_reference():
    rng = np.random.default_rng(2)
    sig = rng.standard_normal((4000, 3))
    fs, rate = 48_000.0, 1000.0

    enc = IAFSpikeEncoder(target_spike_rate=rate, fs=fs)
    thr = np.mean(np.abs(sig)) * fs / rate
    ref = np.diff(np.floor(np.cumsum(np.abs(sig), axis=0) / thr), axis=0)
    np.testing.assert_allclose(np.asarray(enc(sig)), ref, atol=1e-9)

    enc2 = IAFZeroCrossingSpikeEncoder(target_spike_rate=rate, fs=fs)
    cs = np.cumsum(sig, axis=0)
    thr2 = np.mean(np.abs(cs)) * fs / rate
    ref2 = np.diff(np.floor(np.cumsum(np.abs(cs), axis=0) / thr2), axis=0)
    np.testing.assert_allclose(np.asarray(enc2(sig)), ref2, atol=1e-9)


@pytest.mark.parametrize("seed", range(3))
def test_bounded_variants_match_full(seed):
    """Bounded-plateau and combined-extrema forms equal the exact masks for
    continuous-valued signals."""
    from haghighatshoarmuir2024.ops.peaks import (
        local_maxima_mask_bounded,
        local_extrema_mask_bounded,
    )

    rng = np.random.default_rng(seed)
    x = np.cumsum(rng.standard_normal((4, 3000)), axis=-1).astype(np.float64)
    xj = jnp.asarray(x)
    full = np.asarray(local_maxima_mask(xj))
    bounded = np.asarray(local_maxima_mask_bounded(xj, 24))
    np.testing.assert_array_equal(bounded, full)
    mx, mn = local_extrema_mask_bounded(xj, 24)
    np.testing.assert_array_equal(np.asarray(mx), full)
    full_min = np.asarray(local_maxima_mask(-xj))
    np.testing.assert_array_equal(np.asarray(mn), full_min)
