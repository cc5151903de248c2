"""Time-major RZCC entry points (ops/peaks.py: ``select_by_distance_tm``,
``rzcc_select_bipolar_tm``, ``rzcc_encode_bipolar_tm``) against
``scipy.signal.find_peaks(distance=)`` and a NumPy transcription of scipy's
greedy ``_select_by_peak_distance`` for arbitrary candidate sets."""
import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from scipy.signal import find_peaks

from haghighatshoarmuir2024.ops import peaks

local_maxima_mask = jax.jit(peaks.local_maxima_mask)
select_by_distance_tm = jax.jit(peaks.select_by_distance_tm, static_argnums=2)
rzcc_select_bipolar_tm = jax.jit(peaks.rzcc_select_bipolar_tm, static_argnums=3)
rzcc_encode_bipolar_tm = jax.jit(peaks.rzcc_encode_bipolar_tm, static_argnums=(1, 2))


def greedy_golden(cand, height, distance):
    """scipy's height-ordered greedy suppression on one row.  Exact ties are
    taken rightmost first (a stable sort, reversed), the documented
    deterministic choice of ops/peaks.py."""
    peaks = np.nonzero(cand)[0]
    d = math.ceil(distance)
    keep = np.ones(len(peaks), bool)
    for i in np.argsort(height[peaks], kind="stable")[::-1]:
        if not keep[i]:
            continue
        j = i - 1
        while j >= 0 and peaks[i] - peaks[j] < d:
            keep[j] = False
            j -= 1
        j = i + 1
        while j < len(peaks) and peaks[j] - peaks[i] < d:
            keep[j] = False
            j += 1
    out = np.zeros(len(height), bool)
    out[peaks[keep]] = True
    return out


def scipy_mask(x, distance):
    out = np.zeros(len(x), bool)
    out[find_peaks(x, distance=distance)[0]] = True
    return out


def tm_select(cand_rt, height_rt, distance):
    return np.asarray(
        select_by_distance_tm(jnp.asarray(cand_rt.T), jnp.asarray(height_rt.T), distance)
    ).T


@pytest.mark.parametrize("rows,T", [(5, 400), (9, 203)], ids=["random", "ragged"])
@pytest.mark.parametrize("d", [1, 3, 7, 12])
def test_select_tm_matches_scipy_on_random_walks(rows, T, d):
    rng = np.random.default_rng(rows * T + d)
    x = np.cumsum(rng.standard_normal((rows, T)), axis=-1).astype(np.float32)
    cand = np.asarray(local_maxima_mask(jnp.asarray(x)))
    got = tm_select(cand, x, d)
    for r in range(rows):
        np.testing.assert_array_equal(got[r], scipy_mask(x[r], d))


@pytest.mark.parametrize("d", [2, 5, 11])
def test_select_tm_dense_chains(d):
    # candidates everywhere: long suppression chains, many fixed-point rounds
    rng = np.random.default_rng(d)
    h = rng.standard_normal((3, 257)).astype(np.float32)
    cand = np.ones_like(h, bool)
    got = tm_select(cand, h, d)
    for r in range(3):
        np.testing.assert_array_equal(got[r], greedy_golden(cand[r], h[r], d))


@pytest.mark.parametrize("d", [6, 11, 40])
def test_select_tm_exact_ties_rightmost(d):
    h = np.zeros((1, 64), np.float32)
    cand = np.zeros((1, 64), bool)
    h[0, [10, 15, 40, 45, 50]] = 1.0  # bit-identical heights
    cand[0, [10, 15, 40, 45, 50]] = True
    np.testing.assert_array_equal(tm_select(cand, h, d)[0], greedy_golden(cand[0], h[0], d))


def test_select_tm_empty_and_full():
    h = np.linspace(0, 1, 100, dtype=np.float32)[None, :]
    empty = np.zeros((1, 100), bool)
    assert tm_select(empty, h, 5).sum() == 0
    full = np.ones((1, 100), bool)
    np.testing.assert_array_equal(tm_select(full, h, 5)[0], greedy_golden(full[0], h[0], 5))


@pytest.mark.parametrize("d,W", [(3, 6), (7, 14), (12, 24)])
def test_rzcc_encode_tm_matches_scipy_with_plateaus(d, W):
    """Both polarities of the bipolar encode equal scipy find_peaks on ±cs,
    including exact plateaus shorter than the bounded search W."""
    rng = np.random.default_rng(d)
    cs = np.cumsum(rng.standard_normal((4, 300)), axis=-1).astype(np.float32)
    cs[:, 40:44] = cs[:, 40:41]
    cs[:, 100:103] = cs[:, 100:101]
    kp, kn = rzcc_encode_bipolar_tm(jnp.asarray(cs.T), d, W)
    kp, kn = np.asarray(kp).T, np.asarray(kn).T
    for r in range(4):
        np.testing.assert_array_equal(kp[r], scipy_mask(cs[r], d))
        np.testing.assert_array_equal(kn[r], scipy_mask(-cs[r], d))


@pytest.mark.parametrize("d,W", [(24, 48), (80, 24), (300, 24)])
def test_rzcc_encode_tm_wide_window(d, W):
    """Wide suppression windows (low bands → large robust width), with
    extrema whose suppression chains span hundreds of samples."""
    rng = np.random.default_rng(17)
    t = np.arange(2000)
    cs = np.cumsum(
        np.sin(2 * np.pi * t / 900.0)[None, :] + 0.3 * rng.standard_normal((3, 2000)),
        axis=-1,
    ).astype(np.float32)
    kp, kn = rzcc_encode_bipolar_tm(jnp.asarray(cs.T), d, W)
    kp, kn = np.asarray(kp).T, np.asarray(kn).T
    for r in range(3):
        np.testing.assert_array_equal(kp[r], scipy_mask(cs[r], d))
        np.testing.assert_array_equal(kn[r], scipy_mask(-cs[r], d))


def test_rzcc_select_bipolar_tm_matches_scipy():
    rng = np.random.default_rng(5)
    cs = np.cumsum(rng.standard_normal((6, 500)), axis=-1).astype(np.float32)
    maxima = np.asarray(local_maxima_mask(jnp.asarray(cs)))
    minima = np.asarray(local_maxima_mask(jnp.asarray(-cs)))
    for d in (3, 7, 12):
        kp, kn = rzcc_select_bipolar_tm(
            jnp.asarray(cs.T), jnp.asarray(maxima.T), jnp.asarray(minima.T), d
        )
        kp, kn = np.asarray(kp).T, np.asarray(kn).T
        for r in range(6):
            np.testing.assert_array_equal(kp[r], scipy_mask(cs[r], d))
            np.testing.assert_array_equal(kn[r], scipy_mask(-cs[r], d))
