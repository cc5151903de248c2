"""Golden tests of FIR/IIR/STHT primitives against scipy float64 references."""
import numpy as np
import pytest
import jax.numpy as jnp
from scipy.signal import lfilter, butter, hilbert

from haghighatshoarmuir2024.ops import (
    fir_filter,
    iir_filter,
    butter_bandpass,
    stht,
    stht_kernel,
    moving_average_full,
)


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def test_fir_matches_lfilter(rng):
    x = rng.standard_normal((4000, 3))
    b = rng.standard_normal(481)
    ref = lfilter(b, [1], x, axis=0)
    for method in ("fft", "direct"):
        got = np.asarray(fir_filter(b, x, axis=0, method=method))
        np.testing.assert_allclose(got, ref, rtol=1e-9, atol=1e-9)


def test_fir_complex(rng):
    x = rng.standard_normal((1000, 2)) + 1j * rng.standard_normal((1000, 2))
    b = rng.standard_normal(33)
    ref = lfilter(b, [1], x, axis=0)
    got = np.asarray(fir_filter(b, x, axis=0, method="fft"))
    np.testing.assert_allclose(got, ref, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("order", [1, 2])
@pytest.mark.parametrize("method", ["scan", "parallel", "blocked"])
def test_iir_matches_lfilter(rng, order, method):
    fs = 48_000
    b, a = butter_bandpass(order, (1600, 1900), fs)
    x = rng.standard_normal((6000, 4))
    ref = lfilter(b, a, x, axis=0)
    got = np.asarray(iir_filter(b, a, x, axis=0, method=method))
    # the parallel/blocked forms accumulate ~1e-9 abs error over long signals
    # (pole powers amplify rounding); the sequential scan is bit-faithful
    atol = 1e-9 if method == "scan" else 1e-7
    np.testing.assert_allclose(got, ref, rtol=1e-7 if method == "scan" else 1e-5, atol=atol)


def test_iir_complex(rng):
    fs = 48_000
    b, a = butter_bandpass(2, (1600, 1900), fs)
    x = rng.standard_normal((3000, 2)) + 1j * rng.standard_normal((3000, 2))
    ref = lfilter(b, a, x, axis=0)
    for method in ("scan", "parallel"):
        got = np.asarray(iir_filter(b, a, x, axis=0, method=method))
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-7)


def test_iir_streaming_state(rng):
    fs = 48_000
    b, a = butter_bandpass(2, (1600, 1900), fs)
    x = rng.standard_normal((2000, 3))
    full = np.asarray(iir_filter(b, a, x, axis=0, method="scan"))
    y1, s = iir_filter(b, a, x[:900], axis=0, method="scan", return_state=True)
    y2 = iir_filter(b, a, x[900:], axis=0, method="scan", zi=s)
    got = np.concatenate([np.asarray(y1), np.asarray(y2)], axis=0)
    np.testing.assert_allclose(got, full, rtol=1e-10, atol=1e-12)


def test_iir_cumsum_blocked_matches_scipy_composition(rng):
    """cumsum folded into the lifted block form == cumsum(lfilter(...))."""
    fs = 48_000
    b, a = butter_bandpass(2, (1600, 1900), fs)
    for T in (6000, 6011):  # multiple of the 32-block and ragged
        x = rng.standard_normal((T, 4))
        ref = np.cumsum(lfilter(b, a, x, axis=0), axis=0)
        got = np.asarray(iir_filter(b, a, x, axis=0, method="blocked_cumsum"))
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)


def test_iir_cumsum_blocked_streaming_state(rng):
    """Chunked carried-state blocked_cumsum == one full pass (the streaming
    seam contract: filter state + running integrator offset)."""
    fs = 48_000
    b, a = butter_bandpass(2, (1600, 1900), fs)
    x = rng.standard_normal((2048, 3))
    full = np.asarray(iir_filter(b, a, x, axis=0, method="blocked_cumsum"))
    y1, s = iir_filter(b, a, x[:1024], axis=0, method="blocked_cumsum", return_state=True)
    assert np.asarray(s).shape == (3, 5)  # TDF2 state (4 poles) + integrator total (1)
    y2 = iir_filter(b, a, x[1024:], axis=0, method="blocked_cumsum", zi=s)
    got = np.concatenate([np.asarray(y1), np.asarray(y2)], axis=0)
    np.testing.assert_allclose(got, full, rtol=1e-7, atol=1e-9)


def test_iir_cumsum_blocked_nondefault_block_sizes(rng):
    """sb != 32 (round 5): the 24 kHz streaming seam carries state across
    Tc=6000-sample chunks, which no power-of-two block divides — the encode
    now picks sb from {48, 40, 24, 16}.  Exactness and the carried-state
    contract must hold at those block sizes."""
    fs = 24_000
    b, a = butter_bandpass(2, (1600, 1900), fs)
    x = rng.standard_normal((6000, 3))
    ref = np.cumsum(lfilter(b, a, x, axis=0), axis=0)
    for sb in (48, 40, 24, 16, 8):
        got = np.asarray(
            iir_filter(b, a, x, axis=0, method="blocked_cumsum", sb=sb)
        )
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)
        # carried state across a seam at this block size (the carried chunk
        # must be a multiple of sb, as in the streaming runtime)
        split = 50 * sb
        y1, s = iir_filter(
            b, a, x[:split], axis=0, method="blocked_cumsum",
            return_state=True, sb=sb,
        )
        y2 = iir_filter(
            b, a, x[split:], axis=0, method="blocked_cumsum", zi=s, sb=sb
        )
        chunked = np.concatenate([np.asarray(y1), np.asarray(y2)], axis=0)
        np.testing.assert_allclose(chunked, got, rtol=1e-7, atol=1e-9)


def test_stht_kernel_matches_scipy():
    for n in (480, 961):
        impulse = np.zeros(n)
        impulse[0] = 1
        ref = np.fft.fftshift(np.imag(hilbert(impulse)))
        got = stht_kernel(n)
        np.testing.assert_allclose(got, ref, rtol=1e-10, atol=1e-12)


def test_stht_matches_reference_construction(rng):
    """roll + lfilter construction of the analytic signal (beamformer.py:131-134)."""
    fs = 48_000
    n = 480
    impulse = np.zeros(n)
    impulse[0] = 1
    kernel = np.fft.fftshift(np.imag(hilbert(impulse)))
    x = rng.standard_normal((6000, 7))
    ref = np.roll(x, n // 2, axis=0) + 1j * lfilter(kernel, [1], x, axis=0)
    got = np.asarray(stht(x, kernel, axis=0))
    np.testing.assert_allclose(got, ref, rtol=1e-9, atol=1e-9)


def test_moving_average_full(rng):
    x = rng.standard_normal(513)
    win = 15
    ref = np.convolve(np.ones(win), x, mode="full")
    got = np.asarray(moving_average_full(x, win))
    np.testing.assert_allclose(got, ref, rtol=1e-9, atol=1e-9)


def test_hilbert_iir_fit_matches_reference_construction():
    """Hankel least-squares IIR fit of the Hilbert kernel
    (port of tests/test_hilbert_iir.py:18-57)."""
    from scipy.linalg import hankel as scipy_hankel

    from haghighatshoarmuir2024.ops.hilbert_iir import fit_hilbert_iir

    fs, dur = 50_000, 10e-3
    b_got, a_got, rel_err = fit_hilbert_iir(fs, dur, deg_MA=6, deg_AR=6)

    # reference construction
    impulse_len = int(dur * fs)
    impulse = np.zeros(impulse_len)
    impulse[0] = 1
    kerh = np.imag(hilbert(impulse))[: impulse_len // 2]
    L = len(kerh)
    inp, out = impulse[:L], kerh
    hM = scipy_hankel(inp[::-1])[::-1, :6]
    hA = scipy_hankel(out[::-1])[::-1, 1:7]
    A = np.concatenate([hM, hA], axis=1)
    sol = np.linalg.lstsq(A, scipy_hankel(out[::-1])[::-1, 0], rcond=None)[0]
    np.testing.assert_allclose(b_got, sol[:6], rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(a_got, [1, *(-sol[6:])], rtol=1e-6, atol=1e-9)
    assert rel_err < 0.2  # low-order IIR approximates the kernel usably


def test_hilbert_iir_analytic_runs():
    from haghighatshoarmuir2024.ops.hilbert_iir import (
        fit_hilbert_iir,
        hilbert_iir_analytic,
    )

    fs = 48_000
    b, a, _ = fit_hilbert_iir(fs, 10e-3)
    t = np.arange(0, 0.1, 1 / fs)
    sig = np.sin(2 * np.pi * 1750 * t)[:, None]
    out = np.asarray(hilbert_iir_analytic(sig, b, a, group_delay=0))
    assert out.shape == sig.shape and np.iscomplexobj(out)


def test_iir_cumsum_level2_matches_level1(rng):
    """The second lifting level (modal basis, explicit ASB powers) agrees
    with the plain level-1 scan to float64 rounding — including a carried
    state produced by one level and consumed by the other (the TDF2 seam
    contract is basis-independent)."""
    import haghighatshoarmuir2024.ops.iir as iir_mod

    fs = 48_000
    for order, band in [(1, (1600, 1900)), (2, (1600, 1900)), (2, (300, 400))]:
        b, a = butter_bandpass(order, band, fs)
        x = rng.standard_normal((4096, 3))  # nb=128: level-2 active (Q>2)
        y2_, s2 = iir_filter(
            b, a, x, axis=0, method="blocked_cumsum", return_state=True
        )
        orig = iir_mod._cached_level2_matrices
        iir_mod._cached_level2_matrices = lambda *args: None
        try:
            y1_, s1 = iir_filter(
                b, a, x, axis=0, method="blocked_cumsum", return_state=True
            )
            # cross-basis state hand-off: level-2 state into a level-1 pass
            z1 = np.asarray(
                iir_filter(b, a, x[:1024], axis=0, method="blocked_cumsum", zi=s2)
            )
        finally:
            iir_mod._cached_level2_matrices = orig
        # both levels sit within ~1e-6 of the scipy composition for the
        # near-unit-pole narrow band; their mutual gap is of the same order
        np.testing.assert_allclose(np.asarray(y2_), np.asarray(y1_), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(np.asarray(s2), np.asarray(s1), rtol=1e-5, atol=1e-5)
        z2 = np.asarray(
            iir_filter(b, a, x[:1024], axis=0, method="blocked_cumsum", zi=s1)
        )
        np.testing.assert_allclose(z1, z2, rtol=1e-5, atol=1e-5)


def test_modal_transform_tames_powers():
    """The modal basis bounds every lifted power by ~the spectral radius —
    the property that makes the level-2 matrices float-safe (the companion
    form transiently amplifies to ~500 at radius 0.66)."""
    from haghighatshoarmuir2024.ops.iir import _modal_transform, _tdf2_matrices

    b, a = butter_bandpass(2, (1600, 1900), 48_000)
    A, _, _ = _tdf2_matrices(b, a)
    T, Tinv = _modal_transform(A)
    Am = Tinv @ A @ T
    radius = max(abs(np.linalg.eigvals(A)))
    for k in (1, 8, 32, 128):
        norm = np.linalg.norm(np.linalg.matrix_power(Am, k), 2)
        assert norm < 3.0 * radius**k + 1e-12, (k, norm, radius**k)
