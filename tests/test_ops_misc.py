"""Golden tests: linalg primitives, LIF impulse response, envelope follower,
filterbank — against direct NumPy/SciPy ports of the reference."""
import numpy as np
import jax.numpy as jnp
from scipy.signal import lfilter

from haghighatshoarmuir2024.ops import (
    ButterworthFilterbank,
    Envelope,
    dc_removed_sing_vec,
    fold_complex_cov,
    generalized_top_eigvec,
    lif_impulse_response,
    top_eigvec_psd,
    unfold_complex_vec,
)


def _align_phase(v, ref):
    """Align an eigenvector to a reference up to a unit complex/real phase."""
    inner = np.vdot(ref, v)
    phase = inner / np.abs(inner)
    return v / phase


def test_top_eigvec_matches_svd():
    rng = np.random.default_rng(0)
    X = rng.standard_normal((200, 7)) + 1j * rng.standard_normal((200, 7))
    C = X.conj().T @ X / 200
    U, D, _ = np.linalg.svd(C)
    ref = U[:, 0]
    got = _align_phase(np.asarray(top_eigvec_psd(jnp.asarray(C))), ref)
    np.testing.assert_allclose(got, ref, rtol=1e-8, atol=1e-9)


def _ref_dc_removed(C, rel_prec=1e-8):
    """Port of micloc/snn_beamformer.py:372-422."""
    U, D, _ = np.linalg.svd(C)
    all_one = np.ones(C.shape[0])
    theta = U.T @ all_one
    u_min, u_max = D[1], D[0]
    while (u_max - u_min) / u_min >= rel_prec:
        u_mid = (u_min + u_max) / 2
        val_mid = np.sum(theta**2 / (D - u_mid))
        if val_mid < 0.0:
            u_min = u_mid
        else:
            u_max = u_mid
    root = (u_min + u_max) / 2.0
    sing_vec = U @ (theta / (D - root))
    return sing_vec / np.linalg.norm(sing_vec)


def test_dc_removed_sing_vec():
    rng = np.random.default_rng(1)
    X = np.abs(rng.standard_normal((500, 14))) + 0.5  # positive signals (DC-dominant)
    C = X.T @ X / 500
    ref = _ref_dc_removed(C)
    got = np.asarray(dc_removed_sing_vec(jnp.asarray(C)))
    if np.dot(got, ref) < 0:
        got = -got
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-8)
    # orthogonal to the all-ones direction
    assert abs(np.sum(got)) < 1e-6


def test_dc_removed_vmap():
    import jax

    rng = np.random.default_rng(2)
    Cs = []
    for _ in range(5):
        X = np.abs(rng.standard_normal((300, 8))) + 0.2
        Cs.append(X.T @ X / 300)
    Cs = np.stack(Cs)
    got = np.asarray(jax.vmap(dc_removed_sing_vec)(jnp.asarray(Cs)))
    for i in range(5):
        ref = _ref_dc_removed(Cs[i])
        g = got[i] if np.dot(got[i], ref) > 0 else -got[i]
        # the reference stops its bisection at rel_prec=1e-8 with the root just
        # above D[1]; near-pole sensitivity bounds the agreement to ~1e-6
        np.testing.assert_allclose(g, ref, rtol=1e-4, atol=2e-6)


def test_generalized_top_eigvec():
    from scipy.linalg import eigh as scipy_eigh

    rng = np.random.default_rng(3)
    X = rng.standard_normal((100, 6)) + 1j * rng.standard_normal((100, 6))
    C = X.conj().T @ X / 100
    Y = rng.standard_normal((100, 6)) + 1j * rng.standard_normal((100, 6))
    B = Y.conj().T @ Y / 100 + 0.5 * np.eye(6)
    D, U = scipy_eigh(C, B)
    ref = U[:, -1]
    ref = ref / np.linalg.norm(ref)
    got = np.asarray(generalized_top_eigvec(jnp.asarray(C), jnp.asarray(B)))
    got = _align_phase(got, ref)
    np.testing.assert_allclose(got, ref, rtol=1e-7, atol=1e-8)


def test_fold_complex_cov_roundtrip():
    rng = np.random.default_rng(4)
    M = 7
    V = rng.standard_normal((300, 2 * M))
    C = V.T @ V / 300
    Cc = np.asarray(fold_complex_cov(jnp.asarray(C)))
    ref_diag = (C[:M, :M] + C[M:, M:]) / 2
    ref_off = (C[:M, M:] + C[M:, :M].T) / 2
    np.testing.assert_allclose(Cc, ref_diag + 1j * ref_off, rtol=1e-12, atol=1e-12)
    u = np.asarray(top_eigvec_psd(jnp.asarray(Cc)))
    v = np.asarray(unfold_complex_vec(jnp.asarray(u)))
    np.testing.assert_allclose(v[:M], u.real, atol=1e-12)
    np.testing.assert_allclose(v[M:], u.imag, atol=1e-12)


def _ref_lif_ir(tau_syn, tau_mem, fs, T):
    """Port of micloc/snn_beamformer.py:117-137 (equal-tau branch)."""
    t = np.arange(T) / fs
    h = (t / tau_syn) * np.exp(-t / tau_syn)
    h = h / np.sum(h)
    eff = np.sum(np.cumsum(h) < 0.999)
    return h[:eff]


def test_lif_impulse_response_equal_taus():
    fs = 48_000
    tau = 1 / (2 * np.pi * 1750)
    ref = _ref_lif_ir(tau, tau, fs, 12_000)
    got = lif_impulse_response(tau, tau, fs, max_len=12_000)
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-15)


def _ref_envelope(sig_in, rise_time, fall_time, fs):
    """Port of micloc/utils.py:36-81."""
    win_lens = np.asarray([int(fs * fall_time), int(fs * rise_time)])
    sig_in = np.abs(sig_in)
    state = np.copy(sig_in[0])
    sig_out = []
    for sig in sig_in[1:]:
        sig_out.append(state[:])
        rise_or_fall = (sig >= state).astype(int)
        win_len_state = win_lens[rise_or_fall]
        state = (1 - 1 / win_len_state) * state + 1 / win_len_state * sig * rise_or_fall
    sig_out.append(state[:])
    return np.asarray(sig_out)


def test_envelope_matches_reference():
    rng = np.random.default_rng(5)
    fs = 10_000
    sig = rng.standard_normal((500, 3))
    env = Envelope(rise_time=5e-3, fall_time=50e-3, fs=fs)
    ref = _ref_envelope(sig, 5e-3, 50e-3, fs)
    got = np.asarray(env.evolve(jnp.asarray(sig)))
    np.testing.assert_allclose(got, ref, rtol=1e-9, atol=1e-12)


def test_filterbank_matches_scipy():
    from scipy.signal import butter

    rng = np.random.default_rng(6)
    fs = 48_000
    bands = [[1600, 1900], [1900, 2200], [2200, 2500]]
    fb = ButterworthFilterbank(freq_bands=bands, order=1, fs=fs)
    sig = rng.standard_normal((3000, 7))
    got = np.asarray(fb(jnp.asarray(sig)))
    assert got.shape == (3, 3000, 7)
    for i, band in enumerate(bands):
        b, a = butter(1, band, btype="bandpass", output="ba", fs=fs)
        ref = lfilter(b, a, sig, axis=0)
        np.testing.assert_allclose(got[i], ref, rtol=1e-7, atol=1e-9)


def test_dc_removed_sing_vec_degenerate_top_pair():
    """Exactly tied top eigenvalues (real for float32-exact covariances of
    structured spike trains) must yield a FINITE unit vector — the empty
    bisection bracket used to produce 0/0 = NaN, which silently zeroed
    whole unipolar designs downstream."""
    rng = np.random.default_rng(3)
    n = 8
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    D = np.array([2.0, 2.0, 1.0, 0.7, 0.5, 0.3, 0.2, 0.1])
    C = (Q * D) @ Q.T
    C = (C + C.T) / 2
    v = np.asarray(dc_removed_sing_vec(jnp.asarray(C)))
    assert np.all(np.isfinite(v)), v
    np.testing.assert_allclose(np.linalg.norm(v), 1.0, rtol=1e-6)

    # float32 path too (the production dtype on device)
    v32 = np.asarray(dc_removed_sing_vec(jnp.asarray(C, jnp.float32)))
    assert np.all(np.isfinite(v32)), v32
    np.testing.assert_allclose(np.linalg.norm(v32), 1.0, rtol=1e-5)
