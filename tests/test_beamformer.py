"""End-to-end golden test of the Hilbert beamformer against a NumPy/SciPy port
of the reference design + apply pipeline (micloc/beamformer.py)."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
from scipy.signal import hilbert, lfilter, butter

from haghighatshoarmuir2024 import CenterCircularArray
from haghighatshoarmuir2024.models.beamformer import Beamformer

FS = 48_000


def _ref_design(geometry, kernel, bandpass, time_temp, sig_temp, doa_list):
    """Direct port of micloc/beamformer.py:73-163 (no interference removal)."""
    time_interp = np.arange(time_temp.min(), time_temp.max(), step=1 / FS)
    sig_interp = np.interp(time_interp, time_temp, sig_temp)
    sig_temp, time_temp = sig_interp, time_interp

    cov_mat_list = []
    for doa in doa_list:
        delays = -geometry.r_vec * np.cos(geometry.theta_vec - doa) / geometry.speed
        delays -= delays.min()
        sig_in_vec = []
        for delay in delays:
            time_delay = time_temp - delay
            time_delay[time_delay < time_temp.min()] = time_temp.min()
            sig_in_vec.append(np.interp(time_delay, time_temp, sig_temp))
        sig_in_vec = np.asarray(sig_in_vec).T
        sig_in_vec_h = np.roll(sig_in_vec, len(kernel) // 2, axis=0) + 1j * lfilter(
            kernel, [1], sig_in_vec, axis=0
        )
        stable_part = min([len(kernel), sig_in_vec_h.shape[0] // 2])
        s = sig_in_vec_h[stable_part:, :]
        cov_mat_list.append(s.conj().T @ s / s.shape[0])

    bf_mat = []
    for cov_mat in cov_mat_list:
        U, D, _ = np.linalg.svd(cov_mat)
        bf_mat.append(U[:, 0])
    return np.asarray(bf_mat).T, cov_mat_list


def _ref_apply(kernel, bandpass, bf_mat, sig_in):
    """Port of micloc/beamformer.py:260-292."""
    sig_h = np.roll(sig_in, len(kernel) // 2, axis=0) + 1j * lfilter(
        kernel, [1], sig_in, axis=0
    )
    b, a = bandpass
    sig_h = lfilter(b, a, sig_h, axis=0)
    return sig_h @ bf_mat.conj()


@pytest.fixture(scope="module")
def setup():
    geometry = CenterCircularArray(radius=4.5e-2, num_mic=7)
    kernel_duration = 10e-3
    freq_design = 1750.0
    freq_range = (1600.0, 1900.0)
    duration = 0.25
    time_temp = np.arange(0, duration, 1 / FS)
    sig_temp = np.sin(2 * np.pi * freq_design * time_temp)
    doa_list = np.linspace(-np.pi, np.pi, 31)
    bf = Beamformer(geometry, kernel_duration, freq_range, fs=FS, design_chunk=16)
    return geometry, bf, time_temp, sig_temp, doa_list


def test_design_covariances_match_reference(setup):
    geometry, bf, time_temp, sig_temp, doa_list = setup
    bf_mat, cov = bf.design_from_template((time_temp, sig_temp), doa_list)
    ref_bf, ref_cov = _ref_design(
        geometry, bf.kernel, bf.bandpass_filter, time_temp, sig_temp, doa_list
    )
    cov = np.asarray(cov)
    for i in range(len(doa_list)):
        np.testing.assert_allclose(cov[i], ref_cov[i], rtol=1e-6, atol=1e-8)

    # beamforming vectors match up to a unit phase
    bf_np = np.asarray(bf_mat)
    for i in range(len(doa_list)):
        inner = np.vdot(ref_bf[:, i], bf_np[:, i])
        assert abs(abs(inner) - 1.0) < 1e-6, f"doa {i}: |<ref,got>|={abs(inner)}"


def test_apply_to_signal_matches_reference(setup):
    geometry, bf, time_temp, sig_temp, doa_list = setup
    bf_mat, _ = bf.design_from_template((time_temp, sig_temp), doa_list)
    rng = np.random.default_rng(0)
    sig_in = rng.standard_normal((6000, 7))
    got = np.asarray(bf.apply_to_signal(bf_mat, sig_in))
    ref = _ref_apply(bf.kernel, bf.bandpass_filter, np.asarray(bf_mat), sig_in)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-8)


def test_doa_estimation_accuracy(setup):
    """The localization-demo power-argmax estimate recovers the true DoA
    (pattern of micloc/localization_demo.py:158-185)."""
    geometry, bf, time_temp, sig_temp, doa_list = setup
    doa_grid = np.linspace(-np.pi, np.pi, 225)
    bf_mat, _ = bf.design_from_template((time_temp, sig_temp), doa_grid)

    key = jax.random.PRNGKey(42)
    for doa_true in (-2.0, 0.3, 2.5):
        key, sub = jax.random.split(key)
        out = bf.apply_to_template(
            bf_mat, (time_temp, sig_temp, doa_true), snr_db=10.0, key=sub
        )
        power = np.mean(np.abs(np.asarray(out)) ** 2, axis=0)
        doa_est = doa_grid[np.argmax(power)]
        err = np.arcsin(np.abs(np.sin(doa_est - doa_true)))
        assert err < np.deg2rad(3.0), f"doa {doa_true}: err {np.rad2deg(err)} deg"


def test_interference_removal_design_matches_scipy(setup):
    """Golden test of the generalized-eigenproblem design against
    ``scipy.linalg.eigh(C, C_sum - C)`` with the reference's mean-diag/10
    loading (micloc/beamformer.py:165-190): per-DoA the Cholesky-whitened
    eigensolver in ops/linalg.generalized_top_eigvec must return the same
    top generalized eigenvector up to a unit phase."""
    import scipy.linalg

    geometry, bf, time_temp, sig_temp, doa_list = setup
    bf_mat, cov = bf.design_from_template(
        (time_temp, sig_temp), doa_list, interference_removal=True
    )
    bf_np = np.asarray(bf_mat)
    assert bf_np.shape == (7, len(doa_list))
    norms = np.linalg.norm(bf_np, axis=0)
    np.testing.assert_allclose(norms, 1.0, rtol=1e-6)

    # reference design in float64/complex128 scipy, from the SAME covariances
    cov = np.asarray(cov).astype(np.complex128)
    cov_sum = cov.sum(axis=0)
    cov_sum += np.diag(
        np.mean(np.diag(cov_sum)).real * np.ones(cov_sum.shape[0])
    ) / 10.0
    for i in range(len(doa_list)):
        _, U = scipy.linalg.eigh(cov[i], cov_sum - cov[i])
        v_ref = U[:, -1] / np.linalg.norm(U[:, -1])
        inner = abs(np.vdot(v_ref, bf_np[:, i]))
        assert abs(inner - 1.0) < 1e-6, f"doa {i}: |<ref,got>|={inner}"


def test_generalized_top_eigvec_golden():
    """Unit-level golden: random Hermitian PD pencils, complex and real,
    vs scipy.linalg.eigh's last column (micloc/beamformer.py:176-187)."""
    import scipy.linalg

    from haghighatshoarmuir2024.ops.linalg import generalized_top_eigvec

    rng = np.random.default_rng(7)
    for trial in range(8):
        n = 7
        if trial % 2 == 0:
            A = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
            B = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
        else:
            A = rng.standard_normal((n, n))
            B = rng.standard_normal((n, n))
        C = A @ A.conj().T / n
        # PD right-hand side with a realistic condition spread
        Bm = B @ B.conj().T / n + 0.05 * np.eye(n)
        got = np.asarray(generalized_top_eigvec(jnp.asarray(C), jnp.asarray(Bm)))
        _, U = scipy.linalg.eigh(C, Bm)
        v_ref = U[:, -1] / np.linalg.norm(U[:, -1])
        inner = abs(np.vdot(v_ref, got))
        assert abs(inner - 1.0) < 1e-6, f"trial {trial}: |<ref,got>|={inner}"
