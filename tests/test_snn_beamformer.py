"""End-to-end golden test of the SNN Hilbert beamformer against a NumPy/SciPy
port of the reference (micloc/snn_beamformer.py)."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
from scipy.signal import hilbert, lfilter, butter, find_peaks

from haghighatshoarmuir2024 import CenterCircularArray
from haghighatshoarmuir2024.models.snn_beamformer import SNNBeamformer

FS = 48_000


def _ref_rzcc(sig_in, robust_width, bipolar):
    spikes = np.zeros_like(sig_in).T
    for chan, sig_chan in enumerate(sig_in.T):
        peaks, _ = find_peaks(np.cumsum(sig_chan), distance=robust_width)
        spikes[chan, peaks] = 1
        if bipolar:
            valleys, _ = find_peaks(-np.cumsum(sig_chan), distance=robust_width)
            spikes[chan, valleys] = -1
    return spikes.T


def _ref_lif_ir(tau_syn, tau_mem, T):
    t = np.arange(T) / FS
    h = (t / tau_syn) * np.exp(-t / tau_syn)
    h = h / np.sum(h)
    eff = np.sum(np.cumsum(h) < 0.999)
    return h[:eff]


def _ref_dc_removed(C, rel_prec=1e-8):
    U, D, _ = np.linalg.svd(C)
    theta = U.T @ np.ones(C.shape[0])
    u_min, u_max = D[1], D[0]
    while (u_max - u_min) / u_min >= rel_prec:
        u_mid = (u_min + u_max) / 2
        if np.sum(theta**2 / (D - u_mid)) < 0.0:
            u_min = u_mid
        else:
            u_max = u_mid
    root = (u_min + u_max) / 2.0
    v = U @ (theta / (D - root))
    return v / np.linalg.norm(v)


def _ref_design(geometry, kernel, bandpass, tau_vec, robust_width, bipolar, time_temp, sig_temp, doa_list):
    """Port of micloc/snn_beamformer.py:82-211."""
    time_interp = np.arange(time_temp.min(), time_temp.max(), step=1 / FS)
    sig_temp = np.interp(time_interp, time_temp, sig_temp)
    time_temp = time_interp

    neuron_ir = _ref_lif_ir(tau_vec[0], tau_vec[1], len(time_temp))
    b, a = bandpass
    bf_mat = []
    for doa in doa_list:
        delays = -geometry.r_vec * np.cos(geometry.theta_vec - doa) / geometry.speed
        delays -= delays.min()
        time_delayed = time_temp.reshape(1, -1) - delays.reshape(-1, 1)
        time_delayed[time_delayed < time_temp.min()] = time_temp.min()
        sig_in_vec = (
            np.interp(time_delayed.ravel(), time_temp, sig_temp)
            .reshape(time_delayed.shape)
            .T
        )
        sig_in_vec_h = np.roll(sig_in_vec, len(kernel) // 2, axis=0) + 1j * lfilter(
            kernel, [1], sig_in_vec, axis=0
        )
        sig_in_vec_h = lfilter(b, a, sig_in_vec_h, axis=0)
        sig_in_real = np.hstack([np.real(sig_in_vec_h), np.imag(sig_in_vec_h)])
        spikes_vec = _ref_rzcc(sig_in_real, robust_width, bipolar)
        vmem_vec = lfilter(neuron_ir, [1], spikes_vec, axis=0)
        vmem_stable = vmem_vec[vmem_vec.shape[0] // 4 :, :]
        C = vmem_stable.T @ vmem_stable / vmem_stable.shape[0]
        if not bipolar:
            bf_vec = _ref_dc_removed(C, rel_prec=1e-8)
        else:
            m = C.shape[0] // 2
            C_comp = (C[:m, :m] + C[m:, m:]) / 2 + 1j * (C[:m, m:] + C[m:, :m].T) / 2
            U, D, _ = np.linalg.svd(C_comp)
            bf_vec = np.concatenate([np.real(U[:, 0]), np.imag(U[:, 0])])
        bf_mat.append(bf_vec)
    return np.asarray(bf_mat).T


@pytest.fixture(scope="module", params=[True, False], ids=["bipolar", "unipolar"])
def setup(request):
    bipolar = request.param
    geometry = CenterCircularArray(radius=4.5e-2, num_mic=7)
    freq_mid = 1750.0
    tau = 1 / (2 * np.pi * freq_mid)
    snn = SNNBeamformer(
        geometry,
        kernel_duration=10e-3,
        freq_range=(1600.0, 1900.0),
        tau_vec=[tau, tau],
        bipolar_spikes=bipolar,
        fs=FS,
        design_chunk=8,
    )
    time_temp = np.arange(0, 0.25, 1 / FS)
    sig_temp = np.sin(2 * np.pi * freq_mid * time_temp)
    doa_list = np.linspace(-np.pi, np.pi, 17)
    return geometry, snn, time_temp, sig_temp, doa_list, bipolar


def test_design_matches_reference(setup):
    geometry, snn, time_temp, sig_temp, doa_list, bipolar = setup
    got = np.asarray(snn.design_from_template((time_temp, sig_temp), doa_list))
    ref = _ref_design(
        geometry,
        snn.kernel,
        snn.bandpass_filter,
        snn.tau_vec,
        snn.robust_width,
        bipolar,
        time_temp,
        sig_temp,
        doa_list,
    )
    assert got.shape == ref.shape == (14, len(doa_list))
    for i in range(len(doa_list)):
        g, r = got[:, i], ref[:, i]
        if bipolar:
            # complex rotation invariance: compare as complex vectors up to phase
            m = 7
            gc, rc = g[:m] + 1j * g[m:], r[:m] + 1j * r[m:]
            inner = np.vdot(rc, gc)
            assert abs(abs(inner) - 1.0) < 1e-5, f"doa {i}: |inner|={abs(inner)}"
        else:
            inner = abs(np.dot(g, r))
            assert abs(inner - 1.0) < 1e-5, f"doa {i}: |inner|={inner}"


def test_apply_to_signal_matches_reference(setup):
    geometry, snn, time_temp, sig_temp, doa_list, bipolar = setup
    bf_mat = snn.design_from_template((time_temp, sig_temp), doa_list)

    rng = np.random.default_rng(1)
    T = 6000
    tv = np.arange(T) / FS
    sig_in = rng.standard_normal((T, 7))

    got = np.asarray(snn.apply_to_signal(bf_mat, (tv, sig_in)))

    # reference port of apply_to_signal (micloc/snn_beamformer.py:283-370)
    kernel = snn.kernel
    b, a = snn.bandpass_filter
    sig_h = np.roll(sig_in, len(kernel) // 2, axis=0) + 1j * lfilter(kernel, [1], sig_in, axis=0)
    sig_h = lfilter(b, a, sig_h, axis=0)
    sig_real = np.hstack([np.real(sig_h), np.imag(sig_h)])
    spikes = _ref_rzcc(sig_real, snn.robust_width, bipolar)
    neuron_ir = _ref_lif_ir(snn.tau_vec[0], snn.tau_vec[1], T)
    vmem = lfilter(neuron_ir, [1], spikes, axis=0)
    ref = vmem @ np.asarray(bf_mat)

    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-7)


def test_snn_doa_estimation(setup):
    """SNN pipeline localizes a noisy tone (folded metric, reference
    target_snn_localization.py pattern)."""
    geometry, snn, time_temp, sig_temp, _, bipolar = setup
    grid = np.linspace(-np.pi, np.pi, 113)
    bf_mat = snn.design_from_template((time_temp, sig_temp), grid)
    key = jax.random.PRNGKey(3)
    errs = []
    for doa_true in (-1.5, 0.4, 2.2):
        key, sub = jax.random.split(key)
        out = snn.apply_to_template(bf_mat, (time_temp, sig_temp, doa_true), snr_db=10.0, key=sub)
        power = np.mean(np.asarray(out) ** 2, axis=0)
        est = grid[int(np.argmax(power))]
        errs.append(np.rad2deg(np.arcsin(abs(np.sin(est - doa_true)))))
    assert max(errs) < 4.0, errs


def test_design_high_fmid_band_completes():
    """Regression: XLA:CPU (jaxlib 0.9.0) corrupts memory when the design
    body runs its LIF FIR through the direct conv_general_dilated path with
    a short kernel (< ~40 taps — any f_mid >= ~2 kHz band, e.g. the
    reference's own 2300-2600 Hz live-benchmark band): segfaults at execution
    or in a LATER unrelated compile.  fir_filter's auto dispatch never picks
    "direct" on CPU (ops/fir.py); this pins that a high-f_mid design
    completes and produces a finite unit-norm matrix."""
    import numpy as np

    from haghighatshoarmuir2024 import CenterCircularArray
    from haghighatshoarmuir2024.models.snn_beamformer import SNNBeamformer

    fs = 48_000
    f_lo, f_hi = 2300.0, 2600.0
    f_mid = 0.5 * (f_lo + f_hi)
    tau = 1 / (2 * np.pi * f_mid)
    geo = CenterCircularArray(radius=4.5e-2, num_mic=7)
    bf = SNNBeamformer(
        geometry=geo, kernel_duration=10e-3, freq_range=(f_lo, f_hi),
        tau_vec=[tau, tau], bipolar_spikes=True, fs=fs, design_chunk=4,
    )
    t = np.arange(0, 0.1, 1 / fs)
    sig = np.sin(2 * np.pi * f_mid * t)
    m = np.asarray(bf.design_from_template((t, sig), np.linspace(-np.pi, np.pi, 9)))
    assert m.shape == (14, 9)
    assert np.all(np.isfinite(m))
    np.testing.assert_allclose(np.linalg.norm(m, axis=0), 1.0, atol=1e-5)
