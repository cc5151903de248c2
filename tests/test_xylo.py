"""Tests of the quantized Xylo deployment layer: spec assembly, quantization,
integer LIF dynamics invariants, and end-to-end quantized DoA accuracy."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp

from haghighatshoarmuir2024 import CenterCircularArray
from haghighatshoarmuir2024.models.xylo import (
    Demo,
    XyloSim,
    build_localization_spec,
    dash_to_tau,
    global_quantize,
    sim_hidden_batch,
    tau_to_dash,
    truncate_fan_out,
    validate_config,
)
from haghighatshoarmuir2024.ops.interp import signal_from_template

FS = 48_000


# --------------------------------------------------------------------- units
def test_spec_block_diagonal_and_bipolar_stack():
    rng = np.random.default_rng(0)
    bf1 = rng.standard_normal((14, 9))
    bf2 = rng.standard_normal((14, 9))
    tau = 1 / (2 * np.pi * 1750)
    spec = build_localization_spec(
        [bf1, bf2], [(tau, tau), (tau, tau)], fs=FS, bipolar_spikes=True
    )
    assert spec.w_in.shape == (2 * 28, 18)
    # block structure (micloc/xylo_snn_localization.py:195-208)
    np.testing.assert_allclose(spec.w_in[:14, :9], bf1)
    np.testing.assert_allclose(spec.w_in[14:28, 9:], bf2)
    np.testing.assert_allclose(spec.w_in[14:28, :9], 0)
    # +/- stack (micloc/xylo_snn_localization.py:210-216)
    np.testing.assert_allclose(spec.w_in[28:], -spec.w_in[:28])
    # tau rescale by fs*dt (micloc/xylo_snn_localization.py:183-188)
    np.testing.assert_allclose(spec.tau_syn, tau * FS * 1e-3)
    # uniform negative recurrence
    np.testing.assert_allclose(spec.w_rec, -0.1 / 18)


def test_tau_dash_roundtrip():
    dt = 1e-3
    taus = np.array([1e-3, 4.4e-3, 1.6e-2, 0.13])
    dash = tau_to_dash(taus, dt)
    assert dash.dtype == np.int32
    eff = dash_to_tau(dash, dt)
    # within a factor of sqrt(2) (dash is a log2 rounding)
    assert np.all(eff / taus < np.sqrt(2) + 1e-9)
    assert np.all(taus / eff < np.sqrt(2) + 1e-9)


def test_global_quantize_scales_weights_and_threshold_together():
    rng = np.random.default_rng(1)
    bf = rng.standard_normal((14, 9)) * 0.3
    tau = 1 / (2 * np.pi * 1750)
    spec = build_localization_spec([bf], [(tau, tau)], fs=FS, bipolar_spikes=False)
    cfg = global_quantize(spec)
    # the global max |weight| (here the all-ones readout) maps onto 127
    global_max = max(np.abs(cfg.w_in).max(), np.abs(cfg.w_rec).max(), np.abs(cfg.w_out).max())
    assert global_max == 127
    # all weights share one scale
    np.testing.assert_allclose(cfg.w_in, np.round(spec.w_in * cfg.weight_scale))
    # threshold carries the same scale
    assert cfg.threshold[0] == round(1.0 * cfg.weight_scale)
    assert not validate_config(cfg)


def test_validate_config_hardware_limits():
    rng = np.random.default_rng(2)
    bf = rng.standard_normal((14, 9))
    tau = 1 / (2 * np.pi * 1750)
    spec = build_localization_spec([bf], [(tau, tau)], fs=FS, bipolar_spikes=True)
    cfg = global_quantize(spec)
    problems = validate_config(cfg, hardware=True)
    assert any("16 input channels" in p for p in problems)  # 28 > 16


def test_validate_config_resource_limits_waivable():
    """The chip RESOURCE caps (hidden-neuron count) can be waived for
    software deployments (the integer simulator has no neuron limit — e.g. the
    3-band x 449-grid network the reference could only run one band at a
    time, snn_localization_benchmark.py:556-562); numeric quantization-range
    checks stay fatal either way."""
    rng = np.random.default_rng(4)
    bf = rng.standard_normal((14, 600))  # 600 hidden per band, 2 bands = 1200
    tau = 1 / (2 * np.pi * 1750)
    spec = build_localization_spec(
        [bf, bf], [(tau, tau), (tau, tau)], fs=FS, bipolar_spikes=True
    )
    cfg = global_quantize(spec)
    assert cfg.n_hidden == 1200
    problems = validate_config(cfg)
    assert any("hidden neurons exceed" in p for p in problems)
    assert not validate_config(cfg, resource_limits=False)

    from haghighatshoarmuir2024.models.xylo.quantize import XyloConfig

    bad = XyloConfig(
        w_in=np.full((2, 3), 300, np.int32),  # beyond the 8-bit weight range
        w_rec=np.zeros((3, 3), np.int32),
        w_out=np.ones((3, 1), np.int32),
        dash_syn=np.ones(3, np.int32),
        dash_mem=np.ones(3, np.int32),
        dash_syn_out=np.ones(1, np.int32),
        dash_mem_out=np.ones(1, np.int32),
        threshold=np.ones(3, np.int32),
        threshold_out=np.ones(1, np.int32),
        dt=1e-3,
        weight_scale=1.0,
    )
    assert validate_config(bad, resource_limits=False)  # range check still fires


def test_truncate_fan_out():
    rng = np.random.default_rng(3)
    w = rng.standard_normal((5, 100))
    wt = truncate_fan_out(w, max_fan_out=63)
    assert np.count_nonzero(wt, axis=1).max() <= 63
    # kept entries are the largest in magnitude
    for r in range(5):
        kept = np.abs(wt[r][wt[r] != 0])
        dropped = np.abs(w[r][wt[r] == 0])
        assert kept.min() >= dropped.max()


# ---------------------------------------------------------------- integer LIF
def _single_neuron_cfg(dash=2, threshold=100):
    from haghighatshoarmuir2024.models.xylo.quantize import XyloConfig

    return XyloConfig(
        w_in=np.array([[64]], np.int32),
        w_rec=np.zeros((1, 1), np.int32),
        w_out=np.ones((1, 1), np.int32),
        dash_syn=np.array([dash], np.int32),
        dash_mem=np.array([dash], np.int32),
        dash_syn_out=np.array([dash], np.int32),
        dash_mem_out=np.array([dash], np.int32),
        threshold=np.array([threshold], np.int32),
        threshold_out=np.array([1], np.int32),
        dt=1e-3,
        weight_scale=64.0,
    )


def test_integer_lif_decay_and_fire():
    """One input spike injects w, isyn/vmem decay by 2^-dash per step, the
    neuron fires when vmem crosses threshold and subtract-resets."""
    cfg = _single_neuron_cfg(dash=2, threshold=100)
    sim = XyloSim(cfg)
    T = 50
    spikes_in = np.zeros((T, 1), np.int32)
    spikes_in[0, 0] = 1
    out, state, rec = sim(spikes_in, record=True)
    isyn = np.asarray(rec["Isyn"])[:, 0]
    vmem = np.asarray(rec["Vmem"])[:, 0]
    spk = np.asarray(rec["Spikes"])[:, 0]

    # decay acts on the previous state, then input integrates:
    # step 0: isyn = 0 - 0 + 64 = 64; step 1: 64 - (64>>2) = 48; step 2: 48-12=36
    assert isyn[0] == 64
    assert isyn[1] == 48
    assert isyn[2] == 36
    # vmem accumulates isyn, crosses the threshold, fires, subtract-resets
    assert spk.sum() >= 1
    fire_t = int(np.argmax(spk))
    # membrane recorded after the subtract-reset is below threshold
    assert vmem[fire_t] < 100
    # and the pre-reset membrane (vmem + threshold) had crossed it
    assert vmem[fire_t] + 100 >= 100


def test_integer_lif_rate_monotonic_in_input():
    """More input spikes -> more hidden spikes (sanity of the quantized path)."""
    cfg = _single_neuron_cfg(dash=3, threshold=200)
    rng = np.random.default_rng(0)
    T = 2000
    rates = []
    for p in (0.05, 0.2, 0.5):
        sim = XyloSim(cfg)
        spikes_in = (rng.random((T, 1)) < p).astype(np.int32)
        _, _, rec = sim(spikes_in, record=False)
        rates.append(int(np.asarray(rec["Spikes"]).sum()))
    assert rates[0] < rates[1] < rates[2], rates


def test_state_carries_across_calls_and_reset():
    cfg = _single_neuron_cfg(dash=4, threshold=30_000)
    sim = XyloSim(cfg)
    spikes_in = np.ones((10, 1), np.int32)
    _, state1, _ = sim(spikes_in)
    v1 = int(state1["hidden"][1][0])
    _, state2, _ = sim(spikes_in)
    v2 = int(state2["hidden"][1][0])
    assert v2 > v1  # state carried
    sim.reset_state()
    _, state3, _ = sim(spikes_in)
    assert int(state3["hidden"][1][0]) == v1  # reset reproduces first call


def test_sim_hidden_batch_matches_single():
    cfg = _single_neuron_cfg(dash=2, threshold=150)
    rng = np.random.default_rng(1)
    batch = (rng.random((3, 500, 1)) < 0.3).astype(np.int32)
    got = np.asarray(sim_hidden_batch(cfg, batch))
    for i in range(3):
        sim = XyloSim(cfg)
        _, _, rec = sim(batch[i])
        np.testing.assert_array_equal(got[i], np.asarray(rec["Spikes"]))


def test_evolve_to_hidden_bypasses_input_weights():
    cfg = _single_neuron_cfg(dash=2, threshold=100)
    sim = XyloSim(cfg)
    current = np.full((30, 1), 64, np.int32)
    spikes, _, rec = sim.evolve_to_hidden(current, record=True)
    sim2 = XyloSim(cfg)
    spikes_in = np.ones((30, 1), np.int32)  # w_in = 64 -> same current
    _, _, rec2 = sim2(spikes_in, record=True)
    np.testing.assert_array_equal(np.asarray(rec["Isyn"]), np.asarray(rec2["Isyn"]))


# ---------------------------------------------------------------- end-to-end
@pytest.fixture(scope="module", params=[True, False], ids=["bipolar", "unipolar"])
def demo(request):
    geometry = CenterCircularArray(radius=4.5e-2, num_mic=7)
    return Demo(
        geometry=geometry,
        freq_bands=[[1600, 1900]],
        doa_list=np.linspace(-np.pi, np.pi, 113),
        recording_duration=0.25,
        kernel_duration=10e-3,
        bipolar_spikes=request.param,
        fs=FS,
        design_chunk=16,
    ), request.param


def test_spike_encoding_shape_and_polarity(demo):
    d, bipolar = demo
    rng = np.random.default_rng(0)
    sig = rng.standard_normal((4000, 7))
    spikes = np.asarray(d.spike_encoding(sig))
    exp_ch = 14 * 1 * (2 if bipolar else 1)
    assert spikes.shape == (4000, exp_ch)
    assert spikes.min() >= 0  # polarity split makes everything nonnegative
    if bipolar:
        # a channel pair never fires + and - at the same step
        pos, neg = spikes[:, :14], spikes[:, 14:]
        assert np.all(pos * neg == 0)


def test_wrong_channel_count_raises(demo):
    """Round-5 verify finding: the per-channel encode silently processed a
    3-channel frame against a 7-mic design; both entry points must reject
    mismatched widths with a clean ValueError."""
    d, _ = demo
    with pytest.raises(ValueError, match="mic geometry"):
        d.spike_encoding(np.zeros((100, 3), np.float32))
    with pytest.raises(ValueError, match="mic geometry"):
        d.forward(np.zeros((100, 3), np.float32))


def test_quantized_doa_accuracy(demo):
    """Full quantized chain localizes a noisy tone.

    Contract mirrors the reference's own benchmark methodology
    (paper_plots/snn_localization_benchmark.py:595-660): the reference scores
    MAE against the *run median* (it never measures absolute bias, which the
    dash/weight quantization introduces at the few-degree level), so we check
    (a) a coarse absolute bound and (b) tight repeatability across noise
    realizations — the quantity the committed benchmark data constrains
    (raw robust std 1-3 deg)."""
    d, bipolar = demo
    t = np.arange(0, 0.25, 1 / FS)
    sig = np.sin(2 * np.pi * 1750 * t)
    key = jax.random.PRNGKey(0)
    for doa_true in (-1.8, 0.6):
        ests = []
        for _ in range(4):
            key, sub = jax.random.split(key)
            sig_in = signal_from_template(d.geometry, t, sig, doa_true, fs=FS)
            noise = 0.3 * jax.random.normal(sub, sig_in.shape)
            spikes = d.spike_encoding(np.asarray(sig_in + noise))
            hidden = d.xylo_process(spikes)
            rate = d.extract_rate(hidden)
            ests.append(float(d.estimate_doa_from_rate(rate, "peak")))
        ests = np.asarray(ests)
        med = np.median(ests)
        bias = np.rad2deg(np.arcsin(abs(np.sin(med - doa_true))))
        scatter = np.rad2deg(
            np.median(np.abs(np.arcsin(np.sin(ests - med)))) * np.sqrt(np.pi / 2)
        )
        assert bias < 25.0, (doa_true, bias)
        assert scatter < 3.0, (doa_true, scatter)


def test_forward_jit_matches_staged(demo):
    d, bipolar = demo
    t = np.arange(0, 0.25, 1 / FS)
    sig = np.sin(2 * np.pi * 1750 * t)
    sig_in = np.asarray(signal_from_template(d.geometry, t, sig, 0.6, fs=FS))
    doa_j, rate_j = d.forward(sig_in)
    spikes = d.spike_encoding(sig_in)
    hidden = d.xylo_process(spikes)
    rate_s = d.extract_rate(hidden)
    np.testing.assert_allclose(
        np.asarray(rate_j), np.asarray(rate_s), rtol=1e-5, atol=1e-6
    )
    est = float(d.estimate_doa_from_rate(rate_s, "peak"))
    assert float(doa_j) == pytest.approx(est)


def test_forward_batch(demo):
    d, bipolar = demo
    t = np.arange(0, 0.25, 1 / FS)
    sig = np.sin(2 * np.pi * 1750 * t)
    sig_in = np.asarray(signal_from_template(d.geometry, t, sig, 0.6, fs=FS))
    batch = np.stack([sig_in, sig_in * 0.5])
    doa_b, rate_b = d.forward_batch(batch)
    assert np.asarray(doa_b).shape == (2,)
    doa_s, rate_s = d.forward(sig_in)
    np.testing.assert_allclose(np.asarray(rate_b[0]), np.asarray(rate_s), rtol=1e-5, atol=1e-6)


def test_estimate_doa_methods(demo):
    d, _ = demo
    rate = np.zeros(113)
    rate[60] = 10.0
    for method in ("peak", "periodic_ml", "trimmed_periodic_ml"):
        est = float(d.estimate_doa_from_rate(rate, method))
        err = abs(np.angle(np.exp(1j * (est - d.doa_list[60]))))
        assert err < 0.2, (method, est)
    with pytest.raises(ValueError):
        d.estimate_doa_from_rate(rate, "nope")


def test_multiband_pipeline():
    """Two frequency bands: block-diagonal weights, per-band encoders, rate
    folding over bands (micloc/xylo_snn_localization.py:195-208,388-398)."""
    geometry = CenterCircularArray(radius=4.5e-2, num_mic=7)
    grid = np.linspace(-np.pi, np.pi, 33)
    d = Demo(
        geometry=geometry,
        freq_bands=[[1600, 1900], [1900, 2200]],
        doa_list=grid,
        recording_duration=0.1,
        kernel_duration=5e-3,
        bipolar_spikes=True,
        fs=FS,
        use_cache=False,
        design_chunk=16,
    )
    assert d.xylo_config.n_hidden == 2 * 33
    assert d.xylo_config.n_in == 2 * 2 * 14  # bipolar x bands x 2M
    t = np.arange(0, 0.1, 1 / FS)
    sig = np.sin(2 * np.pi * 1750 * t) + np.sin(2 * np.pi * 2050 * t)
    sig_in = np.asarray(signal_from_template(d.geometry, t, sig, 0.5, fs=FS))
    spikes = np.asarray(d.spike_encoding(sig_in))
    assert spikes.shape == (4800, 2 * 2 * 14)
    doa, rate = d.forward(sig_in)
    assert np.asarray(rate).shape == (33,)
    err = np.rad2deg(np.arcsin(abs(np.sin(float(doa) - 0.5))))
    assert err < 35.0  # coarse grid + quantized path: sanity bound


def test_matched_profile_estimator():
    """Calibrated profile matching removes the integer pipeline's absolute
    bias: noiseless estimates land within one grid step of the truth (the
    reference's peak/argmax class carries a multi-degree warp)."""
    geometry = CenterCircularArray(radius=4.5e-2, num_mic=7)
    grid = np.linspace(-np.pi, np.pi, 65)
    d = Demo(
        geometry=geometry,
        freq_bands=[[1600, 1900]],
        doa_list=grid,
        recording_duration=0.1,
        kernel_duration=5e-3,
        bipolar_spikes=True,
        fs=FS,
        use_cache=False,
        design_chunk=16,
    )
    with pytest.raises(ValueError):
        d.estimate_doa_from_rate(np.zeros(65), "matched")
    d.calibrate_profiles(batch=16, use_cache=False)
    t = np.arange(0, 0.1, 1 / FS)
    sig = np.sin(2 * np.pi * 1750 * t)
    grid_step = np.rad2deg(grid[1] - grid[0])
    errs_m = []
    for doa_true in (-2.0, -0.5, 1.1, 2.6):
        sig_in = np.asarray(signal_from_template(geometry, t, sig, doa_true, fs=FS))
        _, rate = d.forward(sig_in)
        est = float(d.estimate_doa_from_rate(rate, "matched"))
        errs_m.append(np.rad2deg(np.arcsin(abs(np.sin(est - doa_true)))))
    assert max(errs_m) <= 1.5 * grid_step, errs_m


def test_matched_profile_estimator_unipolar():
    """Unipolar-path calibration regression: the matched
    estimator must localize noiseless and mildly noisy tones within a couple
    of grid steps on the unipolar (DC-removed singular vector) design, where
    the reference-parity peak estimator carries an ~8-12 deg warp
    (experiments/target_xylo_localization.py --unipolar; RESULTS.md)."""
    geometry = CenterCircularArray(radius=4.5e-2, num_mic=7)
    grid = np.linspace(-np.pi, np.pi, 65)
    d = Demo(
        geometry=geometry,
        freq_bands=[[1600, 1900]],
        doa_list=grid,
        recording_duration=0.1,
        kernel_duration=5e-3,
        bipolar_spikes=False,
        fs=FS,
        use_cache=False,
        design_chunk=16,
    )
    d.calibrate_profiles(batch=16, use_cache=False)
    t = np.arange(0, 0.1, 1 / FS)
    sig = np.sin(2 * np.pi * 1750 * t)
    grid_step = np.rad2deg(grid[1] - grid[0])
    key = jax.random.PRNGKey(1)
    errs_clean, errs_noisy = [], []
    for doa_true in (-2.0, -0.5, 1.1, 2.6):
        sig_in = np.asarray(signal_from_template(geometry, t, sig, doa_true, fs=FS))
        _, rate = d.forward(sig_in)
        est = float(d.estimate_doa_from_rate(rate, "matched"))
        errs_clean.append(np.rad2deg(np.arcsin(abs(np.sin(est - doa_true)))))
        key, sub = jax.random.split(key)
        noisy = sig_in + 0.1 * np.asarray(jax.random.normal(sub, sig_in.shape), np.float64)
        _, rate_n = d.forward(noisy)
        est_n = float(d.estimate_doa_from_rate(rate_n, "matched"))
        errs_noisy.append(np.rad2deg(np.arcsin(abs(np.sin(est_n - doa_true)))))
    assert max(errs_clean) <= 2.0 * grid_step, errs_clean
    assert max(errs_noisy) <= 3.0 * grid_step, errs_noisy


def test_band_stacked_matched_estimator():
    """Band-stacked matched profiles (calibrate_profiles(band_stacked=True)):
    the G x (F*G) table matches the unfolded per-band rates; noiseless
    estimates land within one grid step, the stacked table has F*G columns,
    and the returned rate keeps the reference-folded (B, G) contract."""
    geometry = CenterCircularArray(radius=4.5e-2, num_mic=7)
    grid = np.linspace(-np.pi, np.pi, 33)
    d = Demo(
        geometry=geometry,
        freq_bands=[[1600, 1900], [1900, 2200]],
        doa_list=grid,
        recording_duration=0.1,
        kernel_duration=5e-3,
        bipolar_spikes=True,
        fs=FS,
        use_cache=False,
        design_chunk=16,
    )
    t = np.arange(0, 0.1, 1 / FS)
    sig = np.sin(2 * np.pi * 1750 * t) + np.sin(2 * np.pi * 2050 * t)
    prof = np.asarray(d.calibrate_profiles(template=(t, sig), use_cache=False,
                                           band_stacked=True))
    assert prof.shape == (33, 2 * 33)
    # rows are mean-removed and unit-norm (correlation matching)
    np.testing.assert_allclose(prof.mean(axis=1), 0.0, atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(prof, axis=1), 1.0, atol=1e-5)

    doas_true = np.array([-2.0, 0.5, 2.5])
    frames = jnp.stack([
        jnp.asarray(signal_from_template(d.geometry, t, sig, float(x), fs=FS))
        for x in doas_true
    ])
    doa, rate = d.forward_batch(frames, method="matched_stacked")
    assert np.asarray(rate).shape == (3, 33)
    step = np.degrees(grid[1] - grid[0])
    err = np.degrees(np.arcsin(np.abs(np.sin(np.asarray(doa) - doas_true))))
    assert np.all(err <= step + 1e-6), err

    # requires the stacked calibration
    d2 = Demo(
        geometry=geometry,
        freq_bands=[[1600, 1900], [1900, 2200]],
        doa_list=grid,
        recording_duration=0.1,
        kernel_duration=5e-3,
        bipolar_spikes=True,
        fs=FS,
        use_cache=False,
        design_chunk=16,
    )
    with pytest.raises(ValueError, match="band_stacked"):
        d2.forward_batch(frames, method="matched_stacked")


def test_stacked_estimator_eager_chain_matches_batch():
    """The eager chain (spike_encoding -> xylo_process -> extract_rate(fold=
    False) -> estimate_doa_from_rate('matched_stacked')) gives the same
    answer as forward_batch(method='matched_stacked')."""
    geometry = CenterCircularArray(radius=4.5e-2, num_mic=7)
    grid = np.linspace(-np.pi, np.pi, 17)
    d = Demo(
        geometry=geometry,
        freq_bands=[[1600, 1900], [1900, 2200]],
        doa_list=grid,
        recording_duration=0.1,
        kernel_duration=5e-3,
        bipolar_spikes=True,
        fs=FS,
        use_cache=False,
        design_chunk=16,
    )
    t = np.arange(0, 0.1, 1 / FS)
    sig = np.sin(2 * np.pi * 1750 * t) + np.sin(2 * np.pi * 2050 * t)
    d.calibrate_profiles(template=(t, sig), use_cache=False, band_stacked=True)
    sig_in = jnp.asarray(signal_from_template(d.geometry, t, sig, 1.2, fs=FS))

    spikes = d.spike_encoding(sig_in)
    raster = d.xylo_process(spikes)
    r_unfolded = d.extract_rate(raster, fold=False)
    assert np.asarray(r_unfolded).shape == (2 * 17,)
    doa_eager = float(d.estimate_doa_from_rate(r_unfolded, method="matched_stacked"))

    doa_batch, _ = d.forward_batch(sig_in[None], method="matched_stacked")
    assert doa_eager == float(np.asarray(doa_batch)[0])

    # folded rate into matched_stacked is a shape error, not silence
    r_folded = d.extract_rate(raster)
    with pytest.raises(ValueError, match="fold=False"):
        d.estimate_doa_from_rate(r_folded, method="matched_stacked")


def test_matched_auto_estimator():
    """SNR-adaptive blend estimator (method='matched_auto',
    pipeline._auto_blend_scores): noiseless estimates land within one grid
    step; eager estimate_doa_from_rate matches forward_batch; the folded
    cosine derived from the stacked table equals cos1 of the separately
    calibrated folded profile (the affine-invariance identity the
    implementation relies on); and the method requires the stacked
    calibration."""
    from haghighatshoarmuir2024.models.xylo.pipeline import _cos1

    geometry = CenterCircularArray(radius=4.5e-2, num_mic=7)
    grid = np.linspace(-np.pi, np.pi, 33)
    mk = lambda: Demo(
        geometry=geometry,
        freq_bands=[[1600, 1900], [1900, 2200]],
        doa_list=grid,
        recording_duration=0.1,
        kernel_duration=5e-3,
        bipolar_spikes=True,
        fs=FS,
        use_cache=False,
        design_chunk=16,
    )
    d = mk()
    t = np.arange(0, 0.1, 1 / FS)
    sig = np.sin(2 * np.pi * 1750 * t) + np.sin(2 * np.pi * 2050 * t)
    prof_stacked = np.asarray(d.calibrate_profiles(
        template=(t, sig), use_cache=False, band_stacked=True))
    prof_folded = np.asarray(d.calibrate_profiles(
        template=(t, sig), use_cache=False))

    # the identity that lets matched_auto skip a second calibration:
    # cos1(fold(stacked row)) == cos1(calibrated folded row) exactly
    G = len(grid)
    folded_from_stacked = np.asarray(
        _cos1(jnp.asarray(prof_stacked.reshape(G, -1, G).mean(axis=1))))
    folded_direct = np.asarray(_cos1(jnp.asarray(prof_folded)))
    np.testing.assert_allclose(folded_from_stacked, folded_direct, atol=1e-5)

    doas_true = np.array([-2.0, 0.5, 2.5])
    frames = jnp.stack([
        jnp.asarray(signal_from_template(d.geometry, t, sig, float(x), fs=FS))
        for x in doas_true
    ])
    doa, rate = d.forward_batch(frames, method="matched_auto")
    assert np.asarray(rate).shape == (3, 33)
    step = np.degrees(grid[1] - grid[0])
    err = np.degrees(np.arcsin(np.abs(np.sin(np.asarray(doa) - doas_true))))
    assert np.all(err <= step + 1e-6), err

    # eager chain equals the batched forward
    sig_in = jnp.asarray(signal_from_template(d.geometry, t, sig, 1.2, fs=FS))
    r_unfolded = d.extract_rate(d.xylo_process(d.spike_encoding(sig_in)), fold=False)
    doa_eager = float(d.estimate_doa_from_rate(r_unfolded, method="matched_auto"))
    doa_batch, _ = d.forward_batch(sig_in[None], method="matched_auto")
    assert doa_eager == float(np.asarray(doa_batch)[0])

    # requires the stacked calibration
    d2 = mk()
    with pytest.raises(ValueError, match="band_stacked"):
        d2.forward_batch(frames, method="matched_auto")
