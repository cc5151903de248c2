"""Compiled-path parity on the GPU.

The CPU suite (``tests/``) reaches the Pallas LIF kernel only in interpret
mode and runs every XLA stage through XLA:CPU.  This suite pins the compiled
paths on the card:

  * the integer LIF kernel (normal, saturating, bipolar at odd batch sizes,
    carried state) vs the lax.scan simulator — bit-exact;
  * the plain-XLA RZCC extraction on the GPU vs the same function on the
    CPU — bit-exact on the same float32 input;
  * the end-to-end ``forward_batch`` rate profile vs a CPU process driving
    the SAME saved model (one band, two bands, the three reference bands,
    and the 24 kHz mode) — tolerance parity: the float encode differs
    across backends at the ULP level, so a handful of spike decisions may
    flip out of thousands;
  * the lifted IIR, serving ingest, SRP-PHAT, MUSIC tracking and the
    generalized eigensolver against host references.
"""
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "tests"))
from test_pallas_lif import make_config, make_spikes, scan_counts  # noqa: E402

from haghighatshoarmuir2024.ops.pallas.lif_kernel import (  # noqa: E402
    lif_count_rates,
    lif_count_rates_bipolar,
    lif_count_stateful,
)
from haghighatshoarmuir2024.ops.peaks import rzcc_encode_bipolar_tm  # noqa: E402

pytestmark = pytest.mark.gpu


# --------------------------------------------------------------- LIF kernel
def test_lif_count_compiled_matches_scan():
    for seed, rec_coef in ((41, -2), (42, 0), (43, -1)):
        config = make_config(seed, rec_coef=rec_coef)
        spikes = make_spikes(seed, B=4, T=100)
        got = np.asarray(lif_count_rates(config, spikes))
        np.testing.assert_array_equal(got, scan_counts(config, spikes))


def test_lif_count_compiled_saturating_matches_scan():
    config = make_config(11, w_scale=5000)
    config.threshold[:] = 25_000
    spikes = make_spikes(11, p=0.9, max_count=3)
    got = np.asarray(lif_count_rates(config, spikes))
    np.testing.assert_array_equal(got, scan_counts(config, spikes))
    assert got.sum() > 0  # the saturating regime actually fired


@pytest.mark.parametrize("B", [3, 4, 17])
@pytest.mark.parametrize("N,rec_coef", [(20, -1), (449, 0), (200, -1)])
def test_lif_count_bipolar_compiled_matches_scan(B, N, rec_coef):
    # odd batch sizes, one and several neuron blocks, the one-block row of
    # the recurrent case, and the flagship width N=449
    rng = np.random.default_rng(47 + B + N)
    C, T = 14, 96
    config = make_config(47, C=2 * C, N=N, rec_coef=rec_coef, w_scale=30)
    kp = (rng.random((T, B, C)) < 0.2).astype(np.int8)
    kn = (rng.random((T, B, C)) < 0.2).astype(np.int8)
    got = np.asarray(lif_count_rates_bipolar(config, jnp.asarray(kp), jnp.asarray(kn)))
    pos = (kp & (1 - kn)).astype(np.int32)
    enc_btc = np.concatenate([pos, kn.astype(np.int32)], axis=-1).transpose(1, 0, 2)
    np.testing.assert_array_equal(got, scan_counts(config, enc_btc))


def test_lif_stateful_compiled_chunked_equals_full():
    config = make_config(53, rec_coef=-2)
    B, N = 3, config.n_hidden
    spikes = make_spikes(53, T=96)
    state = tuple(jnp.zeros((B, N), jnp.int32) for _ in range(3))
    total = np.zeros((B, N), np.int64)
    for part in np.split(spikes, [40, 64], axis=1):  # ragged: 40 + 24 + 32
        counts, *state = lif_count_stateful(config, jnp.asarray(part), *state)
        total += np.asarray(counts)
    np.testing.assert_array_equal(total, scan_counts(config, spikes))


# ------------------------------------------------------------------- RZCC
@pytest.mark.parametrize("d,W", [(13, 26), (80, 24)])
def test_rzcc_encode_gpu_matches_cpu(d, W):
    """The plain-XLA bounded-plateau extrema + greedy suppression gives the
    same masks on the GPU as on the CPU for the same float32 input,
    including an exact plateau and a wide suppression window."""
    rng = np.random.default_rng(7 + d)
    cs = np.cumsum(rng.standard_normal((6, 4000)), axis=-1).astype(np.float32)
    cs[:, 500:504] = cs[:, 500:501]  # exact plateau
    fn = jax.jit(lambda x: rzcc_encode_bipolar_tm(x, d, W))
    kp, kn = fn(jnp.asarray(cs.T))
    kp_c, kn_c = fn(jax.device_put(cs.T, jax.devices("cpu")[0]))
    np.testing.assert_array_equal(np.asarray(kp), np.asarray(kp_c))
    np.testing.assert_array_equal(np.asarray(kn), np.asarray(kn_c))


# --------------------------------------------------- end-to-end device parity
_CPU_RATES_SCRIPT = r"""
import sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, {repo!r})
from haghighatshoarmuir2024.models.xylo import Demo
demo = Demo.load({model!r})
sig = np.load({sig!r})
doa, rate = demo.forward_batch(sig, method="peak")
np.save({out!r}, np.asarray(rate, np.float32))
"""


@pytest.mark.parametrize(
    "freq_bands,fs",
    [
        ([[1600, 1900]], 48_000),
        ([[1600, 1900], [1900, 2200]], 48_000),
        ([[1600, 2000], [2000, 2300], [2300, 2600]], 48_000),
        ([[1600, 1900]], 24_000),
    ],
    ids=["one-band", "two-band", "three-band", "24kHz"],
)
def test_forward_batch_rate_profile_parity_vs_cpu(freq_bands, fs, tmp_path):
    """The full encode→SNN→rate chain on the GPU (compiled LIF kernel,
    lifted IIR, blocked STHT) matches a fresh CPU process (scan and FFT
    forms) driving the SAME saved model, to rate-profile tolerance — single
    band, the multiband layouts (block encode channels + block hidden
    neurons; F=3 is the reference band set) and the 24 kHz mode."""
    from haghighatshoarmuir2024 import CenterCircularArray
    from haghighatshoarmuir2024.models.xylo import Demo
    from haghighatshoarmuir2024.ops.interp import signal_from_template

    geometry = CenterCircularArray(radius=4.5e-2, num_mic=7)
    demo = Demo(
        geometry=geometry,
        freq_bands=freq_bands,
        doa_list=np.linspace(-np.pi, np.pi, 57),
        recording_duration=0.1,
        kernel_duration=5e-3,
        bipolar_spikes=True,
        fs=fs,
        design_chunk=8,
    )
    t = np.arange(0, 0.1, 1 / fs)
    sig = np.sin(2 * np.pi * 1750 * t)
    rng = np.random.default_rng(0)
    batch = np.stack(
        [
            np.asarray(signal_from_template(geometry, t, sig, doa, fs=fs), np.float32)
            + 0.05 * rng.standard_normal((len(t), 7)).astype(np.float32)
            for doa in (0.6, -1.2)
        ]
    )

    doa_gpu, rate_gpu = demo.forward_batch(jnp.asarray(batch), method="peak")
    rate_gpu = np.asarray(rate_gpu, np.float32)

    # a child held to the CPU: it never opens the card
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    model = str(tmp_path / "model.npz")
    sig_p = str(tmp_path / "sig.npy")
    out = str(tmp_path / "rate_cpu.npy")
    demo.save(model)
    np.save(sig_p, batch)
    code = _CPU_RATES_SCRIPT.format(repo=repo, model=model, sig=sig_p, out=out)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-c", code], env=env, capture_output=True, text=True,
        timeout=600,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    rate_cpu = np.load(out)

    assert rate_gpu.shape == rate_cpu.shape
    # normalized rate-profile distance: a handful of flipped spike decisions
    # (float encode differs at ULP level across backends) out of ~thousands
    denom = np.maximum(np.linalg.norm(rate_cpu, axis=-1), 1e-9)
    rel = np.linalg.norm(rate_gpu - rate_cpu, axis=-1) / denom
    assert np.all(rel < 0.05), rel
    # and the argmax DoA picks agree within one grid step
    i_g = rate_gpu.argmax(axis=-1)
    i_c = rate_cpu.argmax(axis=-1)
    assert np.all(np.abs(i_g - i_c) <= 1), (i_g, i_c)


# ---------------------------------------------------- serving ingest parity
def test_ingest_u4_upsample_compiled_matches_host():
    """The serving daemon's compressed-wire ingest (u4 nibble unpack +
    16-entry table gather + polyphase upsample conv) compiled on the GPU
    matches the host-side reference path (runtime/server.py ingest_up)."""
    from haghighatshoarmuir2024.ops.mulaw import (
        mulaw4_decode,
        mulaw4_decode_table,
        mulaw4_encode,
        pack4,
    )
    from haghighatshoarmuir2024.ops.resample import (
        TAPS_PER_PHASE,
        design_upsample_fir,
        phase_table,
        upsample_poly,
        upsample_poly_stream,
    )

    rng = np.random.default_rng(5)
    B, Tw, M, F = 8, 3000, 7, 4
    x = np.clip(rng.standard_normal((B, Tw, M)) * 0.4, -1, 1).astype(np.float32)
    packed = np.stack([pack4(mulaw4_encode(x[b])) for b in range(B)])
    tbl4 = mulaw4_decode_table()
    hp = phase_table(design_upsample_fir(F), F)
    K = TAPS_PER_PHASE - 1

    @jax.jit
    def ingest(raw, carry):
        r = raw.astype(jnp.int32)
        hi = jnp.asarray(tbl4)[(r >> 4) & 0xF]
        lo = jnp.asarray(tbl4)[r & 0xF]
        xw = jnp.stack([hi, lo], axis=2).reshape(
            raw.shape[0], raw.shape[1] * 2, raw.shape[2]
        )
        return upsample_poly_stream(xw, carry, hp, F)

    y, carry = ingest(jnp.asarray(packed), jnp.zeros((B, K, M), jnp.float32))
    h = design_upsample_fir(F)
    dec = np.stack([mulaw4_decode(mulaw4_encode(x[b])) for b in range(B)])
    gold = np.stack([upsample_poly(dec[b], h, F) for b in range(B)])
    np.testing.assert_allclose(np.asarray(y), gold, rtol=0, atol=3e-5)
    np.testing.assert_allclose(
        np.asarray(carry), dec[:, -K:, :], rtol=0, atol=0
    )


def test_matched_stacked_forward_device_consistent():
    """The band-stacked (per-band cosine) matched forward runs compiled on
    the GPU and its DoA picks agree with scoring the SAME device rates on
    the host — the estimator layer adds no device-specific surprises on top
    of the rate parity pinned above."""
    from haghighatshoarmuir2024 import CenterCircularArray
    from haghighatshoarmuir2024.models.xylo import Demo
    from haghighatshoarmuir2024.models.xylo.pipeline import _blockcos
    from haghighatshoarmuir2024.ops.interp import signal_from_template

    fs = 48_000
    geometry = CenterCircularArray(radius=4.5e-2, num_mic=7)
    grid = np.linspace(-np.pi, np.pi, 33)
    demo = Demo(
        geometry=geometry,
        freq_bands=[[1600, 1900], [1900, 2200]],
        doa_list=grid,
        recording_duration=0.1,
        kernel_duration=5e-3,
        bipolar_spikes=True,
        fs=fs,
        design_chunk=8,
    )
    t = np.arange(0, 0.1, 1 / fs)
    sig = np.sin(2 * np.pi * 1750 * t) + np.sin(2 * np.pi * 2050 * t)
    demo.calibrate_profiles(template=(t, sig), use_cache=False, band_stacked=True)
    doas_true = np.array([-2.0, 0.5, 2.5])
    batch = jnp.stack([
        jnp.asarray(signal_from_template(geometry, t, sig, float(x), fs=fs))
        for x in doas_true
    ])

    doa_dev, _ = demo.forward_batch(batch, method="matched_stacked")
    rate_dev = np.asarray(demo._rates_batch_jit(batch), np.float32)

    # host re-score of the device rates
    prof = np.asarray(_blockcos(jnp.asarray(demo._profiles_stacked), len(grid)))
    rc = np.asarray(_blockcos(jnp.asarray(rate_dev), len(grid)))
    host_pick = grid[np.argmax(rc @ prof.T, axis=-1)]
    np.testing.assert_allclose(np.asarray(doa_dev), host_pick, atol=1e-6)

    # and the estimates are correct within one grid step
    step = grid[1] - grid[0]
    err = np.abs(np.arcsin(np.abs(np.sin(np.asarray(doa_dev) - doas_true))))
    assert np.all(err <= step + 1e-6)

    # the SNR-adaptive blend (matched_auto) on the same device rates: device
    # picks equal host-scored picks, and land within one grid step too
    from haghighatshoarmuir2024.models.xylo.pipeline import _auto_blend_scores

    doa_auto, _ = demo.forward_batch(batch, method="matched_auto")
    host_scores = np.asarray(_auto_blend_scores(
        jnp.asarray(rate_dev), jnp.asarray(demo._profiles_stacked), len(grid)))
    host_auto = grid[np.argmax(host_scores, axis=-1)]
    np.testing.assert_allclose(np.asarray(doa_auto), host_auto, atol=1e-6)
    err = np.abs(np.arcsin(np.abs(np.sin(np.asarray(doa_auto) - doas_true))))
    assert np.all(err <= step + 1e-6)


def test_srp_phat_device_matches_host_reference():
    """SRP-PHAT steered power computed compiled on the GPU matches a plain
    NumPy re-derivation on the host (steering ships as real cos/sin planes,
    models/srp_phat.py)."""
    from haghighatshoarmuir2024 import CenterCircularArray
    from haghighatshoarmuir2024.models.srp_phat import SRPPHAT
    from haghighatshoarmuir2024.ops.interp import signal_from_template

    fs = 48_000
    geometry = CenterCircularArray(radius=4.5e-2, num_mic=7)
    grid = np.linspace(-np.pi, np.pi, 65)
    srp = SRPPHAT(geometry, freq_range=[1400, 2100], doa_list=grid, fs=fs,
                  frame_duration=0.25)
    assert srp._steer_re.dtype == np.float32  # real planes, not complex64

    t = np.arange(0, 0.25, 1 / fs)
    sig = np.sin(2 * np.pi * 1750 * t)
    doa_true = 0.9
    x = np.asarray(
        signal_from_template(geometry, t, sig, doa_true, fs=fs), np.float32
    )
    # white noise at ~10 dB: a NOISELESS tone is PHAT's pathological input
    # (whitening inflates the tone's leakage bins to unit phasors and the
    # peak wanders ~20 deg — host and device agree on that too); noise fills
    # the off-tone bins with incoherent phases that cancel in the steering
    # sum, which is the regime the MC harness measures
    rng = np.random.default_rng(7)
    sigma = np.sqrt(np.mean(x**2) / 10.0)
    x = (x + sigma * rng.standard_normal(x.shape)).astype(np.float32)
    p_dev = np.asarray(srp.apply_to_signal(x))  # compiled on the GPU

    # host reference: float64 numpy end-to-end
    X = np.fft.rfft(x.astype(np.float64), axis=0)[srp._bins]
    Xi, Xj = X[:, srp._pair_i], X[:, srp._pair_j]
    cross = Xi * np.conj(Xj)
    R = cross / np.maximum(np.abs(cross), 1e-12)
    Rf = R.T.reshape(-1)
    p_host = (Rf.real @ srp._steer_re - Rf.imag @ srp._steer_im) / len(srp._pairs)

    assert np.argmax(p_dev) == np.argmax(p_host)
    # PHAT whitening amplifies float32 FFT rounding into phase noise on every
    # unit phasor; summed over ~3000 (pair, bin) terms the device spectrum
    # sits ~1% off the float64 host one (measured 0.10 peak-normalized 0.011)
    peak = np.abs(p_host).max()
    np.testing.assert_allclose(p_dev / peak, p_host / peak, rtol=0, atol=0.03)
    # and the pick is right: folded error within one grid step
    est = grid[int(np.argmax(p_dev))]
    step = grid[1] - grid[0]
    assert abs(np.arcsin(abs(np.sin(est - doa_true)))) <= step + 1e-6


# ------------------------------------------------------- lifted IIR encode
def _cumsum_of_scan(b, a, x):
    """The reference composition the lifted form must match:
    cumsum(lfilter(b, a, x)) (micloc/spike_encoder.py:115-127 +
    micloc/xylo_snn_localization.py:336-347), both stages on-device."""
    from haghighatshoarmuir2024.ops.iir import iir_filter

    y = iir_filter(b, a, x, axis=0, method="scan")
    return jnp.cumsum(y, axis=0)


@pytest.mark.parametrize(
    "band,T,L",
    [
        ((1600.0, 1900.0), 12_000, 16),  # the benchmark band/shape
        ((500.0, 3000.0), 24_000, 8),  # wide-robust-width 3-band outer shape
    ],
)
def test_iir_blocked_cumsum_device_parity(band, T, L):
    """Direct on-card parity for the level-2 modal-basis
    lifted IIR (ops/iir.py blocked_cumsum) — the most numerically intricate
    path in the repo, carrying the whole encode — vs the sequential scan
    composition, at <= 1e-5 relative error in float32."""
    from haghighatshoarmuir2024.ops.iir import butter_bandpass, iir_filter

    b, a = butter_bandpass(1, band, 48_000.0)
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.standard_normal((T, L)).astype(np.float32))

    got = np.asarray(
        jax.jit(
            lambda xx: iir_filter(b, a, xx, axis=0, method="blocked_cumsum")
        )(x)
    )
    ref = np.asarray(jax.jit(lambda xx: _cumsum_of_scan(b, a, xx))(x))

    # relative to the running scale of the integrated signal (it crosses
    # zero pointwise, so normalize by the column's max magnitude)
    scale = np.maximum(np.abs(ref).max(axis=0, keepdims=True), 1e-12)
    err = np.abs(got - ref) / scale
    # Both sides run float32 with HIGHEST-precision matmuls, but they sum
    # the same series in different orders (stepwise scan vs blocked
    # matmuls), so the achievable agreement is random-walk roundoff
    # ~sqrt(T)*eps_f32: 1.3e-5 at T=12000, 1.9e-5 at T=24000.  Gate at 3x
    # that bound; algorithmic
    # exactness is pinned separately by the float64 CPU goldens in
    # tests/test_ops_filters.py.
    bound = 3.0 * np.sqrt(T) * np.finfo(np.float32).eps
    assert err.max() <= bound, f"max rel err {err.max():.3e} (bound {bound:.3e})"


def test_iir_blocked_cumsum_carried_seam_device():
    """Streaming seam: two chunks with the carried (N+1) state equal one
    full pass, on the card."""
    from haghighatshoarmuir2024.ops.iir import butter_bandpass, iir_filter

    b, a = butter_bandpass(1, (1600.0, 1900.0), 48_000.0)
    rng = np.random.default_rng(5)
    T, L = 12_800, 8  # multiple of the 32-sample block
    x = rng.standard_normal((T, L)).astype(np.float32)

    full = np.asarray(
        jax.jit(
            lambda xx: iir_filter(b, a, xx, axis=0, method="blocked_cumsum")
        )(jnp.asarray(x))
    )

    @jax.jit
    def chunked(x1, x2):
        y1, s = iir_filter(
            b, a, x1, axis=0, method="blocked_cumsum", return_state=True
        )
        y2 = iir_filter(b, a, x2, axis=0, method="blocked_cumsum", zi=s)
        return jnp.concatenate([y1, y2], axis=0)

    got = np.asarray(chunked(jnp.asarray(x[: T // 2]), jnp.asarray(x[T // 2 :])))
    scale = np.maximum(np.abs(full).max(axis=0, keepdims=True), 1e-12)
    err = np.abs(got - full) / scale
    assert err.max() <= 1e-5, f"seam max rel err {err.max():.3e}"


def test_iir_blocked_cumsum_sb48_seam_device():
    """The 24 kHz streaming seam's non-default block size on the card:
    Tc=6000 is not a multiple of 32, so the seam runs the lifted
    form at sb=48 (runtime/streaming.py) — chunked carried-state at that
    block size must equal one full pass on-device, like the sb=32 case
    above.  CPU float64 exactness is pinned in tests/test_ops_filters.py;
    this guards the GPU lowering of the sb-parametrized lifted matrices."""
    from haghighatshoarmuir2024.ops.iir import butter_bandpass, iir_filter

    b, a = butter_bandpass(1, (1600.0, 1900.0), 24_000.0)
    rng = np.random.default_rng(6)
    T, L = 12_000, 8  # two 6000-sample chunks, each a multiple of 48
    x = rng.standard_normal((T, L)).astype(np.float32)

    full = np.asarray(
        jax.jit(
            lambda xx: iir_filter(b, a, xx, axis=0, method="blocked_cumsum",
                                  sb=48)
        )(jnp.asarray(x))
    )

    @jax.jit
    def chunked(x1, x2):
        y1, s = iir_filter(
            b, a, x1, axis=0, method="blocked_cumsum", return_state=True,
            sb=48,
        )
        y2 = iir_filter(b, a, x2, axis=0, method="blocked_cumsum", zi=s,
                        sb=48)
        return jnp.concatenate([y1, y2], axis=0)

    got = np.asarray(chunked(jnp.asarray(x[: T // 2]), jnp.asarray(x[T // 2 :])))
    scale = np.maximum(np.abs(full).max(axis=0, keepdims=True), 1e-12)
    err = np.abs(got - full) / scale
    assert err.max() <= 1e-5, f"sb=48 seam max rel err {err.max():.3e}"


def test_multi_target_music_tracking_device_matches_host():
    """The multi-source chain on the card: noise-subspace MUSIC
    pseudospectrum -> top_k_peaks -> gated GNN tracker.  The device
    measurements must produce the same confirmed tracks as the host
    MultiDoaTracker fed the same peaks, and both targets must be tracked
    through a bearing crossing without identity swap (cf.
    experiments/multi_target_tracking.py; reference has no multi-target
    association at all — paper_plots/multiple_targets_music.py:87-246 is a
    static two-peak check)."""
    from haghighatshoarmuir2024 import CenterCircularArray
    from haghighatshoarmuir2024.models.music import MUSIC
    from haghighatshoarmuir2024.ops.interp import signal_from_template
    from haghighatshoarmuir2024.ops.peaks import top_k_peaks
    from haghighatshoarmuir2024.utils.tracking import (
        MultiDoaTracker,
        track_multi_angles,
    )

    fs = 48_000
    geometry = CenterCircularArray(radius=4.5e-2, num_mic=7)
    grid = np.linspace(-np.pi, np.pi, 225)
    music = MUSIC(geometry, (1000.0, 2000.0), grid, frame_duration=0.25, fs=fs)

    dur, frame = 3.0, 0.25
    t = np.arange(0, dur, 1 / fs)
    tr1 = np.deg2rad(-70 + 100 * t / t[-1]).astype(np.float32)
    tr2 = np.deg2rad(70 - 100 * t / t[-1]).astype(np.float32)
    x = np.asarray(signal_from_template(
        geometry, t, np.sin(2 * np.pi * 1500 * t), tr1, fs=fs, delay_sign=-1))
    x = x + np.asarray(signal_from_template(
        geometry, t, np.sin(2 * np.pi * 1600 * t), tr2, fs=fs, delay_sign=-1))
    rng = np.random.default_rng(0)
    x = (x + np.sqrt(np.mean(x**2) / 10) * rng.standard_normal(x.shape)).astype(
        np.float32
    )

    n, Tf = int(dur / frame), int(frame * fs)
    z = np.zeros((n, 2), np.float32)
    valid = np.zeros((n, 2), bool)
    for k in range(n):
        p = music.beamforming(
            jnp.asarray(x[k * Tf : (k + 1) * Tf]), 2, 2048, num_sources=2
        )
        idx, _, ok = top_k_peaks(p, 2, distance=len(grid) // 32, rel_height=0.2)
        z[k] = grid[np.asarray(idx)]
        valid[k] = np.asarray(ok)

    thetas, confirmed = track_multi_angles(z, valid, num_tracks=4, max_misses=4)
    thetas, confirmed = np.asarray(thetas), np.asarray(confirmed)

    # host streaming twin agrees with the scan path on the device peaks
    trk = MultiDoaTracker(4, max_misses=4)
    for i in range(n):
        th_h, cf_h = trk.update(z[i], valid[i])
        np.testing.assert_array_equal(confirmed[i], cf_h)
        np.testing.assert_allclose(np.sin(thetas[i] - th_h), 0.0, atol=1e-5)

    # both targets tracked through the crossing, identity held
    assert confirmed[-1].sum() == 2
    fc = (np.arange(n) + 0.5) * frame
    tru1, tru2 = np.interp(fc, t, tr1), np.interp(fc, t, tr2)
    fold = lambda e, tr: np.rad2deg(np.arcsin(np.abs(np.sin(e - tr))))  # noqa: E731
    slots = np.nonzero(confirmed[2])[0]
    s1 = int(slots[np.argmin(fold(thetas[2, slots], tru1[2]))])
    s2 = int(slots[np.argmin(fold(thetas[2, slots], tru2[2]))])
    assert s1 != s2
    assert fold(thetas[2:, s1], tru1[2:]).max() < 15.0
    assert fold(thetas[2:, s2], tru2[2:]).max() < 15.0


# ------------------------------------------- interference-removal design
def test_generalized_top_eigvec_on_device():
    """The interference-removal eigensolver
    (ops/linalg.generalized_top_eigvec, the micloc/beamformer.py:165-190
    twin) on the card — complex64 Cholesky-whitened pencils over a small
    DoA-grid-shaped batch vs the CPU float64 scipy golden, at
    f32-appropriate tolerance."""
    import scipy.linalg

    from haghighatshoarmuir2024.ops.linalg import generalized_top_eigvec

    rng = np.random.default_rng(11)
    G, n = 16, 7
    # grid of Hermitian PD pencils shaped like the beamformer design:
    # C = per-DoA rank-rich covariance, B = loaded sum-minus-self
    A = rng.standard_normal((G, n, 12)) + 1j * rng.standard_normal((G, n, 12))
    C = A @ A.conj().swapaxes(-1, -2)
    C_sum = C.sum(axis=0)
    Bm = C_sum[None] - C
    load = np.mean(np.trace(C_sum).real / n) / 10.0
    Bm = Bm + load * np.eye(n)[None]

    @jax.jit
    def solve(Cr, Ci, Br, Bi):
        Cc = (Cr + 1j * Ci).astype(jnp.complex64)
        Bc = (Br + 1j * Bi).astype(jnp.complex64)
        v = jax.vmap(generalized_top_eigvec)(Cc, Bc)
        return jnp.real(v), jnp.imag(v)

    vr, vi = solve(
        jnp.asarray(C.real, jnp.float32), jnp.asarray(C.imag, jnp.float32),
        jnp.asarray(Bm.real, jnp.float32), jnp.asarray(Bm.imag, jnp.float32),
    )
    got = np.asarray(vr) + 1j * np.asarray(vi)

    for g in range(G):
        _, U = scipy.linalg.eigh(C[g], Bm[g])
        v_ref = U[:, -1] / np.linalg.norm(U[:, -1])
        inner = abs(np.vdot(v_ref, got[g]))
        assert abs(inner - 1.0) < 5e-3, f"pencil {g}: |<ref,got>| = {inner}"
