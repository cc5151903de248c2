"""Golden test of the MUSIC (Bartlett) beamformer against a NumPy port of the
reference (micloc/music_beamformer.py)."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
from scipy.signal import lfilter, butter

from haghighatshoarmuir2024 import CenterCircularArray
from haghighatshoarmuir2024.models.music import MUSIC

FS = 48_000


def _ref_beamforming(geometry, freq_range, doa_list, sig_in, num_active_freq, num_fft_bin):
    """Port of micloc/music_beamformer.py:91-186."""
    b, a = butter(1, list(freq_range), btype="bandpass", output="ba", fs=FS)
    T, num_chan = sig_in.shape
    sig_in_filt = lfilter(b, a, sig_in, axis=0)

    freq_vec = np.linspace(0, FS, num_fft_bin)
    num_fft_frames = T // num_fft_bin
    if num_fft_frames == 0:
        num_fft_frames = 1
    sig_fft_len = num_fft_frames * num_fft_bin
    sig_in_filt_adj = np.zeros((sig_fft_len, num_chan))
    n = min(T, sig_fft_len)
    sig_in_filt_adj[:n, :] = sig_in_filt[:n, :]

    sig_in_fft = np.fft.fft(
        sig_in_filt_adj.T.reshape(num_chan, num_fft_frames, num_fft_bin),
        n=num_fft_bin,
        axis=-1,
    )
    fmin, fmax = freq_range
    fft_bin_index = (fmin <= freq_vec) & (freq_vec <= fmax)
    sig_sel = sig_in_fft[:, :, fft_bin_index]
    freq_sel = freq_vec[fft_bin_index]

    power_in_freq = np.mean(np.abs(sig_sel) ** 2, axis=(0, 1))
    max_idx = np.argsort(power_in_freq)[-num_active_freq:]
    max_freqs = freq_sel[max_idx]
    X = sig_sel[:, :, max_idx]

    delays = np.asarray(
        [
            -geometry.r_vec * np.cos(geometry.theta_vec - th) / geometry.speed
            for th in doa_list
        ]
    ).T
    arr_resp = np.asarray(
        [np.exp(-1j * 2 * np.pi * f * delays) for f in max_freqs]
    )

    ang_pow_spec = 0
    for idx in range(len(max_freqs)):
        ang = np.mean(np.abs(np.conj(arr_resp[idx]).T @ X[:, :, idx]) ** 2, axis=-1)
        ang_pow_spec = ang_pow_spec + ang
    return ang_pow_spec


@pytest.fixture(scope="module")
def setup():
    geometry = CenterCircularArray(radius=4.5e-2, num_mic=7)
    freq_range = (1200.0, 2000.0)
    doa_list = np.linspace(-np.pi, np.pi, 65)
    music = MUSIC(geometry, freq_range, doa_list, frame_duration=0.25, fs=FS)
    return geometry, music, freq_range, doa_list


def test_beamforming_matches_reference(setup):
    geometry, music, freq_range, doa_list = setup
    rng = np.random.default_rng(0)
    t = np.arange(12_000) / FS
    sig = np.sin(2 * np.pi * 1750 * t)[:, None] + 0.1 * rng.standard_normal((12_000, 7))
    for num_active_freq, nfft in ((1, 2048), (5, 2048), (3, 1024)):
        ref = _ref_beamforming(geometry, freq_range, doa_list, sig, num_active_freq, nfft)
        got = np.asarray(music.beamforming(jnp.asarray(sig), num_active_freq, nfft))
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-8)


def test_array_response(setup):
    geometry, music, freq_range, doa_list = setup
    freqs = [1500.0, 1750.0]
    got = np.asarray(music.array_response(freqs))
    delays = np.asarray(
        [
            -geometry.r_vec * np.cos(geometry.theta_vec - th) / geometry.speed
            for th in doa_list
        ]
    ).T
    ref = np.asarray([np.exp(-1j * 2 * np.pi * f * delays) for f in freqs])
    np.testing.assert_allclose(got, ref, rtol=1e-10, atol=1e-12)


def test_apply_to_signal_framing(setup):
    geometry, music, freq_range, doa_list = setup
    rng = np.random.default_rng(1)
    sig = rng.standard_normal((30_000, 7))
    out = np.asarray(
        music.apply_to_signal(jnp.asarray(sig), num_active_freq=2, duration_overlap=0.125, num_fft_bin=1024)
    )
    # frame math from micloc/music_beamformer.py:217-257:
    # frame=12000, fresh=6000 -> full frames while i*6000+12000 <= 30000 -> i=0..3
    # leftover = 30000-4*6000=6000 <= 0.5*12000 -> not processed
    assert out.shape == (4, len(doa_list))


def test_music_noise_subspace_variant(setup):
    """Beyond-parity true MUSIC (num_sources>=1): noise-subspace
    pseudospectrum localizes a single source and separates two sources,
    with sharper peaks than the reference-parity Bartlett path."""
    geometry, music, freq_range, doa_list = setup
    grid = music.doa_list
    t = np.arange(0, 0.5, 1 / FS)
    sig = np.sin(2 * np.pi * 1750 * t)
    key = jax.random.PRNGKey(7)

    # single source: pseudospectrum peak at the true DoA
    aps = np.asarray(
        music.apply_to_template(
            (t, sig, 0.5), num_active_freq=1, duration_overlap=0.0,
            num_fft_bin=2048, snr_db=10.0, key=key, num_sources=1,
        )
    ).mean(0)
    est = grid[int(np.argmax(aps))]
    assert np.rad2deg(np.arcsin(abs(np.sin(est - 0.5)))) < 4.0, est

    # sharper than Bartlett: normalized pseudospectrum mass concentrates
    bart = np.asarray(
        music.apply_to_template(
            (t, sig, 0.5), num_active_freq=1, duration_overlap=0.0,
            num_fft_bin=2048, snr_db=10.0, key=key, num_sources=0,
        )
    ).mean(0)
    frac_music = (aps / aps.max() > 0.5).mean()
    frac_bart = (bart / bart.max() > 0.5).mean()
    assert frac_music < frac_bart, (frac_music, frac_bart)

    # two equal-power INCOHERENT sources at +-60 deg (independent bandlimited
    # noise — same-frequency coherent tones give a rank-1 covariance and are
    # a documented MUSIC failure mode, not a regression): S=2 resolves both
    from scipy.signal import butter as sp_butter, lfilter as sp_lfilter

    from haghighatshoarmuir2024.ops.interp import signal_from_template

    rng = np.random.default_rng(0)
    bb, ba = sp_butter(2, list(freq_range), btype="bandpass", fs=FS)
    src1 = sp_lfilter(bb, ba, rng.standard_normal(len(t)))
    src2 = sp_lfilter(bb, ba, rng.standard_normal(len(t)))
    src1 /= np.abs(src1).max()
    src2 /= np.abs(src2).max()
    d1, d2 = np.pi / 3, -np.pi / 3
    s1 = np.asarray(signal_from_template(geometry, t, src1, d1, fs=FS))
    s2 = np.asarray(signal_from_template(geometry, t, src2, d2, fs=FS))
    mix = s1 + s2 + 0.01 * rng.standard_normal(s1.shape)
    aps2 = np.asarray(
        music.apply_to_signal(
            jnp.asarray(mix), num_active_freq=1, duration_overlap=0.0,
            num_fft_bin=2048, num_sources=2,
        )
    ).mean(0)
    # the two largest well-separated maxima cover both true DoAs under the
    # reference's folded metric arcsin|sin| (which also folds the ring
    # array's antipodal ambiguity — see tests/test_beamformer.py notes)
    order = np.argsort(aps2)[::-1]
    picks = []
    for i in order:
        if all(abs(np.arcsin(abs(np.sin(grid[i] - grid[j])))) > 0.3 for j in picks):
            picks.append(i)
        if len(picks) == 2:
            break
    ests = grid[picks]
    for true in (d1, d2):
        best = min(np.rad2deg(np.arcsin(abs(np.sin(e - true)))) for e in ests)
        assert best < 6.0, (sorted(ests), d1, d2)

    # parameter validation
    with pytest.raises(ValueError, match="num_sources"):
        music.beamforming(jnp.zeros((2048, 7)), 1, 2048, num_sources=7)


def test_music_doa_estimation(setup):
    geometry, music, freq_range, doa_list = setup
    grid = music.doa_list
    t = np.arange(0, 0.5, 1 / FS)
    sig = np.sin(2 * np.pi * 1750 * t)
    key = jax.random.PRNGKey(0)
    for doa_true in (-2.0, 0.5):
        key, sub = jax.random.split(key)
        aps = np.asarray(
            music.apply_to_template(
                (t, sig, doa_true),
                num_active_freq=1,
                duration_overlap=0.0,
                num_fft_bin=2048,
                snr_db=10.0,
                key=sub,
            )
        )
        est = grid[int(np.argmax(aps.mean(0)))]
        err = np.rad2deg(np.arcsin(abs(np.sin(est - doa_true))))
        assert err < 4.0, (doa_true, est, err)


def test_music_synthesis_convention_unfolded(setup):
    """MUSIC's steering exp(-j2pi f d) matches the reference's t - delay
    synthesis (paper_plots/multiple_targets_music.py:147,
    micloc/music_beamformer.py:307-312).  The xylo-harness t + delay
    convention (micloc/xylo_snn_localization.py:63) mirrors every MUSIC
    estimate by 180 deg — this check is UNFOLDED (no arcsin|sin|), because the
    folded metric silently hides exactly that mirror (it did, in the r3
    multiple_targets experiment)."""
    from haghighatshoarmuir2024.ops.interp import signal_from_template

    geometry, music, freq_range, doa_list = setup
    grid = music.doa_list
    t = np.arange(0, 0.25, 1 / FS)
    sig = np.sin(2 * np.pi * 1750 * t)
    rng = np.random.default_rng(0)
    for doa_true in (-1.0, 2.2):
        x = np.asarray(signal_from_template(geometry, t, sig, doa_true, fs=FS,
                                            delay_sign=-1))
        x = x + 0.05 * rng.standard_normal(x.shape)
        aps = np.asarray(music.beamforming(jnp.asarray(x), 1, 2048))
        est = grid[int(np.argmax(aps))]
        err = np.abs(np.arctan2(np.sin(est - doa_true), np.cos(est - doa_true)))
        assert np.rad2deg(err) < 7.0, (doa_true, est)
        # and the plus convention lands on the OPPOSITE side (documents the
        # mirror rather than pretending it away)
        xp = np.asarray(signal_from_template(geometry, t, sig, doa_true, fs=FS))
        xp = xp + 0.05 * rng.standard_normal(xp.shape)
        apsp = np.asarray(music.beamforming(jnp.asarray(xp), 1, 2048))
        estp = grid[int(np.argmax(apsp))]
        flip = np.abs(np.arctan2(np.sin(estp - doa_true - np.pi),
                                 np.cos(estp - doa_true - np.pi)))
        assert np.rad2deg(flip) < 12.0, (doa_true, estp)


def test_music_two_sources_unfolded_noise_subspace(setup):
    """Two tones at +-60 deg, minus-convention synthesis: the noise-subspace
    pseudospectrum (num_sources=2, beyond parity) resolves BOTH on the
    correct side of the circle, unfolded, within two grid steps."""
    from haghighatshoarmuir2024.ops.interp import signal_from_template
    from haghighatshoarmuir2024.ops.peaks import top_k_peaks

    geometry, music, freq_range, doa_list = setup
    grid = music.doa_list
    t = np.arange(0, 0.25, 1 / FS)
    d1, d2 = -np.pi / 3, np.pi / 3
    x = np.asarray(signal_from_template(
        geometry, t, np.sin(2 * np.pi * 1500 * t), d1, fs=FS, delay_sign=-1))
    x = x + np.asarray(signal_from_template(
        geometry, t, np.sin(2 * np.pi * 1600 * t), d2, fs=FS, delay_sign=-1))
    x = x + 0.1 * np.random.default_rng(1).standard_normal(x.shape)
    aps = music.beamforming(jnp.asarray(x), 2, 2048, num_sources=2)
    idx, _, ok = top_k_peaks(aps, 2, distance=len(grid) // 16)
    assert bool(np.all(np.asarray(ok)))
    ests = np.sort(grid[np.asarray(idx)])
    step = np.rad2deg(grid[1] - grid[0])
    for est, true in zip(ests, (d1, d2)):
        err = np.abs(np.arctan2(np.sin(est - true), np.cos(est - true)))
        assert np.rad2deg(err) <= 2 * step + 1e-6, (est, true)
