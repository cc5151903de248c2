"""Tests for the I/O layer and the live-demo application layer (all on the
synthetic source — the reference's own offline fallback)."""
import numpy as np
import pytest

from haghighatshoarmuir2024 import CenterCircularArray
from haghighatshoarmuir2024.io import (
    AudioRecorder,
    MultiMicDevKitNotFound,
    SyntheticAudioSource,
    Visualizer,
)

FS = 48_000


def _tone_source(geometry, doa=0.7, n_frames=3, snr_db=20.0, frame=0.25):
    dur = frame * (n_frames + 1)
    t = np.arange(0, dur, 1 / FS)
    sig = np.sin(2 * np.pi * 1750.0 * t)
    return SyntheticAudioSource(geometry, t, sig, doa, snr_db=snr_db, fs=FS)


def test_synthetic_source_frames():
    geo = CenterCircularArray(radius=4.5e-2, num_mic=7)
    src = _tone_source(geo, n_frames=3)
    frames = list(src.frames(0.25))
    assert len(frames) >= 3
    assert frames[0].shape == (12_000, 7)


def test_file_source_roundtrip(tmp_path):
    from scipy.io import wavfile

    from haghighatshoarmuir2024.io import FileAudioSource

    rng = np.random.default_rng(0)
    data = (rng.standard_normal((24_000, 4)) * 1000).astype(np.int16)
    p = tmp_path / "test.wav"
    wavfile.write(p, FS, data)
    src = FileAudioSource(str(p))
    frames = list(src.frames(0.25))
    assert len(frames) == 2
    assert frames[0].shape == (12_000, 4)
    np.testing.assert_allclose(
        frames[0], data[:12_000] / np.iinfo(np.int16).max, atol=1e-6
    )


def test_recorder_raises_without_device(monkeypatch):
    monkeypatch.setenv("PATH", "/nonexistent")
    rec = AudioRecorder()
    with pytest.raises(MultiMicDevKitNotFound):
        rec.record_file(duration=0.1)


def test_visualizer_headless_ring_buffer():
    vz = Visualizer(buffer_size=4, dim_samples=1, headless=True)
    vz.start()
    for v in (1.0, 2.0, 3.0):
        vz.push(v)
    assert len(vz.history) == 3
    assert vz._vals[-1][0] == 3.0
    assert np.isnan(vz._vals[0][0])  # not yet filled
    vz.stop()


def test_hilbert_demo_end_to_end():
    from haghighatshoarmuir2024.demos.localization_demo import Demo

    geo = CenterCircularArray(radius=4.5e-2, num_mic=7)
    doa_true = 0.7
    grid = np.linspace(-np.pi, np.pi, 113)
    demo = Demo(
        geo, [[1600, 1900]], grid, source=_tone_source(geo, doa=doa_true)
    )
    est = demo.run(num_frames=2)
    assert len(est) == 2
    # folded metric (the Hilbert argmax lands antipodally; see verify skill)
    for e in est:
        err = np.rad2deg(np.arcsin(abs(np.sin(np.deg2rad(e) - doa_true))))
        assert err < 6.0, (e, err)


def test_music_demo_end_to_end():
    from haghighatshoarmuir2024.demos.localization_demo_music import Demo

    geo = CenterCircularArray(radius=4.5e-2, num_mic=7)
    doa_true = -1.2
    grid = np.linspace(-np.pi, np.pi, 113)
    demo = Demo(
        geo, [1200.0, 2000.0], grid,
        num_active_freq=5, num_fft_bin=2048,
        source=_tone_source(geo, doa=doa_true),
    )
    est = demo.run(num_frames=2)
    for e in est:
        err = np.rad2deg(np.arcsin(abs(np.sin(np.deg2rad(e) - doa_true))))
        assert err < 6.0, (e, err)


def test_snn_demo_end_to_end():
    from haghighatshoarmuir2024.demos.localization_demo_snn import Demo

    geo = CenterCircularArray(radius=4.5e-2, num_mic=7)
    doa_true = 0.7
    grid = np.linspace(-np.pi, np.pi, 65)
    demo = Demo(
        geo, [[1600, 1900]], grid, source=_tone_source(geo, doa=doa_true)
    )
    est = demo.run(num_frames=1)
    err = np.rad2deg(np.arcsin(abs(np.sin(np.deg2rad(est[0]) - doa_true))))
    assert err < 8.0, est


def test_xylo_demo_activity_detection():
    from haghighatshoarmuir2024.demos.localization_demo_xylo import Demo
    from haghighatshoarmuir2024.models.xylo import Demo as XyloDemo

    geo = CenterCircularArray(radius=4.5e-2, num_mic=7)
    xd = XyloDemo(
        geometry=geo,
        freq_bands=[[1600, 1900]],
        doa_list=np.linspace(-np.pi, np.pi, 65),
        recording_duration=0.1,
        kernel_duration=5e-3,
        bipolar_spikes=True,
        fs=FS,
        use_cache=False,
    )
    d = Demo(xd, rel_threshold=1e-4, full_scale=1.0)
    silent = np.zeros((4800, 7))
    assert np.isnan(d.process_frame(silent))  # no activity -> NaN
    t = np.arange(0, 0.1, 1 / FS)
    from haghighatshoarmuir2024.ops.interp import signal_from_template

    sig_in = np.asarray(
        signal_from_template(geo, t, np.sin(2 * np.pi * 1750 * t), 0.7, fs=FS)
    )
    doa = d.process_frame(sig_in)
    assert np.isfinite(doa)


def test_experiment_figure_helpers(tmp_path, monkeypatch):
    """Figure rendering twins of the paper_plots PDF outputs (HM2024_FIG_DIR)."""
    import sys, os
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "experiments"))
    import common

    monkeypatch.setenv("HM2024_FIG_DIR", str(tmp_path))
    doa = np.linspace(-np.pi, np.pi, 32)
    common.fig_polar_patterns({"1 kHz": np.abs(np.cos(doa))}, doa, "pat.pdf")
    common.fig_mae_vs_snr({"tone": ([0, 10, 20], [5.0, 2.0, 1.0])}, "mae.pdf")
    common.fig_lines([0, 1, 2], {"a": [1, 2, 3]}, "lines.pdf", xlabel="t")
    for f in ("pat.pdf", "mae.pdf", "lines.pdf"):
        assert (tmp_path / f).exists() and (tmp_path / f).stat().st_size > 0


def test_srp_demo_end_to_end():
    from haghighatshoarmuir2024.demos.localization_demo_srp import Demo

    geo = CenterCircularArray(radius=4.5e-2, num_mic=7)
    doa_true = 0.7
    grid = np.linspace(-np.pi, np.pi, 129)
    demo = Demo(geo, [1400, 2100], grid, source=_tone_source(geo, doa=doa_true))
    est = demo.run(num_frames=2)
    err = np.rad2deg(np.arcsin(abs(np.sin(np.deg2rad(est[-1]) - doa_true))))
    assert err < 5.0, est
