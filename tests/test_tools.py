"""Offline localization CLI (tools/localize.py): file in, DoA JSON out."""
import json
import os

import numpy as np
import pytest

from haghighatshoarmuir2024.tools.localize import main

FS = 48_000


@pytest.fixture(scope="module")
def tone_wav(tmp_path_factory):
    """Mono 1750 Hz tone wav, 0.6 s."""
    from scipy.io import wavfile

    t = np.arange(0, 0.6, 1 / FS)
    sig = (0.7 * np.sin(2 * np.pi * 1750 * t) * 32767).astype(np.int16)
    path = os.path.join(tmp_path_factory.mktemp("audio"), "tone.wav")
    wavfile.write(path, FS, sig)
    return path


def _run(argv, capsys):
    rc = main(argv)
    out = capsys.readouterr().out.strip().splitlines()
    return rc, [json.loads(line) for line in out]


def test_localize_srp_simulated(tone_wav, capsys):
    rc, recs = _run(
        [tone_wav, "--model", "srp", "--band", "1400", "2100",
         "--simulate-doa", "0.7", "--snr-db", "10", "--frame", "0.125",
         "--grid", "129", "--max-frames", "2"],
        capsys,
    )
    assert rc == 0
    frames = [r for r in recs if "frame" in r]
    summary = [r for r in recs if "doa_circmean_deg" in r]
    assert len(frames) == 2 and len(summary) == 1
    err = np.rad2deg(np.arcsin(abs(np.sin(frames[-1]["doa_rad"] - 0.7))))
    assert err < 5.0, frames


def test_localize_xylo_simulated(tone_wav, capsys):
    rc, recs = _run(
        [tone_wav, "--model", "xylo", "--band", "1600", "1900",
         "--simulate-doa", "-1.2", "--snr-db", "10", "--frame", "0.125",
         "--grid", "65", "--max-frames", "1", "--no-calibrate"],
        capsys,
    )
    assert rc == 0
    frames = [r for r in recs if "frame" in r]
    err = np.rad2deg(np.arcsin(abs(np.sin(frames[-1]["doa_rad"] + 1.2))))
    assert err < 25.0, frames


def test_localize_channel_mismatch_errors(tone_wav, capsys):
    rc = main([tone_wav, "--model", "srp", "--band", "1400", "2100",
               "--frame", "0.125", "--max-frames", "1"])
    assert rc == 2  # mono file without --simulate-doa


def test_localize_xylo_multiband_stacked(tone_wav, capsys):
    """Repeated --band builds a multi-band deployment; --stacked uses the
    band-stacked (per-band cosine) matched estimator."""
    rc, recs = _run(
        [tone_wav, "--model", "xylo", "--band", "1600", "1900",
         "--band", "1900", "2200", "--stacked",
         "--simulate-doa", "0.9", "--snr-db", "10", "--frame", "0.125",
         "--grid", "33", "--max-frames", "1"],
        capsys,
    )
    assert rc == 0
    frames = [r for r in recs if "frame" in r]
    err = np.rad2deg(np.arcsin(abs(np.sin(frames[-1]["doa_rad"] - 0.9))))
    assert err < 25.0, frames


def test_localize_stacked_needs_multiband(tone_wav, capsys):
    rc = main([tone_wav, "--model", "xylo", "--band", "1600", "1900",
               "--stacked", "--simulate-doa", "0.9", "--frame", "0.125",
               "--grid", "33", "--max-frames", "1"])
    assert rc == 2


def test_localize_tracked_fields(tone_wav, capsys):
    rc, recs = _run(
        [tone_wav, "--model", "srp", "--band", "1400", "2100",
         "--simulate-doa", "0.7", "--snr-db", "10", "--frame", "0.125",
         "--grid", "129", "--max-frames", "3", "--track"],
        capsys,
    )
    assert rc == 0
    frames = [r for r in recs if "frame" in r]
    assert all("doa_tracked_rad" in r and "doa_tracked_deg" in r for r in frames)
    err = np.rad2deg(np.arcsin(abs(np.sin(frames[-1]["doa_tracked_rad"] - 0.7))))
    assert err < 5.0, frames


def test_localize_music_simulated_unfolded(tone_wav, capsys):
    """--model music: the CLI synthesizes --simulate-doa with the MUSIC
    convention (t - delay), so the estimate lands on the CORRECT side of the
    circle — checked unfolded (the folded metric would hide a 180-deg
    mirror)."""
    rc, recs = _run(
        [tone_wav, "--model", "music", "--band", "1400", "2100",
         "--simulate-doa", "0.7", "--snr-db", "10", "--frame", "0.125",
         "--grid", "129", "--max-frames", "2"],
        capsys,
    )
    assert rc == 0
    frames = [r for r in recs if "frame" in r]
    est = frames[-1]["doa_rad"]
    err = abs(np.arctan2(np.sin(est - 0.7), np.cos(est - 0.7)))
    assert np.rad2deg(err) < 6.0, frames


def test_localize_multi_source_tracks(tone_wav, capsys):
    """--sources 2: per-frame top-K peaks feed the GNN tracker; a single
    simulated source yields exactly one confirmed track once bootstrapped."""
    rc, recs = _run(
        [tone_wav, "--model", "music", "--band", "1400", "2100",
         "--simulate-doa", "0.7", "--snr-db", "10", "--frame", "0.125",
         "--grid", "129", "--max-frames", "4", "--sources", "2"],
        capsys,
    )
    assert rc == 0
    frames = [r for r in recs if "frame" in r]
    assert all("sources" in r for r in frames)
    last = frames[-1]["sources"]
    assert len(last) == 1
    err = abs(np.arctan2(np.sin(last[0]["doa_rad"] - 0.7),
                         np.cos(last[0]["doa_rad"] - 0.7)))
    assert np.rad2deg(err) < 6.0, frames


def test_localize_sources_validation(tone_wav, capsys):
    rc = main([tone_wav, "--model", "music", "--band", "1400", "2100",
               "--simulate-doa", "0.7", "--sources", "0"])
    capsys.readouterr()
    assert rc == 2
