"""Tests of the native FLAC decoder (native/flacdec.cpp via ctypes)."""
import os

import numpy as np
import pytest

REF_FLAC = "/root/reference/paper_plots/84-121123-0020.flac"

pytestmark = pytest.mark.skipif(
    not os.path.exists(REF_FLAC), reason="reference flac not mounted"
)


def test_decode_reference_speech_file():
    from haghighatshoarmuir2024.io.flac import read_flac

    data, fs = read_flac(REF_FLAC)
    assert fs == 16_000.0
    assert data.shape[1] == 1
    assert 6.0 < data.shape[0] / fs < 8.0  # ~6.9 s utterance
    assert np.abs(data).max() <= 1.0
    assert np.sqrt((data**2).mean()) > 0.01  # non-silent


def test_decode_matches_embedded_md5():
    """FLAC files carry an MD5 of the raw PCM — end-to-end bit-exactness."""
    from haghighatshoarmuir2024.io.flac import verify_md5

    assert verify_md5(REF_FLAC)


def test_file_audio_source_reads_flac():
    from haghighatshoarmuir2024.io import FileAudioSource

    src = FileAudioSource(REF_FLAC, fs=48_000)
    assert src.fs == 48_000
    frames = list(src.frames(0.25))
    assert len(frames) > 20
    assert frames[0].shape == (12_000, 1)


def test_speech_template_uses_decoder():
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "experiments"))
    from common import speech_template

    t, sig = speech_template(duration=1.0)
    assert len(sig) == 48_000
    assert np.abs(sig).max() <= 1.0 + 1e-9
