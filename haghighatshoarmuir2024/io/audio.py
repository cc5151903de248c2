"""Audio sources — file, synthetic, and dev-board recorder interface.

The reference records live audio by shelling out to ``sox`` and reading the
wav back (micloc/record.py:32-83).  On an accelerator host there is no
microphone array, so the framework defines a pluggable source protocol with three
implementations:

* :class:`SyntheticAudioSource` — synthesizes the array signal from a template
  + DoA trajectory (the reference's own fallback for every offline benchmark);
* :class:`FileAudioSource` — streams frames from an audio file (wav via
  scipy, anything soundfile supports when available);
* :class:`AudioRecorder` — API-compatible with the reference recorder: shells
  out to ``sox`` if present, raising :class:`MultiMicDevKitNotFound` otherwise
  (micloc/record.py:21-22,65-68).
"""
from __future__ import annotations

import os
import subprocess
import tempfile
from typing import Iterator, Optional, Tuple

import numpy as np


class MultiMicDevKitNotFound(Exception):
    """Raised when the multi-mic dev kit / sox capture is unavailable
    (reference: micloc/record.py:21-22)."""


class AudioSource:
    """Protocol: ``frames(duration)`` yields (T, num_channels) float arrays."""

    fs: float = 48_000.0
    num_channels: int = 7

    def frames(self, duration: float) -> Iterator[np.ndarray]:
        raise NotImplementedError


class SyntheticAudioSource(AudioSource):
    """Array signal synthesized from (template, DoA trajectory) + noise."""

    def __init__(
        self,
        geometry,
        time_temp: np.ndarray,
        sig_temp: np.ndarray,
        doa,
        snr_db: Optional[float] = None,
        fs: float = 48_000.0,
        seed: int = 0,
        delay_sign: int = 1,
    ):
        # delay_sign=-1: the reference's MUSIC synthesis convention
        # (t - delay) — required when feeding MUSIC (see
        # ops/interp.signal_from_template)
        from ..ops.interp import signal_from_template

        self.fs = fs
        self.num_channels = len(geometry)
        sig_in = np.asarray(
            signal_from_template(
                geometry, time_temp, sig_temp, doa, fs=fs, delay_sign=delay_sign
            )
        )
        if snr_db is not None:
            rng = np.random.default_rng(seed)
            sigma = np.sqrt(np.mean(sig_in**2) / 10 ** (snr_db / 10))
            sig_in = sig_in + sigma * rng.standard_normal(sig_in.shape)
        self._sig = sig_in.astype(np.float32)

    def frames(self, duration: float) -> Iterator[np.ndarray]:
        n = int(self.fs * duration)
        for start in range(0, self._sig.shape[0] - n + 1, n):
            yield self._sig[start : start + n]


class FileAudioSource(AudioSource):
    """Frames from an audio file (multi-channel wav/flac)."""

    def __init__(self, path: str, fs: Optional[float] = None):
        data, file_fs = _read_audio(path)
        if data.ndim == 1:
            data = data[:, None]
        if fs is not None and fs != file_fs:
            # linear resample to the requested rate
            t_old = np.arange(data.shape[0]) / file_fs
            t_new = np.arange(0, t_old[-1], 1.0 / fs)
            data = np.stack(
                [np.interp(t_new, t_old, data[:, c]) for c in range(data.shape[1])],
                axis=1,
            )
            file_fs = fs
        self.fs = file_fs
        self.num_channels = data.shape[1]
        self._sig = data.astype(np.float32)

    def frames(self, duration: float) -> Iterator[np.ndarray]:
        n = int(self.fs * duration)
        for start in range(0, self._sig.shape[0] - n + 1, n):
            yield self._sig[start : start + n]


def _read_audio(path: str) -> Tuple[np.ndarray, float]:
    ext = os.path.splitext(path)[1].lower()
    if ext == ".wav":
        from scipy.io import wavfile

        fs, data = wavfile.read(path)
        if np.issubdtype(data.dtype, np.integer):
            data = data.astype(np.float64) / np.iinfo(data.dtype).max
        return np.asarray(data, dtype=np.float64), float(fs)
    if ext == ".flac":
        # bundled native decoder (native/flacdec.cpp)
        from .flac import read_flac

        return read_flac(path)
    try:
        import soundfile as sf

        data, fs = sf.read(path, always_2d=False)
        return np.asarray(data, dtype=np.float64), float(fs)
    except ImportError as e:
        raise RuntimeError(
            f"reading {ext} files requires the optional `soundfile` package"
        ) from e


class AudioRecorder:
    """Live capture via sox, API-compatible with micloc/record.py:25-83."""

    def __init__(self, num_channels: int = 8, buffer_size: int = 2048):
        self.num_channels = num_channels
        self.buffer_size = buffer_size

    def record_file(self, duration: float, bits: int = 16, fs: int = 48_000):
        """Record ``duration`` seconds; returns (T, num_channels) int array.

        Shells out to sox exactly like the reference (micloc/record.py:54-60);
        raises MultiMicDevKitNotFound when sox or the device is missing.
        """
        with tempfile.NamedTemporaryFile(suffix=".wav", delete=False) as f:
            fname = f.name
        cmd = [
            "sox",
            "-b", str(bits),
            "-e", "signed-integer",
            "-r", str(fs),
            "-c", str(self.num_channels),
            "-d", "--clobber",
            "--buffer", str(self.buffer_size),
            fname,
            "trim", "0", str(duration),
        ]
        try:
            subprocess.run(cmd, check=True, capture_output=True)
        except (subprocess.CalledProcessError, FileNotFoundError) as e:
            raise MultiMicDevKitNotFound(
                "could not record from the multi-mic dev kit (sox unavailable or "
                "no capture device); use SyntheticAudioSource or FileAudioSource"
            ) from e
        from scipy.io import wavfile

        _, data = wavfile.read(fname)
        os.unlink(fname)
        return data
