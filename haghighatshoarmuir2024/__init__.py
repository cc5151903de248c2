"""haghighatshoarmuir2024 — a JAX microphone-array sound-source
localization framework.

A ground-up JAX/XLA/Pallas re-design of the capabilities of
synsense/HaghighatshoarMuir2024 ("Low-power SNN-based audio source localisation
using a Hilbert Transform spike encoding scheme", arXiv:2402.11748):

* Hilbert (STHT) beamforming — batched covariance + eigh over the full DoA grid
* narrowband MUSIC-style beamforming — framed FFT + steering matmuls
* float32 SNN Hilbert beamforming — RZCC spike encoding + LIF filtering
* quantized Xylo™-style SNN deployment — int8 weights, bitshift-decay integer
  LIF as a scan / Pallas GPU kernel, with the quantization + constraint pipeline

All compute paths are pure jittable functions vmapped over {DoA grid, mics,
frequency bands, Monte-Carlo seeds} and shardable over a device mesh.
"""

__version__ = "0.3.2"

from .config import FS, SOUND_SPEED_IN_OPEN_AIR
from .geometry import (
    ArrayGeometry,
    CircularArray,
    CenterCircularArray,
    LinearArray,
    Random2DArray,
)
from .ops import (
    Envelope,
    Filterbank,
    ButterworthFilterbank,
    IAFSpikeEncoder,
    IAFZeroCrossingSpikeEncoder,
    PeakSpikeEncoder,
    SpikeEncoder,
    ZeroCrossingSpikeEncoder,
)

__all__ = [
    "FS",
    "SOUND_SPEED_IN_OPEN_AIR",
    "ArrayGeometry",
    "CircularArray",
    "CenterCircularArray",
    "LinearArray",
    "Random2DArray",
    "Envelope",
    "Filterbank",
    "ButterworthFilterbank",
    "SpikeEncoder",
    "IAFSpikeEncoder",
    "IAFZeroCrossingSpikeEncoder",
    "ZeroCrossingSpikeEncoder",
    "PeakSpikeEncoder",
]
