"""Global constants and configuration dataclasses.

The reference (`/root/reference/micloc`) hard-codes its constants in each module
(`beamformer.py:23` ``Fs = 48_000``, `array_geometry.py:14`
``SOUND_SPEED_IN_OPEN_AIR = 340``).  Here they live in one place and every
pipeline is configured through small frozen dataclasses, so a configuration can
be hashed and used as a jit static argument / checkpoint cache key.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

# Sampling rate of the 7-mic dev board (reference: micloc/beamformer.py:23).
FS = 48_000

# Speed of sound (reference: micloc/array_geometry.py:14).
SOUND_SPEED_IN_OPEN_AIR = 340.0


def on_accelerator() -> bool:
    """Whether the default JAX backend is an accelerator (the GPU) rather
    than the CPU.

    The one switch between the two formulations some stages keep: the
    accelerator runs the Pallas LIF kernel and the lifted block IIR, the CPU
    keeps the sequential ``lax.scan`` forms that the float64 goldens pin.
    """
    import jax

    return jax.default_backend() != "cpu"


@dataclasses.dataclass(frozen=True)
class BeamformerConfig:
    """Configuration of the Hilbert beamformer (reference: micloc/beamformer.py:26-71)."""

    kernel_duration: float = 10e-3
    freq_range: Tuple[float, float] = (1600.0, 1900.0)
    fs: float = FS
    bandpass_order: int = 2
    # Chunk of the DoA grid processed per lax.map step at design time
    # (bounds peak HBM use; the reference iterates the grid serially instead).
    design_chunk: int = 64

    @property
    def kernel_length(self) -> int:
        return int(self.fs * self.kernel_duration)


@dataclasses.dataclass(frozen=True)
class SNNBeamformerConfig:
    """Configuration of the SNN Hilbert beamformer (reference: micloc/snn_beamformer.py:24-80)."""

    kernel_duration: float = 10e-3
    freq_range: Tuple[float, float] = (1600.0, 1900.0)
    tau_syn: float = 1.0 / (2.0 * 3.141592653589793 * 1750.0)
    tau_mem: float = 1.0 / (2.0 * 3.141592653589793 * 1750.0)
    bipolar_spikes: bool = False
    fs: float = FS
    bandpass_order: int = 2
    design_chunk: int = 32

    @property
    def kernel_length(self) -> int:
        return int(self.fs * self.kernel_duration)

    @property
    def robust_width(self) -> int:
        # reference: snn_beamformer.py:74-76
        zc_dist = int(self.fs / self.freq_range[1])
        return zc_dist // 2


@dataclasses.dataclass(frozen=True)
class MUSICConfig:
    """Configuration of the narrowband (Bartlett-style) beamformer
    (reference: micloc/music_beamformer.py:22-62)."""

    freq_range: Tuple[float, float] = (1200.0, 2000.0)
    frame_duration: float = 0.25
    fs: float = FS
    bandpass_order: int = 1
