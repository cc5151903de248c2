"""Spike encoders (JAX twins of micloc/spike_encoder.py).

All encoders map a ``T x num_chan`` signal to a ``T x num_chan`` spike raster
and are pure jittable functions vectorized over channels (the reference loops
over channels in Python and calls scipy per channel,
micloc/spike_encoder.py:126-137).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from .peaks import find_peaks_mask


class SpikeEncoder:
    """Base class; ``__call__`` aliases ``evolve`` (micloc/spike_encoder.py:15-26)."""

    def evolve(self, sig_in):
        raise NotImplementedError

    def __call__(self, *args, **kwargs):
        return self.evolve(*args, **kwargs)


class IAFSpikeEncoder(SpikeEncoder):
    """Integrate-and-fire on |signal| (micloc/spike_encoder.py:29-60).

    threshold = mean(|x|) * fs / target_rate;
    spikes = diff(floor(cumsum(|x|) / threshold)) — counts may exceed 1.
    """

    def __init__(self, target_spike_rate: float, fs: float):
        self.target_spike_rate = target_spike_rate
        self.fs = fs

    def evolve(self, sig_in):
        sig_in = jnp.asarray(sig_in)
        threshold = jnp.mean(jnp.abs(sig_in)) * self.fs / self.target_spike_rate
        sum_power = jnp.cumsum(jnp.abs(sig_in), axis=0)
        return jnp.diff(jnp.floor(sum_power / threshold), axis=0)


class IAFZeroCrossingSpikeEncoder(SpikeEncoder):
    """IAF applied to cumsum(signal) (micloc/spike_encoder.py:63-97)."""

    def __init__(self, target_spike_rate: float, fs: float):
        self.target_spike_rate = target_spike_rate
        self.fs = fs

    def evolve(self, sig_in):
        sig_in = jnp.asarray(sig_in)
        sig_in_cs = jnp.cumsum(sig_in, axis=0)
        threshold = jnp.mean(jnp.abs(sig_in_cs)) * self.fs / self.target_spike_rate
        sum_power = jnp.cumsum(jnp.abs(sig_in_cs), axis=0)
        return jnp.diff(jnp.floor(sum_power / threshold), axis=0)


def rzcc_encode(sig_in, robust_width: int, bipolar: bool = False):
    """Robust zero-crossing spike encoding of a ``T x C`` signal.

    Peaks of ``cumsum(sig)`` (robust zero-crossings of ``sig``) become +1
    spikes; in bipolar mode, peaks of ``-cumsum(sig)`` become -1 spikes, with
    -1 overwriting +1 on collision exactly as the reference's sequential
    assignment does (micloc/spike_encoder.py:124-137).
    """
    sig_in = jnp.asarray(sig_in)
    # channel-major (C, T) layout keeps the peak kernels batch-native on the
    # time (last) axis — no per-iteration transposes inside the suppression loop
    cs = jnp.cumsum(sig_in.T, axis=-1)
    if bipolar:
        # one batched pass over [cumsum ; -cumsum] covers peaks and valleys
        both = jnp.concatenate([cs, -cs], axis=0)
        masks = find_peaks_mask(both, robust_width)
        C = cs.shape[0]
        peaks, valleys = masks[:C], masks[C:]
        spikes = jnp.where(valleys, -1.0, peaks.astype(sig_in.dtype))
    else:
        spikes = find_peaks_mask(cs, robust_width).astype(sig_in.dtype)
    return spikes.T


class ZeroCrossingSpikeEncoder(SpikeEncoder):
    """The RZCC encoder used by all SNN pipelines (micloc/spike_encoder.py:100-137)."""

    def __init__(self, fs: float, robust_width: int = 1, bipolar: bool = False):
        self.fs = fs
        self.robust_width = robust_width
        self.bipolar = bipolar

    def evolve(self, sig_in):
        return rzcc_encode(sig_in, self.robust_width, self.bipolar)


class PeakSpikeEncoder(SpikeEncoder):
    """find_peaks on the raw signal (micloc/spike_encoder.py:140-167)."""

    def __init__(self, fs: float):
        self.fs = fs

    def evolve(self, sig_in, robust_width: int = 1):
        sig_in = jnp.asarray(sig_in)
        peaks = find_peaks_mask(sig_in.T, robust_width).T
        return peaks.astype(sig_in.dtype)
