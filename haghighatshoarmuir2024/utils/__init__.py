"""Utilities: peak location, benchmark statistics, design checkpointing."""

from .peak_location import find_peak_location
from .stats import analyze_doa_samples, mae, window_median
from .cache import DesignCache, design_cache_key
from .isotonic import approx_decreasing, isotonic_increasing
from .profiling import StageTimer, benchmark_fn, device_trace
from .tracking import (
    DoaTracker,
    MultiDoaTracker,
    track_angles,
    track_multi_angles,
    track_step,
)


def to_numpy(x):
    """Device→host transfer that also works for complex arrays on backends
    that support complex only inside compiled programs: real/imag are split
    by a jitted program and travel separately."""
    import numpy as np
    import jax
    import jax.numpy as jnp

    x = jnp.asarray(x)
    if jnp.iscomplexobj(x):
        re, im = jax.jit(lambda v: (jnp.real(v), jnp.imag(v)))(x)
        return np.asarray(re) + 1j * np.asarray(im)
    return np.asarray(x)


__all__ = [
    "find_peak_location",
    "analyze_doa_samples",
    "mae",
    "window_median",
    "DesignCache",
    "design_cache_key",
    "to_numpy",
    "isotonic_increasing",
    "approx_decreasing",
    "StageTimer",
    "benchmark_fn",
    "device_trace",
    "DoaTracker",
    "MultiDoaTracker",
    "track_angles",
    "track_multi_angles",
    "track_step",
]
