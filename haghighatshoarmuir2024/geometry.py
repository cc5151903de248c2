"""Array geometries and the wave-propagation delay model.

JAX re-design of the reference geometry layer
(reference: micloc/array_geometry.py:17-131).

The key difference from the reference: ``delays`` is written in jnp and is
polymorphic in the shape of ``theta`` — a scalar gives the per-mic delay vector
(M,), a DoA grid (G,) gives the full (G, M) delay matrix in one vectorized
expression, and a per-sample DoA trajectory (T,) gives (T, M).  The reference
computes these one angle at a time in Python loops
(micloc/beamformer.py:113-115, micloc/music_beamformer.py:76-81).
"""
from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from .config import SOUND_SPEED_IN_OPEN_AIR


class ArrayGeometry:
    """Maps element polar coordinates to per-DoA propagation delays.

    Reference: micloc/array_geometry.py:17-61.
    """

    def __init__(self, r_vec, theta_vec, speed: float = SOUND_SPEED_IN_OPEN_AIR):
        r_vec = np.asarray(r_vec, dtype=np.float64)
        theta_vec = np.asarray(theta_vec, dtype=np.float64)
        if np.any(r_vec < 0):
            raise ValueError(
                "distances of the elements in `r_vec` should be all positive!"
            )
        self.r_vec = r_vec
        self.theta_vec = theta_vec
        self.speed = float(speed)

    def delays(self, theta, normalized: bool = True):
        """Relative delay of the array elements for a wave with DoA ``theta``.

        Args:
            theta: scalar DoA, or an array of DoAs of shape (...,).
            normalized: shift delays so the minimum (per DoA) is 0.

        Returns:
            jnp array of shape ``theta.shape + (num_mic,)``.

        Reference semantics: micloc/array_geometry.py:40-57
        (``-r·cos(θ_vec − θ)/speed``, optionally min-shifted to 0).
        """
        theta = jnp.asarray(theta)
        r = jnp.asarray(self.r_vec, dtype=theta.dtype if jnp.issubdtype(theta.dtype, jnp.floating) else jnp.float64)
        tv = jnp.asarray(self.theta_vec, dtype=r.dtype)
        d = -r * jnp.cos(tv - theta[..., None]) / self.speed
        if normalized:
            d = d - jnp.min(d, axis=-1, keepdims=True)
        return d

    def delays_np(self, theta, normalized: bool = True) -> np.ndarray:
        """NumPy (host) twin of :meth:`delays` for setup-time code paths."""
        theta = np.asarray(theta, dtype=np.float64)
        d = -self.r_vec * np.cos(self.theta_vec - theta[..., None]) / self.speed
        if normalized:
            d = d - np.min(d, axis=-1, keepdims=True)
        return d

    def __len__(self) -> int:
        return len(self.r_vec)


class CircularArray(ArrayGeometry):
    """Uniform circular array (reference: micloc/array_geometry.py:64-78).

    NOTE: the reference uses ``np.linspace(0, 2π, num_mic)`` which includes both
    endpoints, so the first and last microphones coincide
    (micloc/array_geometry.py:76).  That quirk is reproduced by default for
    apples-to-apples accuracy comparisons; pass ``endpoint=False`` for the
    physically sensible layout.
    """

    def __init__(self, radius, num_mic, speed=SOUND_SPEED_IN_OPEN_AIR, endpoint=True):
        r_vec = radius * np.ones(num_mic)
        theta_vec = np.linspace(0, 2 * np.pi, num_mic, endpoint=endpoint)
        super().__init__(r_vec=r_vec, theta_vec=theta_vec, speed=speed)


class CenterCircularArray(ArrayGeometry):
    """Ring of ``num_mic - 1`` microphones plus one at the center
    (reference: micloc/array_geometry.py:81-94, same endpoint quirk)."""

    def __init__(self, radius, num_mic, speed=SOUND_SPEED_IN_OPEN_AIR, endpoint=True):
        r_vec = np.array([*(radius * np.ones(num_mic - 1)), 0.0])
        theta_vec = np.array(
            [*np.linspace(0, 2 * np.pi, num_mic - 1, endpoint=endpoint), 0.0]
        )
        super().__init__(r_vec=r_vec, theta_vec=theta_vec, speed=speed)


class LinearArray(ArrayGeometry):
    """Uniform linear array with signed positions folded into polar form
    (reference: micloc/array_geometry.py:97-119)."""

    def __init__(self, spacing, num_mic, radius=None, speed=SOUND_SPEED_IN_OPEN_AIR):
        r_vec = spacing * (np.arange(-num_mic / 2, num_mic / 2) + 0.5)
        theta_vec = np.zeros(num_mic)
        theta_vec[r_vec < 0] += np.pi
        r_vec = np.abs(r_vec)
        super().__init__(r_vec=r_vec, theta_vec=theta_vec, speed=speed)
        self.radius = radius


class Random2DArray(ArrayGeometry):
    """Microphones uniform on a disk (reference: micloc/array_geometry.py:122-131).

    Takes an optional ``rng`` / ``seed`` so experiments are reproducible (the
    reference draws from the global NumPy RNG).
    """

    def __init__(self, radius, num_mic, speed=SOUND_SPEED_IN_OPEN_AIR, seed=None, rng=None):
        if rng is None:
            rng = np.random.default_rng(seed) if seed is not None else np.random
        r_vec = np.sqrt(rng.rand(num_mic) if hasattr(rng, "rand") else rng.random(num_mic)) * radius
        theta_vec = (rng.rand(num_mic) if hasattr(rng, "rand") else rng.random(num_mic)) * 2 * np.pi
        super().__init__(r_vec=r_vec, theta_vec=theta_vec, speed=speed)
        self.radius = radius
