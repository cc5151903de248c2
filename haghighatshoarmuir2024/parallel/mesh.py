"""Device-mesh helpers for multi-chip scaling.

The reference is single-host/serial (SURVEY §2.10); this framework scales by
sharding its two large axes over a ``jax.sharding.Mesh``:

* ``data`` — Monte-Carlo trials / audio frames (pure data parallel; the only
  collectives are ``psum``-style reductions of summary statistics, inserted by
  XLA from sharding constraints);
* ``model`` — the DoA grid (design-time covariance/eigh batches and the hidden
  neuron axis of the SNN at inference).

All helpers work on any device set, including the CPU virtual mesh
(``--xla_force_host_platform_device_count``) used by tests and the driver's
multi-chip dry run.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(
    n_devices: Optional[int] = None,
    shape: Optional[Tuple[int, int]] = None,
    axis_names: Tuple[str, str] = ("data", "model"),
) -> Mesh:
    """Build a 2-D ``(data, model)`` mesh over the first ``n_devices`` devices.

    Default shape puts all devices on the data axis (Monte-Carlo parallelism is
    the dominant axis at this model scale; the model axis exists so the same
    program scales when the grid/neuron axes outgrow one chip).
    """
    devs = jax.devices()
    if n_devices is None:
        n_devices = len(devs)
    if n_devices > len(devs):
        raise ValueError(
            f"make_mesh asked for {n_devices} devices but only {len(devs)} exist "
            f"({[d.platform for d in devs]}). For a virtual multi-device CPU mesh, "
            f"set XLA_FLAGS=--xla_force_host_platform_device_count={n_devices} and "
            f"jax.config.update('jax_platforms', 'cpu') BEFORE the JAX backend "
            f"initializes (see tests/conftest.py)."
        )
    devs = devs[:n_devices]
    if shape is None:
        shape = (n_devices, 1)
    if shape[0] * shape[1] != n_devices:
        raise ValueError(f"mesh shape {shape} does not cover {n_devices} devices")
    arr = np.asarray(devs).reshape(shape)
    return Mesh(arr, axis_names)


def data_sharding(mesh: Mesh, ndim: int, axis: int = 0) -> NamedSharding:
    """NamedSharding that splits dimension ``axis`` over the mesh data axis."""
    spec = [None] * ndim
    spec[axis] = "data"
    return NamedSharding(mesh, P(*spec))


def model_sharding(mesh: Mesh, ndim: int, axis: int = 0) -> NamedSharding:
    spec = [None] * ndim
    spec[axis] = "model"
    return NamedSharding(mesh, P(*spec))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_leading(x, mesh: Mesh, axis_name: str = "data"):
    """Device-put an array with its leading axis sharded over ``axis_name``."""
    spec = [None] * np.ndim(x)
    spec[0] = axis_name
    return jax.device_put(x, NamedSharding(mesh, P(*spec)))


def pad_to_multiple(x, multiple: int, axis: int = 0):
    """Pad the given axis up to a multiple (sharded axes must divide evenly).

    Returns (padded, original_size).
    """
    import jax.numpy as jnp

    n = x.shape[axis]
    pad = (-n) % multiple
    if pad == 0:
        return x, n
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, pad)
    return jnp.pad(x, widths), n
