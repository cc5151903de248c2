"""On-card test suite configuration.

Unlike ``tests/`` (which forces the CPU backend and x64 for the scipy
goldens), this suite runs on the default backend, an NVIDIA GPU, and
exercises the compiled paths: the Pallas LIF kernel as the GPU compiles it,
and the plain-XLA stages as XLA:GPU lowers them.  Every test carries the
``gpu`` marker and skips without a GPU; the decision is made in a fixture,
so every pytest worker collects the same tests.  ``python chip_smoke.py``
runs this suite on the card inside its own process (phase f); by hand::

    python -m pytest tests_gpu/ -q
"""
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@pytest.fixture(autouse=True)
def _require_gpu():
    import jax

    platform = jax.devices()[0].platform
    if platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU (default JAX platform is {platform!r})")
