"""Design checkpointing — serialize designed beamforming matrices and
quantized SNN configs, keyed by configuration hash.

The reference recomputes every beamforming design at process start (minutes of
serial work, SURVEY §5 "checkpoint/resume: none").  Here a design is a pure
function of (geometry, band, grid, kernel, encoder, template) — so it is
cached on disk as an .npz keyed by a SHA-256 of those inputs, making process
restarts and benchmark reruns free.
"""
from __future__ import annotations

import hashlib
import json
import os
from pathlib import Path
from typing import Dict, Optional

import numpy as np

# Everything the program caches lives inside the checkout, under the
# gitignored ``.cache/`` directory: ``designs/`` for design and calibration
# npz files (override with ``HM2024_DESIGN_CACHE``), ``jax/`` for compiled
# executables unless ``JAX_COMPILATION_CACHE_DIR`` names another directory.
_CACHE_ROOT = Path(__file__).resolve().parents[2] / ".cache"
_DEFAULT_DIR = os.environ.get("HM2024_DESIGN_CACHE", str(_CACHE_ROOT / "designs"))

# Repo-bundled designs/calibrations (committed), keyed exactly like the
# user cache: a fresh checkout finds the flagship design and calibration
# without any device work.
_BUNDLED_DIR = Path(__file__).resolve().parent.parent / "data" / "designs"

_persistent_cache_enabled = False


def compilation_cache_dir() -> str:
    """Where compiled executables persist: ``JAX_COMPILATION_CACHE_DIR`` when
    it is set (JAX reads it into ``jax_compilation_cache_dir`` itself),
    otherwise one fixed directory inside the checkout.  The path is part of
    the executables' cache key, so it must not move between runs."""
    import jax

    return jax.config.jax_compilation_cache_dir or str(_CACHE_ROOT / "jax")


def enable_persistent_compilation_cache() -> None:
    """Turn on JAX's persistent compilation cache at
    :func:`compilation_cache_dir`.  Idempotent.  Cache keys are stable
    because every jitted program closes over numpy constants only."""
    global _persistent_cache_enabled
    if _persistent_cache_enabled:
        return
    import jax

    cache_dir = compilation_cache_dir()
    os.makedirs(cache_dir, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    _persistent_cache_enabled = True


def design_cache_key(**kwargs) -> str:
    """Stable hash of design inputs: arrays are hashed by bytes, everything
    else through canonical JSON."""
    h = hashlib.sha256()
    for name in sorted(kwargs):
        v = kwargs[name]
        h.update(name.encode())
        if isinstance(v, np.ndarray):
            h.update(str(v.dtype).encode())
            h.update(str(v.shape).encode())
            h.update(np.ascontiguousarray(v).tobytes())
        else:
            h.update(json.dumps(v, sort_keys=True, default=str).encode())
    return h.hexdigest()[:32]


class DesignCache:
    def __init__(self, cache_dir: Optional[str] = None):
        self.dir = Path(cache_dir or _DEFAULT_DIR)

    def _path(self, key: str) -> Path:
        return self.dir / f"{key}.npz"

    def load(self, key: str) -> Optional[Dict[str, np.ndarray]]:
        # user cache first (freshest), then the repo-bundled artifacts — a
        # fresh checkout/container finds the flagship design + calibration
        # without any device work
        for p in (self._path(key), _BUNDLED_DIR / f"{key}.npz"):
            if not p.exists():
                continue
            try:
                with np.load(p, allow_pickle=False) as z:
                    return {k: z[k] for k in z.files}
            except Exception:
                continue
        return None

    def save(self, key: str, arrays: Dict[str, np.ndarray]) -> None:
        self.dir.mkdir(parents=True, exist_ok=True)
        tmp = self._path(key).with_suffix(".tmp.npz")
        np.savez(tmp, **{k: np.asarray(v) for k, v in arrays.items()})
        os.replace(tmp, self._path(key))
