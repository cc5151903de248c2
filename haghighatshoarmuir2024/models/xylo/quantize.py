"""Quantization of a float XyloSpec to hardware-constrained integers.

Replaces rockpool's ``transform.quantize_methods.global_quantize`` +
``config_from_specification`` (micloc/xylo_snn_localization.py:276-284) with a
pure-NumPy pipeline:

* one *global* scale maps the largest |weight| across w_in/w_rec/w_out onto the
  int8 range, with the same scale applied to thresholds (so spike counts are
  invariant), capped so thresholds stay within their 16-bit field;
* taus become bitshift "dash" exponents: the hardware decays state by
  ``state -= state >> dash`` per step, i.e. a decay factor (1 - 2^-dash),
  so ``dash = round(log2(tau/dt))`` (rockpool's tau↔dash convention);
* a constraint validator enforces the Xylo-A2 resource limits the reference
  scripts mention: ≤16 input channels on real hardware
  (micloc/xylo_snn_localization.py:596-601), ≤1000 hidden neurons, fan-out ≤63
  (micloc/xylo_snn_localization_push_to_hidden.py:181-218).
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from .spec import XyloSpec

WEIGHT_BITS = 8
THRESHOLD_BITS = 16
DASH_MAX = 15
MAX_HIDDEN_NEURONS = 1000
MAX_INPUT_CHANNELS_HW = 16
MAX_FAN_OUT = 63
STATE_BITS = 16  # isyn/vmem register width


@dataclasses.dataclass
class XyloConfig:
    """Integer hardware configuration (the ``config_from_specification``
    equivalent) — everything the integer simulator needs."""

    w_in: np.ndarray  # int8-range int32 (N_in, N_hid)
    w_rec: np.ndarray  # (N_hid, N_hid)
    w_out: np.ndarray  # (N_hid, N_out)
    dash_syn: np.ndarray  # per hidden neuron, int
    dash_mem: np.ndarray
    dash_syn_out: np.ndarray
    dash_mem_out: np.ndarray
    threshold: np.ndarray  # int per hidden neuron
    threshold_out: np.ndarray
    dt: float
    weight_scale: float  # float->int scale actually applied

    @property
    def n_in(self) -> int:
        return self.w_in.shape[0]

    @property
    def n_hidden(self) -> int:
        return self.w_in.shape[1]

    @property
    def n_out(self) -> int:
        return self.w_out.shape[1]


def tau_to_dash(tau: np.ndarray, dt: float) -> np.ndarray:
    """Bitshift decay exponent for a time constant: decay/step = 1 - 2^-dash
    ≈ exp(-dt/tau) ⇒ dash ≈ log2(tau/dt)."""
    tau = np.asarray(tau, dtype=np.float64)
    dash = np.round(np.log2(np.maximum(tau / dt, 1.0)))
    return np.clip(dash, 0, DASH_MAX).astype(np.int32)


def dash_to_tau(dash: np.ndarray, dt: float) -> np.ndarray:
    """Inverse mapping (effective tau of a dash value)."""
    return dt * (2.0 ** np.asarray(dash, dtype=np.float64))


def global_quantize(spec: XyloSpec) -> XyloConfig:
    """Global-scale int8 quantization of all weights + thresholds."""
    w_max = max(
        np.abs(spec.w_in).max(),
        np.abs(spec.w_rec).max() if spec.w_rec.size else 0.0,
        np.abs(spec.w_out).max(),
    )
    if w_max == 0:
        raise ValueError("cannot quantize an all-zero network")

    w_limit = 2 ** (WEIGHT_BITS - 1) - 1  # 127
    t_limit = 2 ** (THRESHOLD_BITS - 1) - 1  # 32767

    scale = w_limit / w_max
    # keep thresholds representable under the same scale
    t_max = max(np.abs(spec.threshold).max(), np.abs(spec.threshold_out).max())
    if t_max * scale > t_limit:
        scale = t_limit / t_max

    def q(w):
        return np.round(np.asarray(w, dtype=np.float64) * scale).astype(np.int32)

    return XyloConfig(
        w_in=q(spec.w_in),
        w_rec=q(spec.w_rec),
        w_out=q(spec.w_out),
        dash_syn=tau_to_dash(spec.tau_syn, spec.dt),
        dash_mem=tau_to_dash(spec.tau_mem, spec.dt),
        dash_syn_out=tau_to_dash(spec.tau_syn_out, spec.dt),
        dash_mem_out=tau_to_dash(spec.tau_mem_out, spec.dt),
        threshold=np.maximum(q(spec.threshold), 1),
        threshold_out=np.maximum(q(spec.threshold_out), 1),
        dt=spec.dt,
        weight_scale=float(scale),
    )


def validate_config(
    config: XyloConfig, hardware: bool = False, enforce_fan_out: bool = False,
    resource_limits: bool = True,
) -> List[str]:
    """Check the configuration against Xylo-A2 resource constraints.

    Returns a list of human-readable violation messages (empty = valid).
    ``hardware=True`` additionally applies the XyloSamna-only limits
    (micloc/xylo_snn_localization.py:596-601); the software simulator is
    unconstrained there, matching XyloSim.  ``resource_limits=False`` skips
    the chip RESOURCE caps (hidden-neuron count) while keeping the numeric
    quantization-range checks — the integer simulator has no neuron-count limit,
    so configurations beyond the physical chip (e.g. 3 bands x 449-grid) can
    run as software deployments (a documented beyond-reference capability).
    """
    problems = []
    w_limit = 2 ** (WEIGHT_BITS - 1) - 1
    for name, w in (("w_in", config.w_in), ("w_rec", config.w_rec), ("w_out", config.w_out)):
        if np.abs(w).max(initial=0) > w_limit:
            problems.append(f"{name} exceeds the {WEIGHT_BITS}-bit weight range")
    if resource_limits and config.n_hidden > MAX_HIDDEN_NEURONS:
        problems.append(
            f"{config.n_hidden} hidden neurons exceed the Xylo-A2 limit of {MAX_HIDDEN_NEURONS}"
        )
    if np.max(config.dash_syn, initial=0) > DASH_MAX or np.max(config.dash_mem, initial=0) > DASH_MAX:
        problems.append("dash values exceed the 4-bit range")
    if np.abs(config.threshold).max(initial=0) > 2 ** (THRESHOLD_BITS - 1) - 1:
        problems.append("thresholds exceed the 16-bit range")
    if hardware and config.n_in > MAX_INPUT_CHANNELS_HW:
        problems.append(
            f"XyloSamna supports at most {MAX_INPUT_CHANNELS_HW} input channels "
            f"(got {config.n_in}); use a single frequency band and unipolar spikes"
        )
    if enforce_fan_out:
        fan_out = np.count_nonzero(config.w_rec, axis=1)
        if fan_out.size and fan_out.max() > MAX_FAN_OUT:
            problems.append(
                f"recurrent fan-out {fan_out.max()} exceeds the Xylo limit of {MAX_FAN_OUT}; "
                "apply spec.truncate_fan_out"
            )
    return problems
