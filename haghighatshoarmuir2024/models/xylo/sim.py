"""Integer LIF simulator — the XyloSim equivalent, as a jitted lax.scan.

The reference simulates the quantized network with rockpool's ``XyloSim``
(timestep-serial Python/C, micloc/xylo_snn_localization.py:286-313,358-377).
Here the integer dynamics are a ``lax.scan`` over time:

per step, per hidden neuron (all int32):

    isyn ← isyn − (isyn >> dash_syn) + Σ_in w_in·spk_in + Σ_hid w_rec·spk_hid
    vmem ← vmem − (vmem >> dash_mem) + isyn          (saturating 16-bit)
    spk  ← vmem ≥ threshold                           (binary, subtract reset)

Bitshift decay (``state -= state >> dash``) is the Xylo-A2 hardware decay; the
shift is arithmetic, matching the hardware's behavior on negative states.  The
heavy input projection ``spikes_in @ w_in`` runs *outside* the scan as one
batched matmul (exact: all products/sums stay far below 2^24, so
float32 accumulation is integer-exact); the scan body is purely elementwise.
The ubiquitous uniform recurrence ``w_rec = c·ones`` (DC cancellation,
micloc/xylo_snn_localization.py:230-232) is detected and reduced to a scalar
``c·Σ spk`` instead of a matvec.

Bit-exactness caveat: rockpool/xylosim is not importable in this environment,
so the exact *ordering* of decay vs. integration follows the documented
LIFBitshift convention (decay previous state, then integrate).  The quantized
pipeline's DoA statistics are validated against the float pipeline instead
(tests/test_xylo.py), which is the contract the reference's own accuracy
harnesses check (paper_plots/target_xylo_localization.py).

To BOUND that caveat by measurement rather than assertion, every plausible
alternative step convention is implemented behind static flags
(``ordering`` in {"decay_first", "integrate_first"} × ``reset`` in
{"subtract", "zero"}) and ``experiments/xylo_ordering_sensitivity.py`` runs
the localization Monte-Carlo under each, reporting the DoA-statistic delta
(RESULTS.md "XyloSim step-ordering sensitivity").  The default is pinned by
tests/test_xylo_sim.py.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional

import numpy as np
import jax
import jax.numpy as jnp

from .quantize import XyloConfig

_STATE_MIN = -(2**15)
_STATE_MAX = 2**15 - 1
# integer spikes and weights are exact in float32 only at full precision: a
# float32 dot may otherwise run in TF32 on the GPU
_EXACT = jax.lax.Precision.HIGHEST


def _sat(x):
    return jnp.clip(
        x, jnp.int32(_STATE_MIN), jnp.int32(_STATE_MAX)
    ).astype(jnp.int32)


@functools.partial(
    jax.jit, static_argnames=("uniform_rec", "record", "ordering", "reset")
)
def _sim_hidden(
    inp,
    w_rec,
    rec_coef,
    dash_syn,
    dash_mem,
    threshold,
    state0,
    uniform_rec,
    record,
    ordering: str = "decay_first",
    reset: str = "subtract",
):
    """Scan the hidden-layer integer LIF over time.

    Args:
        inp: (T, N) int32 pre-summed input current per step.
        state0: (isyn, vmem, spk) int32 (N,) initial state.
        ordering: "decay_first" (default; decay the previous state, then add
            this step's input — the documented LIFBitshift convention) or
            "integrate_first" (add the input, then apply the bitshift decay
            to the updated state — the other plausible reading of the
            hardware step, measured in experiments/xylo_ordering_sensitivity.py).
        reset: "subtract" (default; vmem -= threshold on spike, Xylo-A2
            membrane subtract-reset) or "zero" (reset-to-zero).

    Returns:
        (spikes (T, N) int32, final_state, rec dict)
    """
    if ordering not in ("decay_first", "integrate_first"):
        raise ValueError(f"unknown ordering {ordering!r}")
    if reset not in ("subtract", "zero"):
        raise ValueError(f"unknown reset {reset!r}")

    def step(carry, inp_t):
        isyn, vmem, spk = carry
        if uniform_rec:
            rec_in = rec_coef * jnp.sum(spk)
        else:
            rec_in = jnp.dot(
                spk.astype(jnp.float32), w_rec.astype(jnp.float32),
                preferred_element_type=jnp.float32, precision=_EXACT,
            ).astype(jnp.int32)
        if ordering == "decay_first":
            isyn = _sat(isyn - jax.lax.shift_right_arithmetic(isyn, dash_syn) + inp_t + rec_in)
            vmem = _sat(vmem - jax.lax.shift_right_arithmetic(vmem, dash_mem) + isyn)
        else:  # integrate_first
            x = _sat(isyn + inp_t + rec_in)
            isyn = _sat(x - jax.lax.shift_right_arithmetic(x, dash_syn))
            y = _sat(vmem + isyn)
            vmem = _sat(y - jax.lax.shift_right_arithmetic(y, dash_mem))
        spk_new = (vmem >= threshold).astype(jnp.int32)
        if reset == "subtract":
            vmem = vmem - spk_new * threshold
        else:
            vmem = jnp.where(spk_new > 0, jnp.int32(0), vmem)
        out = (spk_new, isyn, vmem) if record else (spk_new,)
        return (isyn, vmem, spk_new), out

    carry, outs = jax.lax.scan(step, state0, inp)
    spikes = outs[0]
    rec = {"Isyn": outs[1], "Vmem": outs[2]} if record else {}
    return spikes, carry, rec


class XyloSim:
    """Software twin of the Xylo-A2 chip for the quantized localization SNN.

    API mirrors the rockpool usage in the reference:
    ``sim.reset_state(); out, state, rec = sim(spikes, record=True)`` with the
    hidden spikes in ``rec["Spikes"]`` (micloc/xylo_snn_localization.py:358-377).
    """

    def __init__(
        self,
        config: XyloConfig,
        output_mode: str = "Spike",
        ordering: str = "decay_first",
        reset: str = "subtract",
    ):
        self.config = config
        self.output_mode = output_mode
        self.ordering = ordering
        self.reset = reset
        self.dt = config.dt

        self._w_in = jnp.asarray(config.w_in, dtype=jnp.int32)
        self._w_rec = jnp.asarray(config.w_rec, dtype=jnp.int32)
        self._w_out = jnp.asarray(config.w_out, dtype=jnp.int32)
        self._dash_syn = jnp.asarray(config.dash_syn, dtype=jnp.int32)
        self._dash_mem = jnp.asarray(config.dash_mem, dtype=jnp.int32)
        self._threshold = jnp.asarray(config.threshold, dtype=jnp.int32)
        self._dash_syn_out = jnp.asarray(config.dash_syn_out, dtype=jnp.int32)
        self._dash_mem_out = jnp.asarray(config.dash_mem_out, dtype=jnp.int32)
        self._threshold_out = jnp.asarray(config.threshold_out, dtype=jnp.int32)

        wr = np.asarray(config.w_rec)
        self._uniform_rec = bool(wr.size) and np.all(wr == wr.flat[0])
        self._rec_coef = jnp.asarray(int(wr.flat[0]) if self._uniform_rec else 0, jnp.int32)

        self.reset_state()

    @classmethod
    def from_config(cls, config: XyloConfig, output_mode: str = "Spike", dt: Optional[float] = None):
        sim = cls(config, output_mode=output_mode)
        if dt is not None:
            sim.dt = dt
        return sim

    def reset_state(self):
        n = self.config.n_hidden
        m = self.config.n_out
        self._state = tuple(jnp.zeros(n, jnp.int32) for _ in range(3))
        self._state_out = tuple(jnp.zeros(m, jnp.int32) for _ in range(3))

    # ------------------------------------------------------------------ evolve
    def _project_in(self, spikes_in):
        """Input projection (float32 accumulation is integer-exact for int8
        weights × small spike counts)."""
        s = jnp.asarray(spikes_in).astype(jnp.float32)
        return jnp.dot(
            s, self._w_in.astype(jnp.float32), preferred_element_type=jnp.float32,
            precision=_EXACT,
        ).astype(jnp.int32)

    def __call__(self, spikes_in, record: bool = False, record_power: bool = False):
        """Evolve the full network.

        Args:
            spikes_in: (T, N_in) integer spike counts.

        Returns:
            (out, state, rec) where ``rec["Spikes"]`` holds the hidden-layer
            spike raster (T, N_hid).
        """
        inp = self._project_in(spikes_in)
        spikes, self._state, rec_h = _sim_hidden(
            inp,
            self._w_rec,
            self._rec_coef,
            self._dash_syn,
            self._dash_mem,
            self._threshold,
            self._state,
            uniform_rec=self._uniform_rec,
            record=record,
            ordering=self.ordering,
            reset=self.reset,
        )

        # output layer (readout LIF; the localization pipeline only uses the
        # hidden raster, micloc/xylo_snn_localization.py:372-377)
        out_in = jnp.dot(
            spikes.astype(jnp.float32),
            self._w_out.astype(jnp.float32),
            preferred_element_type=jnp.float32,
            precision=_EXACT,
        ).astype(jnp.int32)
        out, self._state_out, _ = _sim_hidden(
            out_in,
            jnp.zeros((self.config.n_out, self.config.n_out), jnp.int32),
            jnp.asarray(0, jnp.int32),
            self._dash_syn_out,
            self._dash_mem_out,
            self._threshold_out,
            self._state_out,
            uniform_rec=True,
            record=False,
            ordering=self.ordering,
            reset=self.reset,
        )

        rec: Dict[str, jnp.ndarray] = {"Spikes": spikes}
        rec.update(rec_h)
        if record_power:
            # software power proxy: hidden synaptic event count per step
            rec["synops"] = jnp.sum(jnp.abs(inp), axis=1)
        state = {"hidden": self._state, "out": self._state_out}
        return out, state, rec

    def evolve_to_hidden(self, spikes_hidden_in, record: bool = False):
        """Push spike currents directly into the hidden layer, bypassing w_in —
        the ``_evolve_to_hidden`` path of the push-to-hidden variant
        (micloc/xylo_snn_localization_push_to_hidden.py:379)."""
        inp = jnp.asarray(spikes_hidden_in).astype(jnp.int32)
        spikes, self._state, rec_h = _sim_hidden(
            inp,
            self._w_rec,
            self._rec_coef,
            self._dash_syn,
            self._dash_mem,
            self._threshold,
            self._state,
            uniform_rec=self._uniform_rec,
            record=record,
        )
        rec = {"Spikes": spikes}
        rec.update(rec_h)
        return spikes, {"hidden": self._state}, rec


class XyloSimPushToHidden:
    """Two-population hidden simulator for the push-to-hidden deployment.

    The reference maps ``Linear(dummy) → LIF(n1) → Linear(weight) → LIF(n2,
    rec) → Linear(ones) → LIF(1)`` onto Xylo
    (micloc/xylo_snn_localization_push_to_hidden.py:221-273): on the chip both
    LIF populations live in the single hidden array with the block recurrent
    matrix ``[[0, weight], [0, w_rec]]``, and ``_evolve_to_hidden`` injects the
    input spikes directly into the first population, bypassing the (all-zero)
    dummy input weights (:379).

    Here the block matrix is simulated in *decomposed* form — stage 1 is an
    elementwise scan (no recurrent input reaches it), its spikes are delayed by
    one step (recurrent connections on Xylo act on the previous step's spikes)
    and projected through ``weight`` as ONE batched matmul, then stage 2
    scans with its own recurrence.  This is exactly equivalent to scanning the
    block matrix, without a (n1+n2)² matvec inside the scan.

    Injection scale: rockpool's ``_evolve_to_hidden`` spike-injection weight is
    not publicly documented (hardware-only private API); we inject one
    quantized threshold's worth of synaptic charge per input spike (unit gain
    in float units) — deviation documented in DemoPushToHidden.
    """

    def __init__(
        self,
        config: XyloConfig,
        injection_weight: int,
        dash_syn_in: np.ndarray,
        dash_mem_in: np.ndarray,
        threshold_in: np.ndarray,
    ):
        self.config = config
        self.dt = config.dt
        self.n_stage1 = config.n_in
        self.n_stage2 = config.n_hidden

        self._inj = jnp.asarray(int(injection_weight), jnp.int32)
        self._dash_syn_in = jnp.asarray(dash_syn_in, jnp.int32)
        self._dash_mem_in = jnp.asarray(dash_mem_in, jnp.int32)
        self._threshold_in = jnp.asarray(threshold_in, jnp.int32)

        self._w = jnp.asarray(config.w_in, jnp.int32)  # stage1 → stage2
        self._w_rec = jnp.asarray(config.w_rec, jnp.int32)
        self._dash_syn = jnp.asarray(config.dash_syn, jnp.int32)
        self._dash_mem = jnp.asarray(config.dash_mem, jnp.int32)
        self._threshold = jnp.asarray(config.threshold, jnp.int32)

        wr = np.asarray(config.w_rec)
        self._uniform_rec = bool(wr.size) and np.all(wr == wr.flat[0])
        self._rec_coef = jnp.asarray(int(wr.flat[0]) if self._uniform_rec else 0, jnp.int32)

        self.reset_state()

    def reset_state(self):
        self._state1 = tuple(jnp.zeros(self.n_stage1, jnp.int32) for _ in range(3))
        self._state2 = tuple(jnp.zeros(self.n_stage2, jnp.int32) for _ in range(3))

    def evolve_to_hidden(self, spikes_in, record: bool = False):
        """Input spike raster (T, n_stage1) → full hidden raster
        (T, n_stage1 + n_stage2) in ``rec["Spikes"]``."""
        spikes_in = jnp.asarray(spikes_in).astype(jnp.int32)
        inp1 = spikes_in * self._inj
        no_rec = jnp.zeros((0, 0), jnp.int32)
        last_spk1 = self._state1[2]  # previous call's final stage-1 spikes
        spk1, self._state1, rec1 = _sim_hidden(
            inp1,
            no_rec,
            jnp.asarray(0, jnp.int32),
            self._dash_syn_in,
            self._dash_mem_in,
            self._threshold_in,
            self._state1,
            uniform_rec=True,
            record=record,
        )
        # recurrent fabric acts on the PREVIOUS step's spikes: delay stage-1
        # output by one step before projecting (seam carried across calls via
        # the spk component of the stage-1 state)
        prev_spk1 = jnp.concatenate([last_spk1[None], spk1[:-1]])
        inp2 = jnp.dot(
            prev_spk1.astype(jnp.float32),
            self._w.astype(jnp.float32),
            preferred_element_type=jnp.float32,
            precision=_EXACT,
        ).astype(jnp.int32)
        spk2, self._state2, rec2 = _sim_hidden(
            inp2,
            self._w_rec,
            self._rec_coef,
            self._dash_syn,
            self._dash_mem,
            self._threshold,
            self._state2,
            uniform_rec=self._uniform_rec,
            record=record,
        )
        spikes = jnp.concatenate([spk1, spk2], axis=1)
        rec = {"Spikes": spikes}
        if record:
            rec["Isyn"] = jnp.concatenate([rec1["Isyn"], rec2["Isyn"]], axis=1)
            rec["Vmem"] = jnp.concatenate([rec1["Vmem"], rec2["Vmem"]], axis=1)
        state = {"stage1": self._state1, "stage2": self._state2}
        return spikes, state, rec


def sim_hidden_batch(
    config: XyloConfig,
    spikes_in_batch,
    ordering: str = "decay_first",
    reset: str = "subtract",
):
    """Stateless batched evolve: (B, T, N_in) → hidden spikes (B, T, N_hid).

    The Monte-Carlo path: one vmapped scan, so the per-step elementwise update
    covers B×N lanes at once.  ``ordering``/``reset`` select the LIF step
    convention (see :func:`_sim_hidden`) for the sensitivity study in
    experiments/xylo_ordering_sensitivity.py.
    """
    w_in = jnp.asarray(config.w_in, jnp.int32)
    wr = np.asarray(config.w_rec)
    uniform = bool(wr.size) and np.all(wr == wr.flat[0])
    rec_coef = jnp.asarray(int(wr.flat[0]) if uniform else 0, jnp.int32)
    w_rec = jnp.asarray(config.w_rec, jnp.int32)
    dash_syn = jnp.asarray(config.dash_syn, jnp.int32)
    dash_mem = jnp.asarray(config.dash_mem, jnp.int32)
    threshold = jnp.asarray(config.threshold, jnp.int32)

    def one(spikes_in):
        inp = jnp.dot(
            spikes_in.astype(jnp.float32),
            w_in.astype(jnp.float32),
            preferred_element_type=jnp.float32,
            precision=_EXACT,
        ).astype(jnp.int32)
        n = config.n_hidden
        state0 = tuple(jnp.zeros(n, jnp.int32) for _ in range(3))
        spikes, _, _ = _sim_hidden(
            inp, w_rec, rec_coef, dash_syn, dash_mem, threshold, state0,
            uniform_rec=uniform, record=False, ordering=ordering, reset=reset,
        )
        return spikes

    return jax.vmap(one)(jnp.asarray(spikes_in_batch))
