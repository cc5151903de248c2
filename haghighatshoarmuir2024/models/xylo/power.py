"""Neuromorphic energy estimation — the software replacement for
``run_power_measurement`` (micloc/xylo_snn_localization.py:544-682).

The reference measures real µW from the Xylo-A2 dev board's power rails and
scales by (real inference time / audio time).  Without the board, the
established proxy for digital neuromorphic cost is the *operation census* —
synaptic operations (SynOps), neuron updates and spike events — multiplied by
per-op energy coefficients.  Defaults follow the published Xylo-A2
characterization (Bos & Muir 2022, "Sub-mW Neuromorphic SNN audio processing
applications with Rockpool and Xylo": idle floor ~220 µW at 6.25 MHz with
dynamic energy dominated by synaptic events); coefficients are parameters, so
measured values for other silicon drop in directly.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np


@dataclasses.dataclass(frozen=True)
class EnergyModel:
    """Per-event energy coefficients (Joules) + static power (Watts)."""

    e_synop: float = 8.0e-12  # per synaptic event (weight add into isyn)
    e_neuron_update: float = 2.0e-12  # per neuron per timestep (decay+compare)
    e_spike: float = 5.0e-12  # per emitted spike (reset + routing)
    p_static: float = 220e-6  # idle power floor of the core


def count_operations(config, spikes_in, hidden_spikes) -> Dict[str, float]:
    """Operation census of one inference.

    SynOps follow the event-driven convention: each input spike activates the
    nonzero fan-out of its channel; each hidden spike activates the nonzero
    recurrent fan-out of its neuron.
    """
    spikes_in = np.asarray(spikes_in)
    hidden = np.asarray(hidden_spikes)
    T = spikes_in.shape[0]

    fan_out_in = np.count_nonzero(np.asarray(config.w_in), axis=1)  # per input ch
    fan_out_rec = np.count_nonzero(np.asarray(config.w_rec), axis=1)
    fan_out_out = np.count_nonzero(np.asarray(config.w_out), axis=1)

    synops_in = float(np.sum(np.abs(spikes_in).sum(axis=0) * fan_out_in))
    synops_rec = float(np.sum(np.abs(hidden).sum(axis=0) * fan_out_rec))
    synops_out = float(np.sum(np.abs(hidden).sum(axis=0) * fan_out_out))
    neuron_updates = float(T * (config.n_hidden + config.n_out))
    spike_events = float(np.abs(hidden).sum())

    return {
        "timesteps": float(T),
        "synops_in": synops_in,
        "synops_rec": synops_rec,
        "synops_out": synops_out,
        "synops_total": synops_in + synops_rec + synops_out,
        "neuron_updates": neuron_updates,
        "spike_events": spike_events,
    }


def estimate_power(
    config, spikes_in, hidden_spikes, audio_duration: float, model: EnergyModel = EnergyModel()
) -> Dict[str, float]:
    """Energy/power estimate for one inference over ``audio_duration`` seconds.

    Returns the dynamic energy breakdown (J), total average power (W) at
    real-time operation, and the op census — the printed contract mirrors the
    reference's per-rail µW report (micloc/xylo_snn_localization.py:671-682).
    """
    ops = count_operations(config, spikes_in, hidden_spikes)
    e_syn = ops["synops_total"] * model.e_synop
    e_neu = ops["neuron_updates"] * model.e_neuron_update
    e_spk = ops["spike_events"] * model.e_spike
    e_dyn = e_syn + e_neu + e_spk
    p_avg = e_dyn / audio_duration + model.p_static
    return {
        **ops,
        "energy_synaptic_J": e_syn,
        "energy_neuron_J": e_neu,
        "energy_spike_J": e_spk,
        "energy_dynamic_J": e_dyn,
        "power_avg_W": p_avg,
        "power_avg_uW": p_avg * 1e6,
    }
