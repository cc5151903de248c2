"""Streaming localization runtime — carried-state chunked processing.

The reference processes audio in independent 0.25 s recordings with full
transient re-settling per frame and Python/rockpool hops between stages
(micloc/xylo_snn_localization.py:446-542).  Here the full
encode→SNN→rate chain runs as ONE jitted step per chunk with all filter /
encoder / neuron state carried on device, so multi-second (or infinite) audio
streams through without host round-trips and without re-paying transients:

* STHT: the quadrature FIR carries its K−1 tap history; the in-phase branch is
  a true K/2-sample delay line (the reference's ``np.roll`` wrap-around is a
  whole-signal operation — its first K/2 wrapped samples are start-of-stream
  transient only, identical thereafter).
* Bandpass+integration IIR: transposed DF2 state carried exactly
  (cumsum is folded into the denominator as in the offline pipeline).
* RZCC: peak decisions need lookahead (local-max + distance suppression), so
  the last ``pending`` samples of each chunk stay undecided until the next
  chunk arrives; a ``guard`` window of already-decided samples precedes the
  analysis buffer so suppression works across the seam.  For the RZCC signal
  class (bandpassed oscillation, genuine peaks ≥ 2·robust_width apart)
  decisions match the offline encoder exactly; pathological suppression
  chains longer than the pending window are the only divergence.
* Integer LIF: isyn/vmem/spike state carried exactly (bit-identical to the
  offline simulator fed the same spikes).

Emitted spike counts lag the input by ``pending`` samples — the price of
streaming causality.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from ..config import on_accelerator


class StreamState(NamedTuple):
    fir_tail: jnp.ndarray  # (K-1, M) raw-signal history for the quadrature FIR
    delay_line: jnp.ndarray  # (K//2, M) in-phase delay
    iir_state: jnp.ndarray  # (C, N_state) filter state (folded form on CPU;
    #                         bandpass-only TDF2 state on the accelerator)
    int_carry: jnp.ndarray  # (C,) integrator carry (accelerator; zeros on CPU)
    pending: jnp.ndarray  # (guard + P, C) undecided integrated samples
    isyn: jnp.ndarray  # (N,) int32
    vmem: jnp.ndarray  # (N,) int32
    spk: jnp.ndarray  # (N,) int32
    counts: jnp.ndarray  # (N,) int32 accumulated hidden spikes
    steps: jnp.ndarray  # () int32 decided timesteps so far


class StreamingLocalizer:
    """Streaming twin of the quantized pipeline (models.xylo.Demo)."""

    def __init__(self, demo, pending: int = None):
        self.demo = demo
        self.kernel = np.asarray(demo.beamfs[0].kernel, dtype=np.float32)
        self.K = len(self.kernel)
        self.rw = demo.beamfs[0].robust_width
        self.guard = 2 * self.rw
        self.pending = pending if pending is not None else 4 * self.rw
        self.num_mic = len(demo.geometry)
        self.bipolar = demo.bipolar_spikes

        # integrated-bandpass coefficient set per band.  The CPU runs the
        # exact sequential form with the cumsum folded into the denominator
        # (TDF2 state of the integrated filter).  That marginally stable
        # filter does not survive float32 in lifted block form, so the
        # accelerator runs the STABLE bandpass blocked (carried TDF2 state)
        # and the integrator as a carried-offset cumsum — mirroring the
        # offline encode (models/xylo/pipeline._encode_cumsum).
        self._blocked = on_accelerator()
        # per band: (b, a) of the stable bandpass and the integrated
        # denominator a ⊛ [1, −1]
        self._filters = [
            (np.asarray(b), np.asarray(a), np.convolve(np.asarray(a), [1.0, -1.0]))
            for b, a in demo.filterbank.ba_list
        ]
        self.C = 2 * self.num_mic * len(self._filters)
        # TDF2 state width of the filter each backend runs
        a0 = self._filters[0][1 if self._blocked else 2]
        self.N_state = len(a0) - 1

        cfg = demo.xylo_config
        self._cfg = cfg
        wr = np.asarray(cfg.w_rec)
        self._rec_coef = int(wr.flat[0]) if wr.size and np.all(wr == wr.flat[0]) else None
        if self._rec_coef is None:
            raise ValueError("streaming runtime supports uniform w_rec only")

    def init_state(self, batch: int = None) -> StreamState:
        """Fresh stream state; pass ``batch`` for N concurrent streams (the
        serving configuration — one vmapped step advances all of them)."""
        cfg = self._cfg
        n = cfg.n_hidden
        lead = () if batch is None else (batch,)
        z = lambda *s: jnp.zeros(lead + s, jnp.float32)
        zi = lambda *s: jnp.zeros(lead + s, jnp.int32)
        return StreamState(
            fir_tail=z(self.K - 1, self.num_mic),
            delay_line=z(self.K // 2, self.num_mic),
            iir_state=z(self.C // len(self._filters) * len(self._filters), self.N_state),
            int_carry=z(self.C),
            pending=z(self.guard + self.pending, self.C),
            isyn=zi(n),
            vmem=zi(n),
            spk=zi(n),
            counts=zi(n),
            steps=zi(),
        )

    @functools.cached_property
    def _make_steps(self):
        from ..ops.fir import fir_filter
        from ..ops.pallas.lif_kernel import (
            lif_count_stateful,
            lif_count_stateful_bipolar,
        )
        from ..ops.peaks import (
            local_extrema_mask_bounded,
            rzcc_encode_bipolar_tm,
            select_by_distance_tm,
        )

        # numpy closures: the lowered programs (and their compile-cache
        # keys) carry no device-resident literals
        kernel = np.asarray(self.kernel)
        K, rw, guard = self.K, self.rw, self.guard
        filters = self._filters
        num_mic = self.num_mic
        bipolar = self.bipolar
        cfg = self._cfg
        blocked = self._blocked

        def encode(state: StreamState, chunk):
            """Encode-only step: (state, (Tc, M) chunk) → (partial new state
            with LIF fields untouched, (guard + P + Tc, C) analysis window)."""
            from ..ops.iir import iir_filter

            Tc = chunk.shape[0]
            # --- STHT streaming
            ext = jnp.concatenate([state.fir_tail, chunk], axis=0)
            quad = fir_filter(kernel, ext, axis=0, method="fft")[K - 1 :]
            line = jnp.concatenate([state.delay_line, chunk], axis=0)
            inphase = line[:Tc]
            new_delay = line[Tc:]
            new_tail = ext[-(K - 1) :]
            sig_real = jnp.concatenate([inphase, quad], axis=1)  # (Tc, 2M)

            # --- integrated bandpass per band with carried state
            outs = []
            states = []
            carries = []
            ch_per_band = 2 * num_mic
            for i, (b, a, a_int) in enumerate(filters):
                zi = state.iir_state[i * ch_per_band : (i + 1) * ch_per_band]
                if blocked:
                    carry = state.int_carry[i * ch_per_band : (i + 1) * ch_per_band]
                    # the carried state pins the lifted block size to a
                    # divisor of Tc: 32 where it divides (48 kHz, 0.25 s
                    # chunks), else the nearest listed divisor (sb=48 at
                    # 24 kHz, where Tc=6000)
                    sb = next((s for s in (32, 48, 40, 24, 16, 8)
                               if Tc % s == 0), None)
                    if sb is not None:
                        zi_f = jnp.concatenate([zi, carry[:, None]], axis=1)
                        y, zf_f = iir_filter(
                            b, a, sig_real, axis=0, method="blocked_cumsum",
                            zi=zi_f, return_state=True, sb=sb,
                        )
                        zf = zf_f[:, :-1]
                        carries.append(zf_f[:, -1])
                    else:
                        # chunk lengths with none of those divisors run the
                        # same stable bandpass sequentially
                        y, zf = iir_filter(
                            b, a, sig_real, axis=0, method="scan",
                            zi=zi, return_state=True,
                        )
                        y = jnp.cumsum(y, axis=0) + carry[None, :]
                        carries.append(y[-1])
                else:
                    y, zf = iir_filter(
                        b, a_int, sig_real, axis=0, method="scan",
                        zi=zi, return_state=True,
                    )
                    carries.append(jnp.zeros(ch_per_band, y.dtype))
                outs.append(y)
                states.append(zf)
            integrated = jnp.concatenate(outs, axis=1)  # (Tc, C)
            new_iir = jnp.concatenate(states, axis=0)
            new_carry = jnp.concatenate(carries, axis=0)

            # --- RZCC with guard+pending seam
            analysis = jnp.concatenate([state.pending, integrated], axis=0)
            new_pending = analysis[Tc:]

            enc_state = state._replace(
                fir_tail=new_tail,
                delay_line=new_delay,
                iir_state=new_iir,
                int_carry=new_carry,
                pending=new_pending,
                steps=state.steps + Tc,
            )
            return enc_state, analysis

        def _step_batched_body(state: StreamState, chunks, want_spikes: bool):
            """Serving path: vmapped encode, RZCC decisions over the seam
            window, and the stateful LIF over the whole stream batch."""
            # analysis comes out time-major (L, B, C): the encode is naturally
            # (T, ...)-major, so out_axes=1 costs nothing and the RZCC and LIF
            # consume their native layout with zero transposes
            enc_state, analysis_b = jax.vmap(encode, out_axes=(0, 1))(state, chunks)
            Tc = chunks.shape[1]
            L, B, C = analysis_b.shape
            rows = analysis_b.reshape(L, B * C)
            decided = lambda m: m[guard : guard + Tc].reshape(Tc, B, C)  # noqa: E731
            # spike_bound=1: binary RZCC masks from stream start (state zeros),
            # so the no-saturation invariant carries across chunks
            if bipolar:
                kp, kn = rzcc_encode_bipolar_tm(rows, rw, 2 * rw)
                kp, kn = decided(kp), decided(kn)
                counts_new, isyn, vmem, spk = lif_count_stateful_bipolar(
                    cfg, kp, kn, state.isyn, state.vmem, state.spk, spike_bound=1
                )
                spikes = jnp.concatenate([kp & ~kn, kn], axis=-1)  # (Tc, B, 2C)
            else:
                maxima, _ = local_extrema_mask_bounded(rows.T, 2 * rw)
                spikes = decided(select_by_distance_tm(maxima.T, rows, rw))
                counts_new, isyn, vmem, spk = lif_count_stateful(
                    cfg, spikes, state.isyn, state.vmem, state.spk,
                    spike_bound=1, time_major=True,
                )
            new_state = enc_state._replace(
                isyn=isyn, vmem=vmem, spk=spk, counts=state.counts + counts_new
            )
            if want_spikes:
                return new_state, spikes.astype(jnp.int8)
            return new_state

        @jax.jit
        def step(state: StreamState, chunk):
            # the single stream is the batched step at B = 1
            one = jax.tree.map(lambda x: x[None], state)
            new, spikes = _step_batched_body(one, chunk[None], want_spikes=True)
            return jax.tree.map(lambda x: x[0], new), spikes[:, 0].astype(jnp.int32)

        step_batched = jax.jit(
            functools.partial(_step_batched_body, want_spikes=True)
        )
        step_batched_nospikes = jax.jit(
            functools.partial(_step_batched_body, want_spikes=False)
        )

        return step, step_batched, step_batched_nospikes

    @property
    def _step_jit(self):
        return self._make_steps[0]

    @property
    def _step_jit_batched(self):
        return self._make_steps[1]

    @property
    def _step_jit_batched_nospikes(self):
        return self._make_steps[2]

    def process_chunk(self, state: StreamState, chunk, return_spikes: bool = True):
        """One chunk in, (new_state, decided input-spike raster) out.

        ``chunk`` may be (Tc, M) for a single stream or (B, Tc, M) matched to
        a ``init_state(batch=B)`` state — the serving path advances all B
        streams in one device launch.  Single-stream spikes come back
        (Tc, C'); batched spikes come back TIME-MAJOR (Tc, B, C') — the RZCC
        and LIF layout, kept transpose-free end-to-end.

        ``return_spikes=False`` (batched only) skips materializing the spike
        raster — the serving loop needs only the carried counts.  Returns
        just the new state in that case.
        """
        chunk = jnp.asarray(chunk, jnp.float32)
        if chunk.ndim == 3:
            if not return_spikes:
                return self._step_jit_batched_nospikes(state, chunk)
            return self._step_jit_batched(state, chunk)
        return self._step_jit(state, chunk)

    def make_sharded_step(self, mesh, axis_name: str = "data"):
        """Data-parallel serving step over a multi-chip ``jax.sharding.Mesh``.

        Streams are independent, so serving shards PERFECTLY data-parallel:
        carried state and chunks split on the stream axis and there are ZERO
        cross-device collectives, so scaling is linear by construction (the
        multi-device twin of the single-device serving loop the daemon
        drives; the reference's closest analogue is one sox capture at a
        time, micloc/record.py:54-60).  Each device runs the same
        encode→RZCC→LIF program on its ``B/n_devices`` slice.

        Returns a jitted ``(state, chunks) -> new_state`` operating on
        ``P(axis_name)``-sharded leading axes.  Validated against the
        unsharded step on the virtual 8-device CPU mesh in
        tests/test_streaming.py.
        """
        from jax.sharding import PartitionSpec as P

        body = self._make_steps[2]  # batched step, no spike materialization
        fn = jax.shard_map(
            body,
            mesh=mesh,
            in_specs=(P(axis_name), P(axis_name)),
            out_specs=P(axis_name),
        )
        return jax.jit(fn)

    def rate(self, state: StreamState, fold: bool = True):
        """Current per-DoA spike-rate estimate from the accumulated counts
        (batched states give (B, G) rates; ``fold=False`` returns the
        unfolded (B, F·G) band-major rates that the stacked/auto matched
        estimators take)."""
        num_DoA = len(self.demo.doa_list)
        steps = jnp.maximum(state.steps, 1)
        r = state.counts.astype(jnp.float32) / steps[..., None] * self.demo.fs
        if not fold:
            return r
        return r.reshape(r.shape[:-1] + (-1, num_DoA)).mean(axis=-2)

    def estimate_doa(self, state: StreamState, method: str = "peak"):
        r = self.rate(state, fold=method not in ("matched_stacked", "matched_auto"))
        if r.ndim == 2:  # batched streams
            return jnp.stack(
                [self.demo.estimate_doa_from_rate(x, method) for x in r]
            )
        return self.demo.estimate_doa_from_rate(r, method)
