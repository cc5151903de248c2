"""Pallas (Triton) kernel: batched integer-LIF spike counting on the GPU.

The quantized localization pipeline needs only the per-neuron hidden spike
*counts* (micloc/xylo_snn_localization.py:379-398), not the (B, T, N) hidden
raster.  The plain formulation (``models/xylo/sim.py``) is a ``lax.scan`` over
every audio sample that also writes the (B, T, N) int32 input projection to
device memory.  This kernel keeps the whole time loop on chip:

* one program per (batch row, neuron block); the time loop runs inside the
  program and ``(isyn, vmem, spk, count)`` stay in registers for all T steps;
* the input spikes arrive bit-packed, one int32 word per 32 binary channels
  (or per 4 int8 channels), laid out (B, words, T) so a row's words are
  contiguous in time; the projection ``Σ_c spike_c · w_c`` is an unrolled
  multiply-add over the channels with the weight rows held in registers, so
  the projection is never written to device memory;
* the uniform recurrence ``w_rec = c·ones`` (the DC-cancelling term of the
  reference, micloc/xylo_snn_localization.py:230-232) adds ``c·Σ_n spk``
  each step, so when ``c != 0`` one program owns every neuron of its row;
  with ``c == 0`` the neuron axis splits across programs;
* only the counts and the final state leave the chip.

Integer semantics are identical to ``sim._sim_hidden`` (decay first, then
integrate; 16-bit saturation; subtract reset), which the CPU tests pin.  The
four public wrappers all call the one kernel; the stateless ones pass zero
state.  On the CPU backend they run the ``lax.scan`` reference instead
(``interpret=True`` drives the kernel itself there, for the tests).
"""
from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from ...config import on_accelerator

_STATE_MIN = -(2**15)
_STATE_MAX = 2**15 - 1
# threshold of the padding neurons: above any reachable vmem, so they never
# fire and never feed the recurrence sum
_PAD_THRESHOLD = 2**30
# time steps per loop iteration: the word loads of a group are independent of
# the state recurrence, so they issue together and their latency overlaps
_UNROLL = 8
# neuron block when the neuron axis may split (rec_coef == 0)
_NEURON_BLOCK = 128


def _next_pow2(x: int) -> int:
    return 1 << max(int(x) - 1, 0).bit_length()


def _no_saturation_possible(config, spike_bound: int, rec_coef: int) -> bool:
    """Static proof that the 16-bit state clips can never bind.

    With per-step input current bounded by ``cur_max`` the decayed integrator
    satisfies the inductive invariant ``|isyn| <= (cur_max + 1) << ds`` (the
    +1 absorbs the floor-rounding of the arithmetic shift), and likewise
    ``|vmem| <= (B_isyn + 1) << dm`` (threshold subtraction only moves vmem
    toward 0).  When both bounds fit in int16 the clips are dead ops and the
    kernel may skip them with provably identical integer results.
    """
    w = np.abs(np.asarray(config.w_in)).sum(axis=0)
    if w.size == 0:
        return False
    n_hid = np.asarray(config.w_in).shape[1]
    cur_max = int(spike_bound) * int(w.max()) + abs(int(rec_coef)) * n_hid
    ds = int(np.max(config.dash_syn))
    dm = int(np.max(config.dash_mem))
    b_isyn = (cur_max + 1) << ds
    b_vmem = (b_isyn + 1) << dm
    return b_isyn <= _STATE_MAX and b_vmem <= _STATE_MAX


def _uniform_rec_coef(config, name: str) -> int:
    wr = np.asarray(config.w_rec)
    if wr.size and not np.all(wr == wr.flat[0]):
        raise ValueError(f"{name} requires uniform w_rec; use sim_hidden_batch")
    return int(wr.flat[0]) if wr.size else 0


def _pack_spikes(spikes_tbc, field: int):
    """(T, B, C) spikes → (B, n_words, T) int32 words.

    ``field=1``: binary spikes, 32 channels per word (bit j = channel j).
    ``field=8``: int8 spike values, 4 channels per word (two's-complement
    byte j = channel j).
    """
    T, B, C = spikes_tbc.shape
    per_word = 32 // field
    n_words = -(-C // per_word)
    if field == 1:
        v = (spikes_tbc != 0).astype(jnp.uint32)
    else:
        v = spikes_tbc.astype(jnp.int32).astype(jnp.uint32) & jnp.uint32(0xFF)
    v = jnp.pad(v, ((0, 0), (0, 0), (0, n_words * per_word - C)))
    v = v.reshape(T, B, n_words, per_word)
    shifts = jnp.arange(per_word, dtype=jnp.uint32) * jnp.uint32(field)
    words = jnp.sum(v << shifts, axis=-1, dtype=jnp.uint32)  # distinct bits
    return jnp.transpose(jax.lax.bitcast_convert_type(words, jnp.int32), (1, 2, 0))


def _lif_kernel(
    words_ref,  # (B, n_words, T) int32 packed spikes
    w_ref,  # (n_ch, N_pad) int32
    ds_ref, dm_ref, thr_ref,  # (N_pad,) int32
    isyn0_ref, vmem0_ref, spk0_ref,  # (B, N_pad) int32 initial state
    counts_ref, isyn_ref, vmem_ref, spk_ref,  # (B, N_pad) int32 outputs
    *, T: int, n_ch: int, field: int, NB: int, rec_coef: int, no_sat: bool,
):
    b = pl.program_id(0)
    cols = pl.ds(pl.program_id(1) * NB, NB)
    per_word = 32 // field
    n_words = -(-n_ch // per_word)
    w = [w_ref[c, cols] for c in range(n_ch)]
    dash_syn = ds_ref[cols]
    dash_mem = dm_ref[cols]
    threshold = thr_ref[cols]

    i32 = jnp.int32

    def channel(word, j):
        if field == 1:
            return jax.lax.shift_right_logical(word, i32(j)) & i32(1)
        # sign-extend byte j
        return jax.lax.shift_right_arithmetic(
            jax.lax.shift_left(word, i32(24 - 8 * j)), i32(24)
        )

    def step(carry, words):
        isyn, vmem, spk, cnt = carry
        cur = jnp.zeros((NB,), jnp.int32)
        for k, word in enumerate(words):
            for j in range(min(per_word, n_ch - k * per_word)):
                cur = cur + channel(word, j) * w[k * per_word + j]
        if rec_coef != 0:
            cur = cur + i32(rec_coef) * jnp.sum(spk, dtype=jnp.int32)
        isyn = isyn - jax.lax.shift_right_arithmetic(isyn, dash_syn) + cur
        if not no_sat:
            isyn = jnp.clip(isyn, _STATE_MIN, _STATE_MAX)
        vmem = vmem - jax.lax.shift_right_arithmetic(vmem, dash_mem) + isyn
        if not no_sat:
            vmem = jnp.clip(vmem, _STATE_MIN, _STATE_MAX)
        fired = vmem >= threshold
        vmem = jnp.where(fired, vmem - threshold, vmem)
        spk = fired.astype(jnp.int32)
        return isyn, vmem, spk, cnt + spk

    def group(t0, carry, n):
        # issue the group's word loads before its first state update
        words = [[words_ref[b, k, t0 + s] for k in range(n_words)] for s in range(n)]
        for s in range(n):
            carry = step(carry, words[s])
        return carry

    # "+ zero" gives the loaded state the same (mesh-invariant) type as the
    # values the step computes, which a loop carry needs under shard_map
    zero = jnp.zeros((NB,), jnp.int32)
    carry = (
        isyn0_ref[b, cols] + zero,
        vmem0_ref[b, cols] + zero,
        spk0_ref[b, cols] + zero,
        zero,
    )
    n_groups, tail = divmod(T, _UNROLL)
    carry = jax.lax.fori_loop(
        0, n_groups, lambda i, c: group(i * _UNROLL, c, _UNROLL), carry
    )
    if tail:
        carry = group(n_groups * _UNROLL, carry, tail)
    isyn, vmem, spk, cnt = carry
    counts_ref[b, cols] = cnt
    isyn_ref[b, cols] = isyn
    vmem_ref[b, cols] = vmem
    spk_ref[b, cols] = spk


@functools.partial(
    jax.jit, static_argnames=("field", "rec_coef", "no_sat", "interpret")
)
def _lif_impl(spikes_tbc, w_in, dash_syn, dash_mem, threshold, isyn0, vmem0, spk0,
              *, field: int, rec_coef: int, no_sat: bool, interpret: bool = False):
    T, B, C = spikes_tbc.shape
    N = w_in.shape[1]
    if rec_coef != 0:
        NB = max(32, _next_pow2(N))  # the recurrence sums the whole row
    else:
        NB = min(_NEURON_BLOCK, max(32, _next_pow2(N)))
    N_pad = -(-N // NB) * NB
    pad_n = lambda x, v=0: jnp.pad(  # noqa: E731
        x.astype(jnp.int32), [(0, 0)] * (x.ndim - 1) + [(0, N_pad - N)],
        constant_values=v,
    )
    words = _pack_spikes(spikes_tbc, field)
    kernel = functools.partial(
        _lif_kernel, T=T, n_ch=C, field=field, NB=NB, rec_coef=int(rec_coef),
        no_sat=no_sat,
    )
    # under shard_map the outputs vary over the mesh axes the spikes and the
    # carried state vary over
    vma = frozenset().union(*(jax.typeof(x).vma for x in (spikes_tbc, isyn0, vmem0, spk0)))
    state = jax.ShapeDtypeStruct((B, N_pad), jnp.int32, vma=vma)
    counts, isyn, vmem, spk = pl.pallas_call(
        kernel,
        grid=(B, N_pad // NB),
        out_shape=(state,) * 4,
        compiler_params=pl_triton.CompilerParams(
            num_warps=min(max(NB // 32, 1), 8), num_stages=1
        ),
        interpret=interpret,
        backend="triton",
        name="lif_count",
    )(
        words, pad_n(w_in), pad_n(dash_syn), pad_n(dash_mem),
        pad_n(threshold, _PAD_THRESHOLD), pad_n(isyn0), pad_n(vmem0), pad_n(spk0),
    )
    return counts[:, :N], isyn[:, :N], vmem[:, :N], spk[:, :N]


def _scan_counts(config, spikes_tbc, isyn0, vmem0, spk0, rec_coef: int):
    """The plain formulation: the ``lax.scan`` simulator vmapped over the
    batch, with the (T, N) projection as one dot per row."""
    from ...models.xylo.sim import _sim_hidden

    w_in = jnp.asarray(config.w_in, jnp.float32)
    w_rec = jnp.asarray(config.w_rec, jnp.int32)
    rc = jnp.asarray(rec_coef, jnp.int32)
    ds = jnp.asarray(config.dash_syn, jnp.int32)
    dm = jnp.asarray(config.dash_mem, jnp.int32)
    th = jnp.asarray(config.threshold, jnp.int32)

    def one(spk_tc, i0, v0, s0):
        # spikes and |w| <= 127 are integers far below 2^24: float32 sums are
        # exact, and HIGHEST keeps the operands out of TF32
        inp = jnp.dot(
            spk_tc.astype(jnp.float32), w_in,
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        ).astype(jnp.int32)
        spikes_out, carry, _ = _sim_hidden(
            inp, w_rec, rc, ds, dm, th, (i0, v0, s0),
            uniform_rec=True, record=False,
        )
        return spikes_out.sum(axis=0), carry[0], carry[1], carry[2]

    return jax.vmap(one, in_axes=(1, 0, 0, 0))(
        spikes_tbc.astype(jnp.int32), isyn0, vmem0, spk0
    )


def lif_count_stateful(config, spikes_in_batch, isyn0, vmem0, spk0,
                       spike_bound: int | None = None, time_major: bool = False,
                       interpret: bool = False):
    """Stateful batched LIF: (B, T, C) spikes (or (T, B, C) with
    ``time_major=True``) + (B, N) initial state → (counts (B, N), final isyn,
    vmem, spk) — the state carries across chunk calls.

    Spike values must fit int8.  ``spike_bound``: optional caller-guaranteed
    bound on the per-step spike values (1 for RZCC masks).  With 1 the kernel
    reads binary bit-packed spikes; with any bound a static analysis may prove
    the 16-bit clips dead and elide them (identical integers).  The caller
    also guarantees the initial state came from the same bounded dynamics
    (zeros plus earlier chunks of the same stream).

    The Pallas kernel on an accelerator (or with ``interpret=True``); the
    ``lax.scan`` simulator on the CPU backend — identical integers.
    """
    rec_coef = _uniform_rec_coef(config, "lif_count_stateful")
    spikes = jnp.asarray(spikes_in_batch)
    spikes_tbc = spikes if time_major else jnp.transpose(spikes, (1, 0, 2))
    state = tuple(jnp.asarray(s, jnp.int32) for s in (isyn0, vmem0, spk0))
    if not interpret and not on_accelerator():
        return _scan_counts(config, spikes_tbc, *state, rec_coef)
    no_sat = spike_bound is not None and _no_saturation_possible(
        config, spike_bound, rec_coef
    )
    return _lif_impl(
        spikes_tbc,
        jnp.asarray(config.w_in, jnp.int32),
        jnp.asarray(config.dash_syn, jnp.int32),
        jnp.asarray(config.dash_mem, jnp.int32),
        jnp.asarray(config.threshold, jnp.int32),
        *state,
        field=1 if spike_bound == 1 else 8,
        rec_coef=rec_coef,
        no_sat=no_sat,
        interpret=interpret,
    )


def lif_count_rates(config, spikes_in_batch, time_major: bool = False,
                    spike_bound: int | None = None, interpret: bool = False):
    """Hidden-layer spike counts (B, N_hid) of the quantized LIF network from
    zero state: exactly ``sim_hidden_batch(config, spikes).sum(axis=1)``
    without materializing the raster.  Requires a uniform (or zero)
    recurrence matrix.  Arguments as in :func:`lif_count_stateful`."""
    spikes = jnp.asarray(spikes_in_batch)
    B = spikes.shape[1] if time_major else spikes.shape[0]
    zeros = jnp.zeros((B, config.n_hidden), jnp.int32)
    return lif_count_stateful(
        config, spikes, zeros, zeros, zeros, spike_bound=spike_bound,
        time_major=time_major, interpret=interpret,
    )[0]


def _combine_bipolar(kp_tbc, kn_tbc):
    """The reference's −1-wins-on-collision overwrite
    (micloc/xylo_snn_localization.py:344-355): ``[kp & ~kn, kn]``."""
    kp = jnp.asarray(kp_tbc) != 0
    kn = jnp.asarray(kn_tbc) != 0
    return jnp.concatenate([kp & ~kn, kn], axis=-1).astype(jnp.int8)


def lif_count_rates_bipolar(config, kp_tbc, kn_tbc, spike_bound: int | None = 1,
                            interpret: bool = False):
    """Hidden-layer spike counts straight from the two time-major (T, B, C)
    RZCC polarity masks; ``config.w_in`` has 2C rows ([:C] positive, [C:]
    negative).  Equals ``lif_count_rates(config, [kp & ~kn, kn],
    time_major=True)``."""
    return lif_count_rates(
        config, _combine_bipolar(kp_tbc, kn_tbc), time_major=True,
        spike_bound=spike_bound, interpret=interpret,
    )


def lif_count_stateful_bipolar(config, kp_tbc, kn_tbc, isyn0, vmem0, spk0,
                               spike_bound: int | None = 1, interpret: bool = False):
    """Stateful form of :func:`lif_count_rates_bipolar`: the serving
    runtime's per-chunk LIF (state carries across chunks)."""
    return lif_count_stateful(
        config, _combine_bipolar(kp_tbc, kn_tbc), isyn0, vmem0, spk0,
        spike_bound=spike_bound, time_major=True, interpret=interpret,
    )
