"""Parity tests for the Pallas integer-LIF kernel (ops/pallas/lif_kernel.py).

The kernel produces every benchmark number, so its integer dynamics must be
IDENTICAL to the lax.scan simulator (models/xylo/sim._sim_hidden) that the
golden tests validate.  On CPU the public wrappers run the scan, so these
tests drive the kernel itself through ``interpret=True`` — same kernel code,
interpreted — across random configs including saturation, nonzero
recurrence, ragged T (not a multiple of the unrolled step group), padded
neuron blocks, multi-word spike packing and carried state.  The compiled
path is covered on the GPU by ``tests_gpu/test_device_parity.py``.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp

from haghighatshoarmuir2024.models.xylo.quantize import XyloConfig
from haghighatshoarmuir2024.models.xylo.sim import sim_hidden_batch, _sim_hidden
from haghighatshoarmuir2024.ops.pallas.lif_kernel import (
    _pack_spikes,
    lif_count_rates,
    lif_count_rates_bipolar,
    lif_count_stateful,
    lif_count_stateful_bipolar,
)


def make_config(seed, C=12, N=20, rec_coef=0, w_scale=20):
    rng = np.random.default_rng(seed)
    w_in = rng.integers(-w_scale, w_scale + 1, size=(C, N)).astype(np.int32)
    w_rec = np.full((N, N), rec_coef, np.int32)
    return XyloConfig(
        w_in=w_in,
        w_rec=w_rec,
        w_out=np.ones((N, 1), np.int32),
        dash_syn=rng.integers(1, 7, size=N).astype(np.int32),
        dash_mem=rng.integers(1, 7, size=N).astype(np.int32),
        dash_syn_out=np.ones(1, np.int32),
        dash_mem_out=np.ones(1, np.int32),
        threshold=rng.integers(30, 200, size=N).astype(np.int32),
        threshold_out=np.ones(1, np.int32),
        dt=1e-3,
        weight_scale=1.0,
    )


def make_spikes(seed, B=3, T=50, C=12, p=0.15, max_count=2):
    rng = np.random.default_rng(seed + 1000)
    return (rng.random((B, T, C)) < p).astype(np.int32) * rng.integers(
        1, max_count + 1, size=(B, T, C)
    ).astype(np.int32)


def pallas_counts(config, spikes_btc, spike_bound=None):
    """Drive the kernel in interpret mode (what the GPU compiles)."""
    return np.asarray(
        lif_count_rates(config, spikes_btc, spike_bound=spike_bound, interpret=True)
    )


def scan_counts(config, spikes_btc):
    return np.asarray(sim_hidden_batch(config, jnp.asarray(spikes_btc)).sum(axis=1))


@pytest.mark.parametrize("seed,rec_coef", [(0, 0), (1, -3), (2, -1), (3, 0)])
def test_lif_count_interpret_matches_scan(seed, rec_coef):
    config = make_config(seed, rec_coef=rec_coef)
    spikes = make_spikes(seed)
    np.testing.assert_array_equal(pallas_counts(config, spikes), scan_counts(config, spikes))


@pytest.mark.parametrize(
    "C,N,rec_coef",
    [(40, 200, 0), (40, 200, -1), (70, 33, 0)],
    ids=["two-neuron-blocks", "one-row-block", "multi-word"],
)
def test_lif_kernel_block_and_packing_shapes_match_scan(C, N, rec_coef):
    """Neuron padding to the block (N=200 → two 128-wide blocks with
    rec_coef == 0, one 256-wide row block with the recurrence), and spike
    words spanning several int32 words (70 binary channels → 3 words)."""
    config = make_config(C + N, C=C, N=N, rec_coef=rec_coef, w_scale=15)
    spikes = make_spikes(C + N, T=21, C=C, max_count=1)
    np.testing.assert_array_equal(
        pallas_counts(config, spikes, spike_bound=1), scan_counts(config, spikes)
    )


def test_lif_count_interpret_ragged_T():
    # T = 53: six unrolled groups of 8 plus a 5-step tail
    config = make_config(7, rec_coef=-2)
    spikes = make_spikes(7, T=53)
    np.testing.assert_array_equal(pallas_counts(config, spikes), scan_counts(config, spikes))


def test_lif_count_interpret_saturation():
    # huge weights + dense spikes drive isyn/vmem into the 16-bit clip
    config = make_config(11, w_scale=5000)
    config.threshold[:] = 25_000
    spikes = make_spikes(11, p=0.9, max_count=3)
    got = pallas_counts(config, spikes)
    np.testing.assert_array_equal(got, scan_counts(config, spikes))
    assert got.sum() > 0  # the saturating regime actually fired


def test_lif_count_interpret_time_chunk_invariance():
    """Counts do not depend on where T falls against the unrolled step
    group: every prefix length around a group boundary matches the scan."""
    config = make_config(5, rec_coef=-2)
    spikes = make_spikes(5, T=64)
    for T in (7, 8, 9, 63, 64):
        np.testing.assert_array_equal(
            pallas_counts(config, spikes[:, :T]), scan_counts(config, spikes[:, :T])
        )


def test_lif_count_binary_and_int8_packings_agree():
    """Binary spikes through the bit-packed words (spike_bound=1) and the
    byte-packed words give identical counts, equal to the scan."""
    for seed in (13, 14):
        config = make_config(seed, rec_coef=-1, w_scale=127)
        spikes = make_spikes(seed, T=70, max_count=1)
        a = pallas_counts(config, spikes, spike_bound=1)
        b = pallas_counts(config, spikes)
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, scan_counts(config, spikes))


def test_pack_spikes_layout():
    """Packed words are (B, words, T); bit j / byte j of word k is channel
    (k·per_word + j), int8 values sign-extend."""
    rng = np.random.default_rng(3)
    s = rng.integers(-128, 128, size=(5, 2, 6)).astype(np.int32)
    words = np.asarray(_pack_spikes(jnp.asarray(s), 8)).view(np.uint32)
    assert words.shape == (2, 2, 5)
    for c in range(6):
        byte = (words[:, c // 4, :] >> (8 * (c % 4))) & 0xFF
        np.testing.assert_array_equal(byte.astype(np.uint8).view(np.int8), s[:, :, c].T)
    bits = (s > 0).astype(np.int32)
    words = np.asarray(_pack_spikes(jnp.asarray(bits), 1)).view(np.uint32)
    assert words.shape == (2, 1, 5)
    for c in range(6):
        np.testing.assert_array_equal((words[:, 0, :] >> c) & 1, bits[:, :, c].T)


def test_lif_count_no_sat_clip_elision_exact():
    """When the static bound analysis proves the clips dead, the clip-free
    kernel returns identical integers to the clipped one."""
    from haghighatshoarmuir2024.ops.pallas.lif_kernel import (
        _lif_impl,
        _no_saturation_possible,
    )

    config = make_config(17, rec_coef=0, w_scale=40)  # small weights, binary spikes
    config.dash_syn[:] = 2  # flagship-like decays keep the static bounds tight
    config.dash_mem[:] = 2
    spikes = (make_spikes(17, T=70, max_count=1) > 0).astype(np.int32)
    assert _no_saturation_possible(config, spike_bound=1, rec_coef=0)

    B, N = spikes.shape[0], config.n_hidden
    zeros = jnp.zeros((B, N), jnp.int32)
    args = (
        jnp.transpose(jnp.asarray(spikes, jnp.int32), (1, 0, 2)),
        jnp.asarray(config.w_in, jnp.int32),
        jnp.asarray(config.dash_syn, jnp.int32),
        jnp.asarray(config.dash_mem, jnp.int32),
        jnp.asarray(config.threshold, jnp.int32),
        zeros, zeros, zeros,
    )
    a = _lif_impl(*args, field=1, rec_coef=0, no_sat=True, interpret=True)[0]
    b = _lif_impl(*args, field=1, rec_coef=0, no_sat=False, interpret=True)[0]
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(np.asarray(a), scan_counts(config, spikes))

    # a saturating config must NOT pass the bound analysis
    hot = make_config(18, w_scale=5000)
    assert not _no_saturation_possible(hot, spike_bound=3, rec_coef=0)


def test_lif_count_bipolar_kernel_matches_combined_raster():
    """The bipolar wrapper (kp/kn in, pos = kp & ~kn) equals running the
    scan on the concatenated (T, B, 2C) raster — including collisions where
    both polarities fire."""
    rng = np.random.default_rng(23)
    C, N, B, T = 6, 20, 3, 70
    config = make_config(23, C=2 * C, N=N, rec_coef=-1, w_scale=30)
    kp = (rng.random((T, B, C)) < 0.2).astype(np.int8)
    kn = (rng.random((T, B, C)) < 0.2).astype(np.int8)  # overlaps collide
    pos = (kp & (1 - kn)).astype(np.int32)
    enc_btc = np.concatenate([pos, kn.astype(np.int32)], axis=-1).transpose(1, 0, 2)

    for interpret in (True, False):  # kernel and the CPU scan dispatch
        got = lif_count_rates_bipolar(
            config, jnp.asarray(kp), jnp.asarray(kn), interpret=interpret
        )
        np.testing.assert_array_equal(np.asarray(got), scan_counts(config, enc_btc))


def stateful_call(config, spikes_btc, state, interpret=True):
    out = lif_count_stateful(
        config, jnp.asarray(spikes_btc, jnp.int32), *state, interpret=interpret
    )
    return np.asarray(out[0]), tuple(np.asarray(s) for s in out[1:])


def test_lif_stateful_interpret_chunked_equals_full():
    """Three carried-state kernel calls == one full-length scan: counts sum
    and the final (isyn, vmem, spk) state are integer-identical."""
    config = make_config(21, rec_coef=-2)
    B, N = 3, config.n_hidden
    spikes = make_spikes(21, T=96)

    state = tuple(np.zeros((B, N), np.int32) for _ in range(3))
    total = np.zeros((B, N), np.int64)
    for part in np.split(spikes, [30, 60], axis=1):  # ragged: 30 + 30 + 36
        counts, state = stateful_call(config, part, state)
        total += counts

    # full-length scan reference with the same carried-state semantics
    w_in = jnp.asarray(config.w_in, jnp.float32)
    inp = jnp.einsum(
        "btc,cn->btn", jnp.asarray(spikes, jnp.float32), w_in,
        precision=jax.lax.Precision.HIGHEST,
    ).astype(jnp.int32)

    def one(inp_b):
        s0 = tuple(jnp.zeros(N, jnp.int32) for _ in range(3))
        spk, carry, _ = _sim_hidden(
            inp_b,
            jnp.asarray(config.w_rec, jnp.int32),
            jnp.asarray(-2, jnp.int32),
            jnp.asarray(config.dash_syn, jnp.int32),
            jnp.asarray(config.dash_mem, jnp.int32),
            jnp.asarray(config.threshold, jnp.int32),
            s0,
            uniform_rec=True,
            record=False,
        )
        return spk.sum(axis=0), carry[0], carry[1], carry[2]

    counts_ref, isyn_ref, vmem_ref, spk_ref = jax.vmap(one)(inp)
    np.testing.assert_array_equal(total, np.asarray(counts_ref))
    np.testing.assert_array_equal(state[0], np.asarray(isyn_ref))
    np.testing.assert_array_equal(state[1], np.asarray(vmem_ref))
    np.testing.assert_array_equal(state[2], np.asarray(spk_ref))


def test_lif_stateful_bipolar_chunked_equals_combined():
    """Carried-state bipolar kernel calls == the scan on the combined
    (pos, neg) raster, chunk by chunk."""
    rng = np.random.default_rng(29)
    C, N, B = 5, 16, 2
    config = make_config(29, C=2 * C, N=N, rec_coef=-2, w_scale=25)

    state_a = tuple(np.zeros((B, N), np.int32) for _ in range(3))
    state_b = tuple(np.zeros((B, N), np.int32) for _ in range(3))
    tot_a = np.zeros((B, N), np.int64)
    tot_b = np.zeros((B, N), np.int64)
    for part in range(3):
        T = (30, 17, 24)[part]  # ragged chunks
        kp = (rng.random((T, B, C)) < 0.25).astype(np.int8)
        kn = (rng.random((T, B, C)) < 0.25).astype(np.int8)
        out = lif_count_stateful_bipolar(
            config, jnp.asarray(kp), jnp.asarray(kn),
            *(jnp.asarray(s) for s in state_a), interpret=True,
        )
        tot_a += np.asarray(out[0])
        state_a = tuple(np.asarray(s) for s in out[1:])

        pos = (kp & (1 - kn)).astype(np.int32)
        enc = np.concatenate([pos, kn.astype(np.int32)], axis=-1)  # (T, B, 2C)
        counts_b, st = stateful_call(
            config, enc.transpose(1, 0, 2), state_b, interpret=False
        )
        tot_b += counts_b
        state_b = st
    np.testing.assert_array_equal(tot_a, tot_b)
    for a, b in zip(state_a, state_b):
        np.testing.assert_array_equal(a, b)


def test_lif_count_rates_rejects_dense_w_rec():
    config = make_config(31)
    config.w_rec = np.arange(config.n_hidden**2, dtype=np.int32).reshape(
        config.n_hidden, config.n_hidden
    )
    with pytest.raises(ValueError, match="uniform w_rec"):
        lif_count_rates(config, make_spikes(31))


def test_lif_kernel_traces_under_shard_map():
    """The stream-sharded serving step runs the kernel under shard_map:
    its outputs must carry the mesh axes the inputs vary over, and the
    loop carry must type-check.  Abstract evaluation of the compiled
    (non-interpret) path checks both without a GPU."""
    from jax.sharding import PartitionSpec as P

    from haghighatshoarmuir2024.ops.pallas.lif_kernel import _lif_impl
    from haghighatshoarmuir2024.parallel import make_mesh

    mesh = make_mesh(4, (4, 1))
    config = make_config(37, rec_coef=-1)
    B, T, N = 8, 20, config.n_hidden
    consts = tuple(
        jnp.asarray(x, jnp.int32)
        for x in (config.w_in, config.dash_syn, config.dash_mem, config.threshold)
    )

    def body(s, i, v, k):
        return _lif_impl(s, *consts, i, v, k, field=1, rec_coef=-1, no_sat=False)

    step = jax.shard_map(
        body, mesh=mesh, in_specs=(P(None, "data"),) + (P("data"),) * 3,
        out_specs=P("data"),
    )
    state = jax.ShapeDtypeStruct((B, N), jnp.int32)
    out = jax.eval_shape(
        step, jax.ShapeDtypeStruct((T, B, config.n_in), jnp.int32), state, state, state
    )
    assert [o.shape for o in out] == [(B, N)] * 4
