"""Streaming runtime: chunked carried-state execution matches the offline
pipeline (modulo the documented P-sample decision delay and the offline
np.roll start-of-stream transient)."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp

from haghighatshoarmuir2024 import CenterCircularArray
from haghighatshoarmuir2024.models.xylo import Demo
from haghighatshoarmuir2024.runtime import StreamingLocalizer
from haghighatshoarmuir2024.runtime.streaming import StreamState
from haghighatshoarmuir2024.ops.interp import signal_from_template

FS = 48_000


@pytest.fixture(scope="module")
def demo():
    geometry = CenterCircularArray(radius=4.5e-2, num_mic=7)
    return Demo(
        geometry=geometry,
        freq_bands=[[1600, 1900]],
        doa_list=np.linspace(-np.pi, np.pi, 65),
        recording_duration=0.25,
        kernel_duration=5e-3,
        bipolar_spikes=True,
        fs=FS,
        use_cache=False,
    )


def _signal(demo, duration=1.0, doa=0.7, snr_db=10.0, seed=0):
    t = np.arange(0, duration, 1 / FS)
    sig = np.sin(2 * np.pi * 1750 * t)
    clean = np.asarray(signal_from_template(demo.geometry, t, sig, doa, fs=FS))
    rng = np.random.default_rng(seed)
    sigma = np.sqrt((clean**2).mean() / 10 ** (snr_db / 10))
    return clean + sigma * rng.standard_normal(clean.shape)


def test_streaming_spikes_match_offline(demo):
    sig = _signal(demo, duration=0.5)
    T = sig.shape[0]
    sl = StreamingLocalizer(demo)
    P = sl.pending
    K = sl.K

    # stream in 5 chunks
    state = sl.init_state()
    outs = []
    Tc = T // 5
    for k in range(5):
        state, spikes = sl.process_chunk(state, sig[k * Tc : (k + 1) * Tc])
        outs.append(np.asarray(spikes))
    stream_spikes = np.concatenate(outs, axis=0)

    offline = np.asarray(demo.spike_encoding(sig))

    # decided stream position i corresponds to absolute position i - P
    a = stream_spikes[P:]
    b = offline[: a.shape[0]]
    # ignore the start-of-stream region where the offline np.roll wraps the
    # signal end into the in-phase branch: the wrapped K/2 samples differ and
    # the narrowband IIR tail of that difference takes ~10s of ms to decay
    settle = 10 * K
    mism = np.flatnonzero(np.any(a[settle:] != b[settle:], axis=1))
    assert mism.size == 0, f"{mism.size} mismatching timesteps, first at {mism[:5]}"


def test_streaming_seam_divergence_contained(demo):
    """The documented RZCC seam failure mode (runtime/streaming.py:16-22):
    suppression chains longer than the pending window are the ONLY divergence
    from the offline encoder, and it stays contained to the chain.

    Construction: an amplitude-ramped 4.8 kHz tone (above the 1600-1900 Hz
    band, attenuated but passed by the order-1 bandpass) gives integrated-
    signal peaks every ~10 samples — closer than robust_width — with
    monotonically ascending heights.  Greedy distance suppression then anchors
    at the ramp's END and propagates right-to-left through the whole ramp
    (~0.2 s >> pending window), so the streaming encoder — which must commit
    decisions causally at each chunk seam — cannot reproduce the offline
    decisions inside the chain.  The test asserts BOTH directions:

      * the pathological chain actually diverges (the failure mode is real,
        not hypothetical), and
      * every mismatch lies inside the chain region + a small margin; the
        benign in-band tone before and after the ramp decides EXACTLY as
        offline (divergence does not leak into decided benign prefixes).
    """
    sl = StreamingLocalizer(demo)
    P, K, rw = sl.pending, sl.K, sl.rw
    assert rw > 10, "construction needs 4.8 kHz peak spacing < robust_width"

    T = 24_000  # 0.5 s
    t = np.arange(T) / FS
    ramp_lo, ramp_hi = 12_000, 21_600  # 0.2 s of pathological chain
    sig1 = np.sin(2 * np.pi * 1750 * t)  # benign in-band tone
    # the pathological segment REPLACES the tone: integrated-signal maxima
    # come only from the ramped above-band tone, every ~10 samples, ascending
    sig1[ramp_lo:ramp_hi] = np.linspace(0.5, 3.0, ramp_hi - ramp_lo) * np.sin(
        2 * np.pi * 4800 * t[ramp_lo:ramp_hi]
    )
    rng = np.random.default_rng(3)
    sig = (
        np.repeat(sig1[:, None], len(demo.geometry), axis=1)
        + 1e-4 * rng.standard_normal((T, len(demo.geometry)))
    ).astype(np.float32)

    state = sl.init_state()
    outs = []
    Tc = T // 5  # seams at 4800k — two fall inside the ramp
    for k in range(5):
        state, spikes = sl.process_chunk(state, sig[k * Tc : (k + 1) * Tc])
        outs.append(np.asarray(spikes))
    stream_spikes = np.concatenate(outs, axis=0)

    offline = np.asarray(demo.spike_encoding(sig))

    a = stream_spikes[P:]
    b = offline[: a.shape[0]]
    settle = 10 * K  # offline np.roll start-of-stream transient (see above)
    mism = np.flatnonzero(np.any(a != b, axis=1))
    mism = mism[mism >= settle]

    # 1) the pathological chain genuinely diverges
    assert mism.size > 0, "pathological chain failed to trigger any divergence"
    # 2) containment: every mismatch inside the chain region (+ margin for
    #    chain run-off and the bandpass ring-down at the ramp edges)
    margin = 8 * rw
    lo, hi = ramp_lo - margin, ramp_hi + margin
    outside = mism[(mism < lo) | (mism >= hi)]
    assert outside.size == 0, (
        f"{outside.size} divergent timesteps leaked outside the chain "
        f"region [{lo}, {hi}): first at {outside[:5]}"
    )
    # 3) the benign prefix/suffix decide exactly as offline
    np.testing.assert_array_equal(a[settle:lo], b[settle:lo])
    np.testing.assert_array_equal(a[hi:], b[hi:])


def test_streaming_state_carries_lif_exactly(demo):
    """Feeding the same decided spikes through the offline simulator must give
    the same hidden counts as the streaming accumulation."""
    from haghighatshoarmuir2024.models.xylo.sim import sim_hidden_batch

    sig = _signal(demo, duration=0.4)
    sl = StreamingLocalizer(demo)
    state = sl.init_state()
    outs = []
    Tc = sig.shape[0] // 4
    for k in range(4):
        state, spikes = sl.process_chunk(state, sig[k * Tc : (k + 1) * Tc])
        outs.append(np.asarray(spikes))
    stream_spikes = np.concatenate(outs, axis=0)
    ref_counts = np.asarray(
        sim_hidden_batch(demo.xylo_config, stream_spikes[None].astype(np.int32))
    )[0].sum(axis=0)
    np.testing.assert_array_equal(np.asarray(state.counts), ref_counts)


def test_streaming_doa_estimate(demo):
    doa_true = 0.7
    sig = _signal(demo, duration=1.0, doa=doa_true, snr_db=10.0)
    sl = StreamingLocalizer(demo)
    state = sl.init_state()
    Tc = 4800  # 0.1 s chunks
    for k in range(sig.shape[0] // Tc):
        state, _ = sl.process_chunk(state, sig[k * Tc : (k + 1) * Tc])
    est = float(sl.estimate_doa(state))
    err = np.rad2deg(np.arcsin(abs(np.sin(est - doa_true))))
    assert err < 25.0, (est, err)

    # offline single-shot comparison: same estimate class
    doa_off, _ = demo.forward(sig[: 4800 * (sig.shape[0] // Tc)])
    err_off = np.rad2deg(np.arcsin(abs(np.sin(float(doa_off) - doa_true))))
    assert abs(err - err_off) < 10.0


def test_batched_streams_match_single(demo):
    """N concurrent streams through the vmapped step equal N independent
    single-stream runs (the serving configuration)."""
    sl = StreamingLocalizer(demo)
    sigs = np.stack([_signal(demo, duration=0.3, doa=d, seed=i) for i, d in enumerate((-1.0, 0.7, 2.0))]).astype(np.float32)
    B, T, M = sigs.shape
    Tc = T // 3

    state_b = sl.init_state(batch=B)
    for k in range(3):
        state_b, spikes_b = sl.process_chunk(state_b, sigs[:, k * Tc : (k + 1) * Tc])
    rates_b = np.asarray(sl.rate(state_b))
    assert rates_b.shape == (B, len(demo.doa_list))

    for i in range(B):
        st = sl.init_state()
        for k in range(3):
            st, _ = sl.process_chunk(st, sigs[i, k * Tc : (k + 1) * Tc])
        np.testing.assert_array_equal(np.asarray(st.counts), np.asarray(state_b.counts[i]))

    ests = np.asarray(sl.estimate_doa(state_b))
    assert ests.shape == (B,)


def test_streaming_unipolar_and_multiband():
    """Streaming handles unipolar encoding and multiple frequency bands."""
    geometry = CenterCircularArray(radius=4.5e-2, num_mic=7)
    d = Demo(
        geometry=geometry,
        freq_bands=[[1600, 1900], [1900, 2200]],
        doa_list=np.linspace(-np.pi, np.pi, 33),
        recording_duration=0.1,
        kernel_duration=5e-3,
        bipolar_spikes=False,
        fs=FS,
        use_cache=False,
        design_chunk=16,
    )
    sl = StreamingLocalizer(d)
    sig = _signal(d, duration=0.3, doa=0.5)
    state = sl.init_state()
    Tc = sig.shape[0] // 3
    spikes_all = []
    for k in range(3):
        state, spikes = sl.process_chunk(state, sig[k * Tc : (k + 1) * Tc])
        spikes_all.append(np.asarray(spikes))
    spikes_all = np.concatenate(spikes_all)
    assert spikes_all.shape[1] == 2 * 14 * 2 // 2  # unipolar: 2M x F channels
    assert spikes_all.min() >= 0
    # counts consistent with the offline simulator on the same spikes
    from haghighatshoarmuir2024.models.xylo.sim import sim_hidden_batch

    ref = np.asarray(
        sim_hidden_batch(d.xylo_config, spikes_all[None].astype(np.int32))
    )[0].sum(axis=0)
    np.testing.assert_array_equal(np.asarray(state.counts), ref)


def test_sharded_serving_step_matches_unsharded(demo):
    """Multi-chip serving: the data-parallel shard_map step over the virtual
    8-device mesh carries state/counts identical to the single-device batched
    step (streams are independent — the layout has zero collectives)."""
    from jax.sharding import NamedSharding, PartitionSpec as PS

    from haghighatshoarmuir2024.parallel.mesh import make_mesh

    sl = StreamingLocalizer(demo)
    B = 8
    Tc = 6000
    mesh = make_mesh(8)
    doas = np.linspace(-np.pi, np.pi, B, endpoint=False)
    sig = np.stack([_signal(demo, 2 * Tc / FS, d, seed=i)
                    for i, d in enumerate(doas)]).astype(np.float32)

    sharded_step = sl.make_sharded_step(mesh)
    sh = NamedSharding(mesh, PS("data"))
    st_ref = sl.init_state(batch=B)
    st_sh = jax.device_put(st_ref, sh)
    for k in range(2):  # two chunks: the seam state crosses devices' steps
        chunk = sig[:, k * Tc:(k + 1) * Tc]
        st_ref = sl.process_chunk(st_ref, chunk, return_spikes=False)
        st_sh = sharded_step(st_sh, jax.device_put(jnp.asarray(chunk), sh))

    # every stream slice must land on its own device slice
    assert st_sh.counts.sharding.is_equivalent_to(sh, st_sh.counts.ndim)
    for name in StreamState._fields:
        a, b = np.asarray(getattr(st_ref, name)), np.asarray(getattr(st_sh, name))
        if a.dtype.kind == "i":
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-5, err_msg=name)
    # and the DoA answers agree exactly
    da = np.asarray(sl.estimate_doa(st_ref))
    db = np.asarray(sl.estimate_doa(st_sh))
    np.testing.assert_array_equal(da, db)


def test_sharded_serving_step_has_no_collectives(demo):
    """The multi-chip serving layout claims ZERO cross-device communication
    (streams are independent).  Machine-check it: the compiled HLO of the
    mesh-sharded step contains no collective ops at all."""
    from haghighatshoarmuir2024.parallel.mesh import make_mesh
    from jax.sharding import NamedSharding, PartitionSpec as PS

    sl = StreamingLocalizer(demo)
    mesh = make_mesh(8)
    sh = NamedSharding(mesh, PS("data"))
    state = jax.device_put(sl.init_state(batch=8), sh)
    chunks = jax.device_put(jnp.zeros((8, 6000, 7), jnp.float32), sh)
    step = sl.make_sharded_step(mesh)
    txt = step.lower(state, chunks).compile().as_text()
    for op in ("all-reduce", "all-gather", "collective-permute",
               "all-to-all", "reduce-scatter"):
        assert op not in txt, f"unexpected collective {op} in serving HLO"
