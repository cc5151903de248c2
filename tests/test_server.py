"""Serving daemon: native TCP ingestion (native/streamd.cpp) + the batched
carried-state serving loop answer concurrent streams with DoA estimates.

Production twin of the reference's one-capture-at-a-time live demo loop
(micloc/xylo_snn_localization.py:446-542); see runtime/server.py.
"""
import numpy as np
import pytest

from haghighatshoarmuir2024 import CenterCircularArray
from haghighatshoarmuir2024.models.xylo import Demo
from haghighatshoarmuir2024.ops.interp import signal_from_template
from haghighatshoarmuir2024.runtime.server import (
    LocalizationServer,
    ShmStreamClient,
    StreamClient,
)

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


def _stream_signal(demo, doa, duration, seed):
    t = np.arange(0, duration, 1 / FS)
    sig = np.sin(2 * np.pi * 1750 * t)
    clean = np.asarray(signal_from_template(demo.geometry, t, sig, doa, fs=FS))
    rng = np.random.default_rng(seed)
    sigma = np.sqrt((clean**2).mean() / 10 ** (10.0 / 10))
    return (clean + sigma * rng.standard_normal(clean.shape)).astype(np.float32)


def _folded_deg(a, b):
    return np.rad2deg(np.arcsin(abs(np.sin(a - b))))


def test_server_two_streams_localize(demo):
    chunk_sec = 0.125
    Tc = int(chunk_sec * FS)
    doas_true = {0: 0.7, 2: -1.4}
    with LocalizationServer(demo, max_streams=4, chunk_sec=chunk_sec) as srv:
        srv.start()
        clients = {sid: StreamClient(srv.port, sid) for sid in doas_true}
        sigs = {
            sid: _stream_signal(demo, d, 3 * chunk_sec, seed=sid)
            for sid, d in doas_true.items()
        }
        got = {}
        for k in range(3):
            for sid, c in clients.items():
                c.send(sigs[sid][k * Tc : (k + 1) * Tc])
            for sid, c in clients.items():
                rid, doa = c.recv_doa(timeout=300.0)
                assert rid == sid
                got[sid] = doa
        for sid, d_true in doas_true.items():
            assert _folded_deg(got[sid], d_true) < 25.0, (sid, got[sid], d_true)
        for c in clients.values():
            c.close()


def test_server_shm_stream_localizes(demo):
    """The shared-memory ingestion path (ring under /dev/shm, zero sockets)
    serves the same answers as TCP, and mixes with TCP streams in one cohort."""
    import os

    chunk_sec = 0.125
    Tc = int(chunk_sec * FS)
    with LocalizationServer(demo, max_streams=4, chunk_sec=chunk_sec) as srv:
        srv.start()
        shm = ShmStreamClient(f"hm2024_test_shm_{os.getpid()}")
        srv.attach_shm(1, shm.name)
        tcp = StreamClient(srv.port, 3)
        sig_shm = _stream_signal(demo, 0.7, 3 * chunk_sec, seed=5)
        sig_tcp = _stream_signal(demo, -1.4, 3 * chunk_sec, seed=6)
        got_shm = got_tcp = None
        for k in range(3):
            shm.send(sig_shm[k * Tc : (k + 1) * Tc])
            tcp.send(sig_tcp[k * Tc : (k + 1) * Tc])
            got_shm = shm.recv_doa(timeout=300.0)
            _, got_tcp = tcp.recv_doa(timeout=300.0)
        assert _folded_deg(got_shm, 0.7) < 25.0, got_shm
        assert _folded_deg(got_tcp, -1.4) < 25.0, got_tcp
        # slot conflict: a TCP hello on the shm-attached slot is rejected
        import socket as socket_mod
        import struct as struct_mod

        s = socket_mod.create_connection(("127.0.0.1", srv.port))
        s.sendall(struct_mod.pack("<II", 0x484D3234, 1))
        s.settimeout(5.0)
        assert s.recv(1) == b""  # server closes the rejected connection
        s.close()
        srv.detach_shm(1)
        tcp.close()
        shm.close()


def test_server_slot_reset_on_reconnect(demo):
    """A reclaimed slot starts from zeroed carried state (no bleed-through
    from the previous occupant of the slot)."""
    chunk_sec = 0.125
    Tc = int(chunk_sec * FS)
    with LocalizationServer(demo, max_streams=2, chunk_sec=chunk_sec) as srv:
        srv.start()
        c1 = StreamClient(srv.port, 1)
        sig_a = _stream_signal(demo, 0.7, 2 * chunk_sec, seed=1)
        for k in range(2):
            c1.send(sig_a[k * Tc : (k + 1) * Tc])
            c1.recv_doa(timeout=300.0)
        c1.close()

        import time

        time.sleep(0.5)  # let the daemon reap the closed socket
        c2 = StreamClient(srv.port, 1)
        sig_b = _stream_signal(demo, -1.4, 2 * chunk_sec, seed=2)
        last = None
        for k in range(2):
            c2.send(sig_b[k * Tc : (k + 1) * Tc])
            _, last = c2.recv_doa(timeout=300.0)
        assert _folded_deg(last, -1.4) < 25.0, last
        c2.close()


def test_server_u4_upsampled_wire_localizes(demo):
    """The maximum-compression wire — 4-bit mu-law codes at fs/4, i.e. 16x
    fewer bytes than float32 (ops/mulaw.py + ops/resample.py) — still serves
    correct DoAs: the on-device polyphase ingest reconstructs the 48 kHz
    stream with carried per-stream filter state across chunk seams."""
    from haghighatshoarmuir2024.runtime.server import WireEncoder

    chunk_sec = 0.125
    Tc = int(chunk_sec * FS)
    doas_true = {0: 0.7, 2: -1.4}
    with LocalizationServer(
        demo, max_streams=4, chunk_sec=chunk_sec, wire_dtype="u4",
        wire_upsample=4,
    ) as srv:
        assert srv.Tb == Tc // 8  # 16x fewer wire bytes than f32
        srv.start()
        clients = {sid: StreamClient(srv.port, sid) for sid in doas_true}
        encs = {sid: WireEncoder("u4", wire_upsample=4) for sid in doas_true}
        sigs = {
            sid: _stream_signal(demo, d, 3 * chunk_sec, seed=sid)
            for sid, d in doas_true.items()
        }
        got = {}
        for k in range(3):
            for sid, c in clients.items():
                x = sigs[sid][k * Tc : (k + 1) * Tc]
                c.send(encs[sid].encode(x / np.abs(sigs[sid]).max() * 0.98))
            for sid, c in clients.items():
                rid, doa = c.recv_doa(timeout=300.0)
                assert rid == sid
                got[sid] = doa
        for sid, d_true in doas_true.items():
            assert _folded_deg(got[sid], d_true) < 25.0, (sid, got[sid], d_true)
        for c in clients.values():
            c.close()


def test_server_mulaw_wire_localizes(demo):
    """The mu-law u8 wire (ops/mulaw.py, half of PCM16) serves the same
    answers: companding noise (~27 dB per-sample SNR) is far above what the
    zero-crossing spike front end needs."""
    from haghighatshoarmuir2024.ops.mulaw import mulaw_encode

    chunk_sec = 0.125
    Tc = int(chunk_sec * FS)
    doas_true = {0: 0.7, 2: -1.4}
    with LocalizationServer(
        demo, max_streams=4, chunk_sec=chunk_sec, wire_dtype="u8"
    ) as srv:
        srv.start()
        clients = {sid: StreamClient(srv.port, sid) for sid in doas_true}
        sigs = {
            sid: _stream_signal(demo, d, 3 * chunk_sec, seed=sid)
            for sid, d in doas_true.items()
        }
        got = {}
        for k in range(3):
            for sid, c in clients.items():
                x = sigs[sid][k * Tc : (k + 1) * Tc]
                c.send(mulaw_encode(x / np.abs(sigs[sid]).max() * 0.98))
            for sid, c in clients.items():
                rid, doa = c.recv_doa(timeout=300.0)
                assert rid == sid
                got[sid] = doa
        for sid, d_true in doas_true.items():
            assert _folded_deg(got[sid], d_true) < 25.0, (sid, got[sid], d_true)
        for c in clients.values():
            c.close()


def test_native_encoder_matches_python():
    """The C wire encoder (native/streamc.cpp) produces byte-identical codes
    to the Python WireEncoder at the wire rate, and float-identical
    decimation (carried anti-alias history) within rounding."""
    from haghighatshoarmuir2024.runtime.native_client import NativeWireEncoder
    from haghighatshoarmuir2024.runtime.server import WireEncoder

    rng = np.random.default_rng(123)
    chunks = [np.clip(rng.standard_normal((6000, 7)) * 0.4, -1, 1)
              .astype(np.float32) for _ in range(3)]
    # dense ramp sweeping every companding code boundary: catches the
    # float32-vs-double log1p drift (NEP 50) that a lucky seed can miss
    chunks.append(np.linspace(-1, 1, 70_000, dtype=np.float32).reshape(-1, 7))

    for wd in ("i16", "u8", "u4"):
        py, nat = WireEncoder(wd), NativeWireEncoder(wd, n_ch=7)
        for ch in chunks:
            a, b = py.encode(ch), nat.encode(ch)
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b, err_msg=wd)
        nat.close()

    # decimation path: compare the float wire (dtype f32, upsample 4) —
    # same carried history, same taps, independent implementations
    py, nat = WireEncoder("f32", 4), NativeWireEncoder("f32", 4, n_ch=7)
    for ch in chunks:
        a, b = py.encode(ch), nat.encode(ch)
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
    nat.close()


def test_native_clients_localize(demo):
    """Native producer clients (C TCP framing + C shm ring, C wire encoder
    at 16x compression) drive the daemon end-to-end."""
    import os

    from haghighatshoarmuir2024.runtime.native_client import (
        NativeShmClient,
        NativeStreamClient,
        NativeWireEncoder,
    )

    chunk_sec = 0.125
    Tc = int(chunk_sec * FS)
    with LocalizationServer(
        demo, max_streams=4, chunk_sec=chunk_sec, wire_dtype="u4",
        wire_upsample=4,
    ) as srv:
        srv.start()
        tcp = NativeStreamClient(srv.port, 0)
        shm = NativeShmClient(f"hm2024_test_natshm_{os.getpid()}")
        srv.attach_shm(2, shm.name)
        enc = {0: NativeWireEncoder("u4", 4, n_ch=7),
               2: NativeWireEncoder("u4", 4, n_ch=7)}
        sig_tcp = _stream_signal(demo, 0.7, 3 * chunk_sec, seed=11)
        sig_shm = _stream_signal(demo, -1.4, 3 * chunk_sec, seed=12)
        sig_tcp /= np.abs(sig_tcp).max() / 0.98
        sig_shm /= np.abs(sig_shm).max() / 0.98
        got_tcp = got_shm = None
        for k in range(3):
            tcp.send(enc[0].encode(sig_tcp[k * Tc:(k + 1) * Tc]))
            shm.send(enc[2].encode(sig_shm[k * Tc:(k + 1) * Tc]))
            rid, got_tcp = tcp.recv_doa(timeout=300.0)
            assert rid == 0
            got_shm = shm.recv_doa(timeout=300.0)
        assert _folded_deg(got_tcp, 0.7) < 25.0, got_tcp
        assert _folded_deg(got_shm, -1.4) < 25.0, got_shm
        srv.detach_shm(2)
        tcp.close()
        shm.close()
        for e in enc.values():
            e.close()


def test_ingest_upsample_carry_semantics(demo):
    """The stateful wire-rate ingest advances carried filter history only
    for ACTIVE slots, zeroes it for RESET slots, and holds it for idle ones
    (runtime/server.py ingest_up)."""
    import jax.numpy as jnp

    from haghighatshoarmuir2024.ops.resample import (
        TAPS_PER_PHASE,
        design_upsample_fir,
        phase_table,
        upsample_poly_stream,
    )

    chunk_sec = 0.125
    with LocalizationServer(
        demo, max_streams=4, chunk_sec=chunk_sec, wire_dtype="i16",
        wire_upsample=4,
    ) as srv:
        rng = np.random.default_rng(0)
        B, Tb, M = srv.B, srv.Tb, srv.M
        K = TAPS_PER_PHASE - 1
        raw = rng.integers(-30000, 30000, (B, Tb, M)).astype(np.int16)
        carry0 = jnp.asarray(rng.standard_normal((B, K, M)), jnp.float32)
        active = np.array([1, 0, 1, 0], np.float32)
        reset = np.array([0, 0, 1, 1], np.float32)
        y, c1 = srv._ingest_up(jnp.asarray(raw), carry0, active, reset)

        hp = phase_table(design_upsample_fir(4), 4)
        xw = raw.astype(np.float32) / 32768.0
        # slot 0 (active, no reset): advance from its old carry
        y0, c0 = upsample_poly_stream(jnp.asarray(xw[:1]), carry0[:1], hp, 4)
        np.testing.assert_array_equal(np.asarray(y)[0], np.asarray(y0)[0])
        np.testing.assert_array_equal(np.asarray(c1)[0], np.asarray(c0)[0])
        # slot 1 (idle): carry held
        np.testing.assert_array_equal(np.asarray(c1)[1], np.asarray(carry0)[1])
        # slot 2 (active + reset): history zeroed BEFORE its chunk
        y2, c2 = upsample_poly_stream(
            jnp.asarray(xw[2:3]), jnp.zeros((1, K, M), jnp.float32), hp, 4
        )
        np.testing.assert_array_equal(np.asarray(y)[2], np.asarray(y2)[0])
        np.testing.assert_array_equal(np.asarray(c1)[2], np.asarray(c2)[0])
        # slot 3 (reset, idle): carry zeroed
        np.testing.assert_array_equal(np.asarray(c1)[3], np.zeros((K, M)))


def test_server_churn_with_compressed_wire(demo):
    """Client churn on the compressed stateful wire: slots are reclaimed
    repeatedly while a persistent stream keeps running — reclaimed slots
    must localize fresh (zeroed SNN state AND zeroed upsampler history),
    and the survivor's answers must stay correct throughout."""
    import time

    from haghighatshoarmuir2024.runtime.server import WireEncoder

    chunk_sec = 0.125
    Tc = int(chunk_sec * FS)
    with LocalizationServer(
        demo, max_streams=4, chunk_sec=chunk_sec, wire_dtype="u4",
        wire_upsample=4,
    ) as srv:
        srv.start()
        # persistent stream on slot 3
        keeper = StreamClient(srv.port, 3)
        k_enc = WireEncoder("u4", wire_upsample=4)
        k_sig = _stream_signal(demo, 1.9, 8 * chunk_sec, seed=99)
        k_sig /= np.abs(k_sig).max() / 0.98
        k_last = None
        k_idx = 0

        for round_i in range(3):
            doa_round = 0.7 if round_i % 2 == 0 else -1.4
            churn = StreamClient(srv.port, 0)
            enc = WireEncoder("u4", wire_upsample=4)
            sig = _stream_signal(demo, doa_round, 2 * chunk_sec, seed=round_i)
            sig /= np.abs(sig).max() / 0.98
            last = None
            for k in range(2):
                churn.send(enc.encode(sig[k * Tc:(k + 1) * Tc]))
                keeper.send(k_enc.encode(k_sig[k_idx * Tc:(k_idx + 1) * Tc]))
                k_idx += 1
                _, last = churn.recv_doa(timeout=300.0)
                _, k_last = keeper.recv_doa(timeout=300.0)
            assert _folded_deg(last, doa_round) < 25.0, (round_i, last)
            assert _folded_deg(k_last, 1.9) < 25.0, (round_i, k_last)
            churn.close()
            time.sleep(0.4)  # let the daemon reap the socket before reclaim


def test_server_multichip_mesh_localizes(demo):
    """Multi-chip serving daemon: every device program (ingest, reset, the
    fused serve step) shard_mapped over the virtual 8-device mesh, streams
    split one-per-device — answers match the physics through real sockets
    and the compressed stateful wire."""
    from haghighatshoarmuir2024.parallel.mesh import make_mesh
    from haghighatshoarmuir2024.runtime.server import WireEncoder

    mesh = make_mesh(8, shape=(8, 1))
    chunk_sec = 0.125
    Tc = int(chunk_sec * FS)
    doas_true = {0: 0.7, 3: -1.4, 6: 2.3}
    with LocalizationServer(
        demo, max_streams=8, chunk_sec=chunk_sec, wire_dtype="u4",
        wire_upsample=4, mesh=mesh,
    ) as srv:
        srv.start()
        clients = {sid: StreamClient(srv.port, sid) for sid in doas_true}
        encs = {sid: WireEncoder("u4", wire_upsample=4) for sid in doas_true}
        sigs = {}
        for sid, d in doas_true.items():
            s = _stream_signal(demo, d, 3 * chunk_sec, seed=40 + sid)
            sigs[sid] = s / np.abs(s).max() * 0.98
        got = {}
        for k in range(3):
            for sid, c in clients.items():
                c.send(encs[sid].encode(sigs[sid][k * Tc:(k + 1) * Tc]))
            for sid, c in clients.items():
                rid, doa = c.recv_doa(timeout=300.0)
                assert rid == sid
                got[sid] = doa
        for sid, d_true in doas_true.items():
            assert _folded_deg(got[sid], d_true) < 25.0, (sid, got[sid], d_true)
        # the carried state is genuinely mesh-sharded
        assert srv._state.counts.sharding.is_equivalent_to(
            srv._stream_sharding, srv._state.counts.ndim
        )
        for c in clients.values():
            c.close()

    with pytest.raises(ValueError):
        LocalizationServer(demo, max_streams=6, mesh=mesh)


def test_server_forget_tracks_moving_source(demo):
    """Moving-source tracking (forget=gamma): a source that JUMPS DoA
    mid-stream is re-acquired within ~1/(1-gamma) chunks, while the default
    cumulative estimator stays biased toward the stale angle with the same
    chunk budget."""
    chunk_sec = 0.125
    Tc = int(chunk_sec * FS)
    doa_a, doa_b = 0.7, -1.4
    n_a, n_b = 4, 3

    sig_a = _stream_signal(demo, doa_a, n_a * chunk_sec, seed=1)
    sig_b = _stream_signal(demo, doa_b, n_b * chunk_sec, seed=2)
    sig = np.concatenate([sig_a, sig_b], axis=0)

    def run(forget):
        with LocalizationServer(
            demo, max_streams=2, chunk_sec=chunk_sec, forget=forget,
        ) as srv:
            srv.start()
            c = StreamClient(srv.port, 0)
            last = None
            for k in range(n_a + n_b):
                c.send(sig[k * Tc:(k + 1) * Tc])
                _, last = c.recv_doa(timeout=300.0)
            c.close()
            return last

    est_track = run(forget=0.4)
    est_cumul = run(forget=None)
    err_track = _folded_deg(est_track, doa_b)
    err_cumul = _folded_deg(est_cumul, doa_b)
    # tracking re-acquires the new angle...
    assert err_track < 25.0, (est_track, err_track)
    # ...and beats the cumulative estimator, which still carries 4 chunks of
    # evidence from the old angle against 3 of the new
    assert err_track < err_cumul - 5.0 or err_cumul > 45.0, (
        err_track, err_cumul,
    )


def test_server_forget_validation(demo):
    with pytest.raises(ValueError):
        LocalizationServer(demo, forget=1.0)


def test_server_survives_client_fuzz(demo):
    """Protocol fuzz: garbage hellos, fragmented frames, mid-frame
    disconnects, and oversized element counts must never wedge or kill the
    daemon — a well-behaved client afterwards still gets correct answers."""
    import socket as sk
    import struct as st
    import time

    chunk_sec = 0.125
    Tc = int(chunk_sec * FS)
    rng = np.random.default_rng(7)
    with LocalizationServer(demo, max_streams=4, chunk_sec=chunk_sec) as srv:
        srv.start()
        for i in range(8):
            s = sk.create_connection(("127.0.0.1", srv.port))
            kind = i % 4
            try:
                if kind == 0:  # wrong magic -> rejected
                    s.sendall(st.pack("<II", 0xDEADBEEF, 1))
                    s.settimeout(5.0)
                    assert s.recv(1) == b""
                elif kind == 1:  # valid hello, absurd n_elems -> dropped conn
                    s.sendall(st.pack("<II", 0x484D3234, 1))
                    s.sendall(st.pack("<I", 0xFFFFFFFF))
                elif kind == 2:  # valid hello, fragmented partial frame, die
                    s.sendall(st.pack("<II", 0x484D3234, 1))
                    payload = rng.standard_normal(333).astype(np.float32)
                    s.sendall(st.pack("<I", payload.size))
                    s.sendall(payload.tobytes()[: 7 * 13])  # mid-element cut
                else:  # out-of-range stream id -> rejected
                    s.sendall(st.pack("<II", 0x484D3234, 99))
                    s.settimeout(5.0)
                    assert s.recv(1) == b""
            finally:
                s.close()
            time.sleep(0.05)

        time.sleep(0.5)  # let the daemon reap everything
        good = StreamClient(srv.port, 2)
        sig = _stream_signal(demo, 0.7, 2 * chunk_sec, seed=8)
        last = None
        for k in range(2):
            good.send(sig[k * Tc:(k + 1) * Tc])
            _, last = good.recv_doa(timeout=300.0)
        assert _folded_deg(last, 0.7) < 25.0, last
        good.close()


@pytest.mark.parametrize("method", ["matched_stacked", "matched_auto"])
def test_server_matched_stacked_multiband(method):
    """Multi-band serving with the band-stacked matched estimators: the
    server scores the UNFOLDED per-band counts against the stacked table
    (method='matched_stacked' / the SNR-adaptive 'matched_auto' blend); a
    two-band stream localizes, and requesting the method without the stacked
    calibration raises."""
    geometry = CenterCircularArray(radius=4.5e-2, num_mic=7)
    grid = np.linspace(-np.pi, np.pi, 33)
    d = Demo(
        geometry=geometry,
        freq_bands=[[1600, 1900], [1900, 2200]],
        doa_list=grid,
        recording_duration=0.25,
        kernel_duration=5e-3,
        bipolar_spikes=True,
        fs=FS,
        use_cache=False,
        design_chunk=16,
    )
    with pytest.raises(ValueError, match="band_stacked"):
        LocalizationServer(d, max_streams=2, method=method)

    t = np.arange(0, 0.25, 1 / FS)
    sig = np.sin(2 * np.pi * 1750 * t) + np.sin(2 * np.pi * 2050 * t)
    d.calibrate_profiles(template=(t, sig), use_cache=False, band_stacked=True)

    chunk_sec = 0.125
    Tc = int(chunk_sec * FS)
    doa_true = 0.9
    tt = np.arange(0, 4 * chunk_sec, 1 / FS)
    ss = np.sin(2 * np.pi * 1750 * tt) + np.sin(2 * np.pi * 2050 * tt)
    clean = np.asarray(signal_from_template(geometry, tt, ss, doa_true, fs=FS))
    rng = np.random.default_rng(3)
    sigma = np.sqrt((clean**2).mean() / 10 ** (10.0 / 10))
    sig_in = (clean + sigma * rng.standard_normal(clean.shape)).astype(np.float32)

    with LocalizationServer(d, max_streams=2, chunk_sec=chunk_sec,
                            method=method) as srv:
        srv.start()
        c = StreamClient(srv.port, 0)
        got = None
        for k in range(4):
            c.send(sig_in[k * Tc : (k + 1) * Tc])
            _, got = c.recv_doa(timeout=300.0)
        c.close()
    step = np.degrees(grid[1] - grid[0])
    assert _folded_deg(got, doa_true) <= 2 * step, (got, doa_true)


def test_server_tracked_doas(demo):
    """track=True: per-stream wrapped-angle alpha-beta tracking on the
    posted DoAs (utils/tracking.py).  The tracked stream converges on a
    stationary source, and tracker state resets with the slot on
    reconnect (a successor at a different DoA re-acquires immediately
    instead of being dragged by the predecessor's track)."""
    chunk_sec = 0.125
    Tc = int(chunk_sec * FS)
    doa_true = 0.7
    with LocalizationServer(
        demo, max_streams=2, chunk_sec=chunk_sec, track=True
    ) as srv:
        srv.start()
        c = StreamClient(srv.port, 0)
        sig = _stream_signal(demo, doa_true, 4 * chunk_sec, seed=0)
        last = None
        for k in range(4):
            c.send(sig[k * Tc : (k + 1) * Tc])
            rid, last = c.recv_doa(timeout=300.0)
            assert rid == 0
        assert _folded_deg(last, doa_true) < 25.0
        c.close()

        # successor claims the same slot at a far DoA: the tracker must
        # have been reset (otherwise its 25-deg gate would coast on the
        # predecessor's angle and never report the new source)
        c2 = StreamClient(srv.port, 0)
        doa_new = -1.4
        sig2 = _stream_signal(demo, doa_new, 4 * chunk_sec, seed=1)
        last2 = None
        for k in range(4):
            c2.send(sig2[k * Tc : (k + 1) * Tc])
            rid, last2 = c2.recv_doa(timeout=300.0)
            assert rid == 0
        assert _folded_deg(last2, doa_new) < 25.0, (last2, doa_new)
        c2.close()


def _two_source_chunk(demo, doa_a, doa_b, Tc, seed, f_a=1700.0, f_b=1850.0):
    """One (Tc, M) chunk holding two equal-power tones from two DoAs
    (the serving twin of the reference's two-target scenario,
    paper_plots/multiple_targets_snn.py:194-195)."""
    t = np.arange(Tc) / FS
    sa = np.asarray(
        signal_from_template(
            demo.geometry, t, np.sin(2 * np.pi * f_a * t), doa_a, fs=FS
        )
    )
    sb = np.asarray(
        signal_from_template(
            demo.geometry, t, np.sin(2 * np.pi * f_b * t), doa_b, fs=FS
        )
    )
    mix = sa + sb
    rng = np.random.default_rng(seed)
    sigma = np.sqrt((mix**2).mean() / 10 ** (20.0 / 10))
    return (mix + sigma * rng.standard_normal(mix.shape)).astype(np.float32)


def test_server_multi_source_frames(demo):
    """sources=2: the daemon's result frames carry TWO NaN-padded DoA slots
    (u32 id + f32[2], native sd_set_sources / sd_post_results), and a
    two-tone stream resolves both targets through the socket protocol."""
    chunk_sec = 0.125
    Tc = int(chunk_sec * FS)
    doa_a, doa_b = np.deg2rad(90.0), np.deg2rad(-45.0)
    with LocalizationServer(
        demo, max_streams=2, chunk_sec=chunk_sec, sources=2
    ) as srv:
        srv.start()
        c = StreamClient(srv.port, 0, sources=2)
        got = None
        for k in range(4):
            c.send(_two_source_chunk(demo, doa_a, doa_b, Tc, seed=k))
            rid, got = c.recv_doa(timeout=300.0)
            assert rid == 0
            assert got.shape == (2,)
        found = sorted(got[np.isfinite(got)].tolist())
        assert len(found) == 2, got
        errs = [
            min(_folded_deg(f, doa_a), _folded_deg(f, doa_b)) for f in found
        ]
        assert max(errs) < 25.0, (found, errs)
        c.close()


def test_server_multi_source_crossing_tracks(demo):
    """End-to-end daemon test of two CROSSING sources: a
    two-tone stream whose DoAs sweep through each other; the per-slot
    MultiDoaTracker (sources=2, track=True) keeps two confirmed tracks
    through the crossing, and tracker state resets with the slot."""
    chunk_sec = 0.125
    Tc = int(chunk_sec * FS)
    n_warm, n_move, n_tail = 3, 14, 5
    # 3 stationary acquisition chunks, a sweep where the sources pass
    # through each other (a 110 -> 10 deg, b -30 -> 70 deg), then 5 settle
    # chunks: through the crossing the tracker may legitimately swap track
    # identities and needs a few chunks to re-converge (the forgetting EMA
    # carries ~2 chunks of profile lag)
    path_a = np.deg2rad(
        np.concatenate(
            [np.full(n_warm, 110.0), np.linspace(110.0, 10.0, n_move),
             np.full(n_tail, 10.0)]
        )
    )
    path_b = np.deg2rad(
        np.concatenate(
            [np.full(n_warm, -30.0), np.linspace(-30.0, 70.0, n_move),
             np.full(n_tail, 70.0)]
        )
    )
    n_chunks = n_warm + n_move + n_tail
    with LocalizationServer(
        demo, max_streams=2, chunk_sec=chunk_sec, sources=2, track=True,
        forget=0.35, track_gate_deg=35.0,
    ) as srv:
        srv.start()
        c = StreamClient(srv.port, 0, sources=2)
        history = []
        for k in range(n_chunks):
            c.send(
                _two_source_chunk(demo, float(path_a[k]), float(path_b[k]), Tc, seed=k)
            )
            rid, doas = c.recv_doa(timeout=300.0)
            assert rid == 0
            history.append(doas)
        # after the crossing both sources must still be tracked, each near
        # one of the true (now swapped) positions
        final = history[-1]
        finite = final[np.isfinite(final)]
        assert finite.size == 2, history
        errs = [
            min(_folded_deg(f, path_a[-1]), _folded_deg(f, path_b[-1]))
            for f in finite
        ]
        assert max(errs) < 30.0, (np.rad2deg(finite), errs)
        # both true endpoints are claimed (not two tracks on one source)
        best_a = min(_folded_deg(f, path_a[-1]) for f in finite)
        best_b = min(_folded_deg(f, path_b[-1]) for f in finite)
        assert best_a < 30.0 and best_b < 30.0, np.rad2deg(finite)
        c.close()


def test_server_reduced_rate_24k():
    """The serving daemon is fs-agnostic: a 24 kHz reduced-rate model
    (round 5, experiments/reduced_rate.py — measured transparent) serves
    through sockets unchanged.  The wire_upsample>1 combination is rejected:
    its anti-alias prototype's cutoff is fs-relative (2.25 kHz at 24 k,
    inside the 2.0-2.6 kHz reference bands)."""
    fs24 = 24_000
    geometry = CenterCircularArray(radius=4.5e-2, num_mic=7)
    d24 = Demo(
        geometry=geometry,
        freq_bands=[[1600, 1900]],
        doa_list=np.linspace(-np.pi, np.pi, 65),
        recording_duration=0.25,
        kernel_duration=5e-3,
        bipolar_spikes=True,
        fs=fs24,
        use_cache=False,
    )
    # matched estimator (the production path): the raw-peak warp at this
    # tiny grid/kernel config is ~30 deg at 24 kHz, as at 48 kHz
    d24.calibrate_profiles(use_cache=False)
    chunk_sec = 0.125
    Tc = int(chunk_sec * fs24)
    doa_true = 0.7
    t = np.arange(0, 3 * chunk_sec, 1 / fs24)
    sig = np.sin(2 * np.pi * 1750 * t)
    clean = np.asarray(signal_from_template(d24.geometry, t, sig, doa_true, fs=fs24))
    rng = np.random.default_rng(0)
    sigma = np.sqrt((clean**2).mean() / 10 ** (10.0 / 10))
    stream = (clean + sigma * rng.standard_normal(clean.shape)).astype(np.float32)

    with LocalizationServer(d24, max_streams=2, chunk_sec=chunk_sec) as srv:
        srv.start()
        c = StreamClient(srv.port, 0)
        got = None
        for k in range(3):
            c.send(stream[k * Tc : (k + 1) * Tc])
            _, got = c.recv_doa(timeout=300.0)
        c.close()
    assert _folded_deg(got, doa_true) < 25.0, got

    with pytest.raises(ValueError, match="48 kHz"):
        LocalizationServer(d24, max_streams=2, wire_upsample=4)
