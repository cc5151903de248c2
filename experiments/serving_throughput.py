"""Streaming serving benchmark: sustained multi-stream throughput and
single-stream chunk latency of the carried-state runtime.

The reference has no serving runtime at all — its live demo processes one
0.25 s sox capture at a time through XyloSim slower than real time
(micloc/xylo_snn_localization.py:446-542, SURVEY §6.4).  This harness
measures the runtime's production configuration: B concurrent audio
streams advanced by one jitted carried-state step per chunk
(runtime/streaming.StreamingLocalizer).

Reported metrics:
  * serving-audio-sec/sec — sustained batched throughput (pipelined
    dispatch, blocked at the end; the per-step wall time is what a serving
    loop would see at steady state)
  * latency-ms-blocking — single-stream per-chunk latency as observed by a
    blocking host loop (includes the host↔device round-trip — reported
    separately because it is transport, not compute)
  * latency-ms-pipelined — per-chunk device time of the same single-stream
    step (dispatch n steps, block once), the on-device latency floor
"""
from __future__ import annotations

import json
import time

import numpy as np

from common import FS, sinusoid_template  # noqa: E402  (sys.path set in common)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402


def main(
    batch: int = 96,  # single-chip sweet spot (see bench.py batch sweep)
    chunk_sec: float = 0.25,
    n_steps: int = 100,
    freq_band=(1600, 1900),
    num_grid: int = 64 * 7 + 1,
    fs: int = FS,
    sources: int = 1,
):
    from haghighatshoarmuir2024 import CenterCircularArray
    from haghighatshoarmuir2024.models.xylo import Demo
    from haghighatshoarmuir2024.ops.interp import signal_from_template
    from haghighatshoarmuir2024.runtime import StreamingLocalizer

    geometry = CenterCircularArray(radius=4.5e-2, num_mic=7)
    demo = Demo(
        geometry=geometry,
        freq_bands=[list(freq_band)],
        doa_list=np.linspace(-np.pi, np.pi, num_grid),
        recording_duration=chunk_sec,
        kernel_duration=10e-3,
        bipolar_spikes=True,
        fs=fs,
    )
    demo.calibrate_profiles()  # bias-free matched estimator for the gate
    sl = StreamingLocalizer(demo)

    # B streams, each a tone from a different direction + noise
    t, sig = sinusoid_template(float(np.mean(freq_band)), chunk_sec, fs=fs)
    rng = np.random.default_rng(0)
    doas = np.linspace(-np.pi, np.pi, batch, endpoint=False)
    chunks = np.stack(
        [np.asarray(signal_from_template(geometry, t, sig, float(d), fs=fs)) for d in doas]
    ).astype(np.float32)
    if sources == 2:
        # second equal-power tone per stream, 2 rad away (multi-source
        # serving row)
        t2 = np.arange(0, chunk_sec, 1 / fs)
        sig2 = np.sin(2 * np.pi * (float(np.mean(freq_band)) + 100.0) * t2)
        doas_b = np.arctan2(np.sin(doas + 2.0), np.cos(doas + 2.0))
        chunks = chunks + np.stack([
            np.asarray(signal_from_template(geometry, t2, sig2, float(d), fs=fs))
            for d in doas_b
        ]).astype(np.float32)
    chunks = chunks + 0.1 * rng.standard_normal(chunks.shape).astype(np.float32)
    chunks_j = jnp.asarray(chunks)

    # ---- batched serving throughput (pipelined: the steady-state rate)
    state = sl.init_state(batch=batch)
    state = sl.process_chunk(state, chunks_j, return_spikes=False)  # compile
    jax.tree.leaves(state)[0].block_until_ready()

    state = sl.init_state(batch=batch)
    t0 = time.time()
    for _ in range(n_steps):
        state = sl.process_chunk(state, chunks_j, return_spikes=False)
    jax.tree.leaves(state)[0].block_until_ready()
    step_ms = (time.time() - t0) / n_steps * 1000
    serving = batch * chunk_sec / (step_ms / 1000)

    # sanity: the carried counts must localize every stream (matched = the
    # bias-free estimator the flagship ships; peak = reference-parity argmax).
    # With sources == 2 this path still estimates ONE DoA per stream (the
    # StreamingLocalizer has no peak picker state here — the daemon path
    # measures real two-source coverage); the honest gate is "the single
    # estimate locks one of the two sources", scored against the nearer.
    ests = np.asarray(sl.estimate_doa(state, method="matched"))
    err = np.abs(np.arcsin(np.abs(np.sin(ests - doas))))
    if sources == 2:
        err_b = np.abs(np.arcsin(np.abs(np.sin(ests - doas_b))))
        err = np.minimum(err, err_b)
    ok = float(np.mean(np.rad2deg(err) < 5.0))

    # ---- single-stream latency
    state1 = sl.init_state()
    state1, _ = sl.process_chunk(state1, chunks_j[0])  # compile
    jax.tree.leaves(state1)[0].block_until_ready()

    lat_block = []
    state1 = sl.init_state()
    for _ in range(10):
        t0 = time.time()
        state1, _ = sl.process_chunk(state1, chunks_j[0])
        jax.tree.leaves(state1)[0].block_until_ready()
        lat_block.append((time.time() - t0) * 1000)

    state1 = sl.init_state()
    t0 = time.time()
    for _ in range(50):
        state1, _ = sl.process_chunk(state1, chunks_j[0])
    jax.tree.leaves(state1)[0].block_until_ready()
    lat_pipe = (time.time() - t0) / 50 * 1000

    metrics = {
        "serving-audio-sec/sec": round(serving, 1),
        "serving-step-ms": round(step_ms, 2),
        "streams": batch,
        "doa-ok-frac@5deg" if sources == 1 else "nearest-source-frac@5deg": ok,
        "sources": sources,
        "latency-ms-blocking": round(float(np.median(lat_block)), 1),
        "latency-ms-pipelined": round(lat_pipe, 1),
    }
    print(json.dumps(metrics))
    return metrics


def daemon_main(
    batch: int = 64,
    chunk_sec: float = 0.25,
    n_steps: int = 20,
    freq_band=(1600, 1900),
    num_grid: int = 64 * 7 + 1,
    use_shm: bool = False,
    wire: str = "i16",
    wire_upsample: int = 1,
    native_clients: bool = False,
    sources: int = 1,
    fs: int = FS,
):
    """End-to-end serving throughput THROUGH the native daemon: 64 clients
    stream PCM in lockstep; wall time covers ingestion (native/streamd.cpp),
    the batched carried-state device step, and DoA result routing — the full
    production path.  ``use_shm=True`` swaps the TCP sockets for per-stream
    shared-memory rings (co-located producer path): plain memcpy in, seq-slot
    results out — no socket syscalls, no kernel copies, no epoll reader."""
    from haghighatshoarmuir2024 import CenterCircularArray
    from haghighatshoarmuir2024.models.xylo import Demo
    from haghighatshoarmuir2024.ops.interp import signal_from_template
    from haghighatshoarmuir2024.runtime.server import (
        LocalizationServer,
        ShmStreamClient,
        StreamClient,
    )

    geometry = CenterCircularArray(radius=4.5e-2, num_mic=7)
    demo = Demo(
        geometry=geometry,
        freq_bands=[list(freq_band)],
        doa_list=np.linspace(-np.pi, np.pi, num_grid),
        recording_duration=chunk_sec,
        kernel_duration=10e-3,
        bipolar_spikes=True,
        fs=fs,
    )
    demo.calibrate_profiles()

    t, sig = sinusoid_template(float(np.mean(freq_band)), chunk_sec, fs=fs)
    rng = np.random.default_rng(0)
    doas = np.linspace(-np.pi, np.pi, batch, endpoint=False)
    chunks = np.stack(
        [np.asarray(signal_from_template(geometry, t, sig, float(d), fs=fs)) for d in doas]
    ).astype(np.float32)
    if sources == 2:
        # second equal-power tone per stream, 2 rad away (multi-source
        # serving row)
        t2 = np.arange(0, chunk_sec, 1 / fs)
        sig2 = np.sin(2 * np.pi * (float(np.mean(freq_band)) + 100.0) * t2)
        doas_b = np.arctan2(np.sin(doas + 2.0), np.cos(doas + 2.0))
        chunks = chunks + np.stack([
            np.asarray(signal_from_template(geometry, t2, sig2, float(d), fs=fs))
            for d in doas_b
        ]).astype(np.float32)
    chunks = chunks + 0.1 * rng.standard_normal(chunks.shape).astype(np.float32)

    # Compressed wire: PCM16 halves socket + host->device bytes vs f32
    # (production audio is int16 anyway); mu-law u8 halves it AGAIN at
    # ~27 dB per-sample SNR; u4 packs two 4-bit codes per byte; and
    # wire_upsample=4 ships 12 kHz audio reconstructed to 48 kHz ON DEVICE
    # (ops/resample.py) — u4@12k is 16x less than f32, 4x less than u8.
    # On a transport-bound host the upload is the serving ceiling, so wire
    # bytes convert ~directly into throughput.
    from haghighatshoarmuir2024.runtime.server import encode_wire

    peak = np.abs(chunks).max()
    # encode_wire handles every dtype (f32 passthrough included) — an ad-hoc
    # int16 branch here once desynced --wire=f32 (i16 bytes into an f32 server).
    chunks_wire = np.stack([
        encode_wire(c / peak * 0.98, wire, wire_upsample) for c in chunks
    ])
    import os

    with LocalizationServer(
        demo, max_streams=batch, chunk_sec=chunk_sec, wire_dtype=wire,
        batch_window_ms=60, wire_upsample=wire_upsample, sources=sources,
    ) as srv:
        srv.start()
        if native_clients:  # C producer path (native/streamc.cpp)
            from haghighatshoarmuir2024.runtime.native_client import (
                NativeShmClient,
                NativeStreamClient,
            )

            if use_shm:
                clients = [
                    NativeShmClient(f"hm2024_bench_{os.getpid()}_{i}")
                    for i in range(batch)
                ]
                for i, c in enumerate(clients):
                    srv.attach_shm(i, c.name)
            else:
                clients = [
                    NativeStreamClient(srv.port, i, sources=sources)
                    for i in range(batch)
                ]
        elif use_shm:
            clients = [
                ShmStreamClient(f"hm2024_bench_{os.getpid()}_{i}") for i in range(batch)
            ]
            for i, c in enumerate(clients):
                srv.attach_shm(i, c.name)
        else:
            clients = [
                StreamClient(srv.port, i, sources=sources) for i in range(batch)
            ]
        # warm-up step compiles the batched program
        for i, c in enumerate(clients):
            c.send(chunks_wire[i])
        got = {}
        if use_shm:
            for i, c in enumerate(clients):
                got[i] = (c.recv_doa(timeout=600.0) if sources == 1
                          else c.recv_doa(timeout=600.0, sources=sources))
        else:
            for c in clients:
                sid, doa = c.recv_doa(timeout=600.0)
                got[sid] = doa
        # drop the warm-up round's compile time from the stage attribution
        srv.stage_times.update({k: 0 if k == "steps" else 0.0 for k in srv.stage_times})

        t0 = time.time()
        for _ in range(n_steps):
            for i, c in enumerate(clients):
                c.send(chunks_wire[i])
            if use_shm:
                for i, c in enumerate(clients):
                    got[i] = (c.recv_doa(timeout=600.0) if sources == 1
                              else c.recv_doa(timeout=600.0, sources=sources))
            else:
                for c in clients:
                    sid, doa = c.recv_doa(timeout=600.0)
                    got[sid] = doa
        wall = time.time() - t0
        if sources == 2:
            # each stream's K result slots must cover BOTH its true DoAs
            oks = []
            for i in range(batch):
                res = np.atleast_1d(np.asarray(got[i], np.float64))
                res = res[np.isfinite(res)]
                cov = [
                    res.size > 0 and bool(np.min(np.degrees(np.abs(np.arcsin(
                        np.abs(np.sin(res - d)))))) < 10.0)
                    for d in (doas[i], doas_b[i])
                ]
                oks.append(all(cov))
            ok = float(np.mean(oks))
        else:
            ests = np.array([got[i] for i in range(batch)])
            err = np.abs(np.arcsin(np.abs(np.sin(ests - doas))))
            ok = float(np.mean(np.rad2deg(err) < 5.0))
        st = dict(srv.stage_times)
        for i, c in enumerate(clients):
            if use_shm:
                srv.detach_shm(i)
            c.close()

    serving = batch * chunk_sec * n_steps / wall
    metrics = {
        ("shm" if use_shm else "daemon") + "-audio-sec/sec": round(serving, 1),
        "daemon-step-ms": round(wall / n_steps * 1000, 2),
        "streams": batch,
        "doa-ok-frac@5deg" if sources == 1 else "both-sources-frac@10deg": ok,
        "sources": sources,
        "wire": wire + ("@12k" if wire_upsample == 4 else ""),
        "native-clients": native_clients,
    }
    if st["steps"]:
        metrics["stage-ms"] = {
            k: round(v / st["steps"] * 1000, 1)
            for k, v in st.items() if k != "steps"
        }
        metrics["stage-steps"] = st["steps"]
    print(json.dumps(metrics))
    return metrics


if __name__ == "__main__":
    import sys

    wire = "i16"
    for w in ("u8", "u4", "f32"):
        if f"--wire={w}" in sys.argv:
            wire = w
    up = 4 if "--decim=4" in sys.argv else 1
    native = "--native" in sys.argv
    n_src = 2 if "--sources=2" in sys.argv else 1
    fs_cli = FS
    for a in sys.argv[1:]:
        if a.startswith("--fs="):
            fs_cli = int(a.split("=", 1)[1])
    if "--shm" in sys.argv:
        daemon_main(use_shm=True, wire=wire, wire_upsample=up,
                    native_clients=native, sources=n_src, fs=fs_cli)
    elif "--daemon" in sys.argv:
        daemon_main(wire=wire, wire_upsample=up, native_clients=native,
                    sources=n_src, fs=fs_cli)
    else:
        main(fs=fs_cli, sources=n_src)
