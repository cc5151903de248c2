"""Smoke test of the localization system on one NVIDIA GPU.

Drives the flagship deployment through the entry points a user calls, at full
width: the quantized encode→SNN→DoA pipeline (``Demo``; 7-mic circular array,
1600–1900 Hz band, 449-point DoA grid, 0.25 s frames at 48 kHz, matched
estimator with the bundled design and calibration), its streaming runtime
over 96 streams, and the serving daemon with native clients on localhost.

Phases, in order; each prints what it found, and any failure exits non-zero:

  (a) device     the default JAX device is a GPU, else exit 1
  (b) kernels    the compiled Pallas LIF kernel equals the lax.scan simulator
                 bit for bit at B=96, T=12000 (stateless, and stateful in 4
                 chunks); the RZCC masks on the GPU equal the same function
                 on the CPU
  (c) flagship   Demo.forward_batch(method="matched") on 96 frames: the gate
                 (every DoA within 5°), and the rate profile and DoAs against
                 a CPU process driving the same saved model; memory analysis
                 of the compiled step
  (d) streaming  StreamingLocalizer, 96 streams × 4 chunks: decided spikes
                 equal the offline encoder after its start-up transient but
                 for rare one-sample moves of near-tie extrema, the carried
                 LIF counts equal the simulator on those spikes, and every
                 streamed DoA is within 5°
  (e) served     runtime/server.py on localhost, 4 native clients: every
                 stream gets DoAs back, the last within 5°
  (f) on-card    the tests in tests_gpu/, run in this process

``--four`` runs only the multi-device paths, on four GPUs: the stream-sharded
serving step against the same streams on one GPU, and the sharded
Monte-Carlo sweep against the unsharded one.

The last line of standard output is the result as JSON.  One process uses
the card; the CPU reference of phase (c) runs in a child held to the CPU.

Usage:  python chip_smoke.py [--four]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
FS = 48_000
FRAME = 0.25
GRID = 449
BATCH = 96
GATE_DEG = 5.0
# streamed vs offline spike decisions: the chunked and whole-signal filters
# round differently, which can move a near-tie extremum by one sample (two
# mismatching timesteps); at most this fraction of the compared timesteps
STREAM_MISMATCH_FRAC = 1e-3
# parity with the CPU backend: the float encode differs across backends at
# the ULP level, so a handful of spike decisions out of thousands may flip —
# normalized rate-profile distance < 5% (the bound of the on-card parity
# test) and matched DoAs within one grid step.  The raw 449-point profile's
# argmax is not compared: its top is flat to within a spike or two, so one
# flipped decision can move it by several grid steps.
RATE_REL_TOL = 0.05


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def card() -> str:
    """``name, power.limit`` of the card, read by a child that stays off JAX."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"
    return r.stdout.strip() or f"nvidia-smi failed: {r.stderr.strip()}"


def folded_deg(est, true):
    return np.rad2deg(np.arcsin(np.abs(np.sin(np.asarray(est) - np.asarray(true)))))


def timed(fn, *args, reps: int = 20):
    """(compile-and-first-call seconds, mean ms per call over ``reps``
    pipelined calls ending in block_until_ready)."""
    import jax

    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return first_s, (time.perf_counter() - t0) / reps * 1e3


# --------------------------------------------------------------- (a) device
def phase_device(count: int):
    import jax
    import jaxlib

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"[a] no GPU: JAX found {devs}", file=sys.stderr)
        sys.exit(1)
    if len(devs) < count:
        print(f"[a] need {count} GPUs, JAX found {len(devs)}", file=sys.stderr)
        sys.exit(1)
    kind = devs[0].device_kind
    log("a", f"platform gpu, device_kind {kind}, count {len(devs)}, "
             f"jax {jax.__version__}, jaxlib {jaxlib.__version__}")
    print(card(), flush=True)
    return kind, len(devs)


def flagship_demo():
    from haghighatshoarmuir2024 import CenterCircularArray
    from haghighatshoarmuir2024.models.xylo import Demo

    demo = Demo(
        geometry=CenterCircularArray(radius=4.5e-2, num_mic=7),
        freq_bands=[[1600, 1900]],
        doa_list=np.linspace(-np.pi, np.pi, GRID),
        recording_duration=FRAME,
        kernel_duration=10e-3,
        bipolar_spikes=True,
        fs=FS,
    )
    demo.calibrate_profiles()
    return demo


def make_audio(demo, doas, duration: float, seed: int):
    """(B, T, 7) float32 array audio: a 1750 Hz tone from each DoA plus
    white noise at 0.1, synthesized on the device from a seed."""
    import jax
    import jax.numpy as jnp

    from haghighatshoarmuir2024.ops.interp import signal_from_template

    t = np.arange(0, duration, 1 / FS)
    sig = np.sin(2 * np.pi * 1750 * t)
    clean = jax.jit(
        jax.vmap(lambda d: signal_from_template(demo.geometry, t, sig, d, fs=FS))
    )(jnp.asarray(doas, jnp.float32))
    noise = jax.random.normal(jax.random.PRNGKey(seed), clean.shape, clean.dtype)
    return (clean + 0.1 * noise).astype(jnp.float32)


# -------------------------------------------------------------- (b) kernels
def phase_kernels(demo, frames):
    import jax
    import jax.numpy as jnp

    from haghighatshoarmuir2024.models.xylo.pipeline import _encode_cumsum
    from haghighatshoarmuir2024.ops.pallas.lif_kernel import (
        _combine_bipolar,
        _scan_counts,
        lif_count_rates_bipolar,
        lif_count_stateful_bipolar,
    )
    from haghighatshoarmuir2024.ops.peaks import rzcc_encode_bipolar_tm

    cfg = demo.xylo_config
    rw = demo.beamfs[0].robust_width
    kernel = np.asarray(demo.beamfs[0].kernel, np.float32)
    cs = jax.jit(jax.vmap(
        lambda s: _encode_cumsum(s, kernel, bas=demo._bas, time_major=True),
        out_axes=1,
    ))(frames)
    T, B, C = cs.shape
    log("b", f"encode (T, B, C) = {(T, B, C)}")

    rzcc = jax.jit(lambda x: rzcc_encode_bipolar_tm(x, rw, 2 * rw))
    rows = cs.reshape(T, B * C)
    kp, kn = rzcc(rows)
    kp_c, kn_c = rzcc(jax.device_put(np.asarray(rows), jax.devices("cpu")[0]))
    bad = int(np.sum(np.asarray(kp) != np.asarray(kp_c)) + np.sum(np.asarray(kn) != np.asarray(kn_c)))
    log("b", f"RZCC masks GPU vs CPU on the same float32 input: {bad} differing "
             f"of {2 * kp.size}; spikes/channel/s {float(np.asarray(kp).mean()) * FS:.1f}")
    if bad:
        raise AssertionError("RZCC masks differ between GPU and CPU")

    kp3, kn3 = kp.reshape(T, B, C), kn.reshape(T, B, C)
    lif = jax.jit(lambda p, n: lif_count_rates_bipolar(cfg, p, n, spike_bound=1))
    ref_fn = jax.jit(lambda p, n, z: _scan_counts(cfg, _combine_bipolar(p, n), z, z, z, 0))
    zeros = jnp.zeros((B, cfg.n_hidden), jnp.int32)
    first_s, kern_ms = timed(lif, kp3, kn3)
    counts = np.asarray(lif(kp3, kn3))
    ref_first_s, scan_ms = timed(ref_fn, kp3, kn3, zeros, reps=3)
    ref = jax.block_until_ready(ref_fn(kp3, kn3, zeros))
    log("b", f"LIF kernel {kern_ms:.3f} ms (first call {first_s:.1f} s), scan reference "
             f"{scan_ms:.3f} ms (first call {ref_first_s:.1f} s); "
             f"total spikes {int(counts.sum())}")
    if not np.array_equal(counts, np.asarray(ref[0])):
        raise AssertionError(
            f"LIF kernel counts differ from the scan at {int(np.sum(counts != np.asarray(ref[0])))} entries"
        )
    log("b", "LIF kernel == scan reference, bit for bit (stateless)")

    step = jax.jit(lambda p, n, i, v, s: lif_count_stateful_bipolar(cfg, p, n, i, v, s, spike_bound=1))
    state = (zeros, zeros, zeros)
    total = np.zeros_like(counts)
    for part in np.array_split(np.arange(T), 4):
        sl = slice(int(part[0]), int(part[-1]) + 1)
        c, *state = step(kp3[sl], kn3[sl], *state)
        total += np.asarray(c)
    same_state = all(np.array_equal(np.asarray(a), np.asarray(b)) for a, b in zip(state, ref[1:]))
    if not (np.array_equal(total, counts) and same_state):
        raise AssertionError("stateful LIF in 4 chunks differs from the full run")
    log("b", "stateful LIF in 4 chunks == full run (counts and final isyn/vmem/spk)")



# ------------------------------------------------------------- (c) flagship
_CPU_RATES = r"""
import sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, {repo!r})
from haghighatshoarmuir2024.models.xylo import Demo
demo = Demo.load({model!r})
doa, rate = demo.forward_batch(np.load({sig!r}), method="matched")
np.save({out!r}, np.concatenate([np.asarray(doa, np.float32)[:, None],
                                 np.asarray(rate, np.float32)], axis=1))
"""


def phase_flagship(demo, frames, doas, kind):
    first_s, step_ms = timed(lambda x: demo.forward_batch(x, method="matched"), frames)
    doa, rate = demo.forward_batch(frames, method="matched")
    err = folded_deg(doa, doas)
    gate = float(np.mean(err < GATE_DEG))
    log("c", f"{kind} ({card()}): compile+first call {first_s:.1f} s, step "
             f"{step_ms:.3f} ms for {BATCH} x {FRAME} s frames = "
             f"{BATCH * FRAME / step_ms * 1e3:.1f} audio-s/s; matched gate "
             f"{gate:.2f} within {GATE_DEG}° (max err {err.max():.2f}°)")
    if gate < 1.0:
        raise AssertionError("matched gate below 1.00")
    ma = demo._forward_batch_matched_jit.lower(frames).compile().memory_analysis()
    log("c", f"flagship step memory_analysis: {ma}")

    work = os.path.join(REPO, ".cache", "smoke")
    os.makedirs(work, exist_ok=True)
    paths = {k: os.path.join(work, k) for k in ("model.npz", "sig.npy", "rate_cpu.npy")}
    demo.save(paths["model.npz"])
    np.save(paths["sig.npy"], np.asarray(frames))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    code = _CPU_RATES.format(repo=REPO, model=paths["model.npz"], sig=paths["sig.npy"],
                             out=paths["rate_cpu.npy"])
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                       text=True, timeout=900)
    if r.returncode != 0:
        raise RuntimeError(f"CPU reference process failed:\n{r.stderr[-3000:]}")
    cpu = np.load(paths["rate_cpu.npy"])
    doa_cpu, rate_cpu = cpu[:, 0], cpu[:, 1:]
    rate = np.asarray(rate, np.float32)
    rel = np.linalg.norm(rate - rate_cpu, axis=-1) / np.maximum(
        np.linalg.norm(rate_cpu, axis=-1), 1e-9)
    step = 2 * np.pi / (GRID - 1)
    ddoa = folded_deg(doa, doa_cpu) / np.rad2deg(step)
    log("c", f"vs CPU backend ({time.perf_counter() - t0:.0f} s): rate profile max "
             f"relative distance {rel.max():.4f} (tol {RATE_REL_TOL}); matched DoA max "
             f"offset {ddoa.max():.2f} grid steps (tol 1)")
    if rel.max() >= RATE_REL_TOL or ddoa.max() > 1 + 1e-3:
        raise AssertionError("flagship results differ from the CPU backend")


# ------------------------------------------------------------ (d) streaming
def phase_streaming(demo, doas):
    import jax

    from haghighatshoarmuir2024.ops.pallas.lif_kernel import _scan_counts
    from haghighatshoarmuir2024.runtime import StreamingLocalizer

    n_chunks = 4
    Tc = int(FRAME * FS)
    audio = make_audio(demo, doas, n_chunks * FRAME, seed=1)  # (B, 4·Tc, 7)
    sl = StreamingLocalizer(demo)
    state = sl.init_state(batch=BATCH)
    spikes = []
    t0 = time.perf_counter()
    for k in range(n_chunks):
        state, sp = sl.process_chunk(state, audio[:, k * Tc:(k + 1) * Tc])
        spikes.append(sp)
    jax.block_until_ready(state)
    first_s = time.perf_counter() - t0
    # the serving form (no spike raster) is its own program: compile it on
    # a throw-away state, then time the 4 chunks
    st2 = sl.init_state(batch=BATCH)
    jax.block_until_ready(sl.process_chunk(st2, audio[:, :Tc], return_spikes=False))
    t0 = time.perf_counter()
    for k in range(n_chunks):
        st2 = sl.process_chunk(st2, audio[:, k * Tc:(k + 1) * Tc], return_spikes=False)
    jax.block_until_ready(st2)
    step_ms = (time.perf_counter() - t0) / n_chunks * 1e3
    log("d", f"batched serving step over {BATCH} streams: {step_ms:.3f} ms per {FRAME} s "
             f"chunk (the first {n_chunks} chunks with spikes, incl. compile: {first_s:.1f} s)")

    stream = np.concatenate([np.asarray(s) for s in spikes], axis=0)  # (T, B, 2C)
    cfg = demo.xylo_config
    z = np.zeros((BATCH, cfg.n_hidden), np.int32)
    ref = jax.jit(lambda s, z: _scan_counts(cfg, s, z, z, z, 0))(stream, z)[0]
    if not np.array_equal(np.asarray(state.counts), np.asarray(ref)):
        raise AssertionError("streamed LIF counts differ from the simulator")
    log("d", f"carried LIF counts == simulator on the streamed spikes, all {BATCH} streams")

    P, settle = sl.pending, 10 * sl.K
    worst = total = 0
    for b in range(BATCH):
        offline = np.asarray(demo.spike_encoding(audio[b]))
        a = stream[P:, b]
        mism = np.flatnonzero(np.any(a[settle:] != offline[: a.shape[0]][settle:], axis=1))
        worst = max(worst, mism.size)
        total += mism.size
    n_cmp = stream.shape[0] - P - settle
    log("d", f"decided spikes vs offline encoder after the {settle}-sample start-up "
             f"transient: {total} mismatching timesteps over {BATCH} streams, worst "
             f"stream {worst} of {n_cmp} (tol {STREAM_MISMATCH_FRAC:g} = "
             f"{int(STREAM_MISMATCH_FRAC * n_cmp)})")
    if worst > STREAM_MISMATCH_FRAC * n_cmp:
        raise AssertionError("streamed spikes differ from the offline encoder")
    est = np.asarray(sl.estimate_doa(state, method="matched"))
    err = folded_deg(est, doas)
    log("d", f"streamed matched DoA: max error {err.max():.2f}°")
    if not np.all(err < GATE_DEG):
        raise AssertionError("a streamed DoA missed the 5° gate")


# --------------------------------------------------------------- (e) served
def phase_served(demo):
    from haghighatshoarmuir2024.runtime.native_client import NativeStreamClient
    from haghighatshoarmuir2024.runtime.server import LocalizationServer

    n_clients, n_chunks = 4, 4
    Tc = int(FRAME * FS)
    truth = np.array([-2.4, -0.8, 0.9, 2.2])
    audio = np.asarray(make_audio(demo, truth, n_chunks * FRAME, seed=2))
    got = np.full((n_chunks, n_clients), np.nan)
    t0 = time.perf_counter()
    with LocalizationServer(demo, max_streams=BATCH, chunk_sec=FRAME) as srv:
        srv.start()
        clients = [NativeStreamClient(srv.port, sid) for sid in range(n_clients)]
        try:
            for k in range(n_chunks):
                for sid, c in enumerate(clients):
                    c.send(audio[sid, k * Tc:(k + 1) * Tc])
                for sid, c in enumerate(clients):
                    rid, doa = c.recv_doa(timeout=600.0)
                    if rid != sid:
                        raise AssertionError(f"answer for stream {rid} on stream {sid}")
                    got[k, sid] = doa
        finally:
            for c in clients:
                c.close()
    err = folded_deg(got[-1], truth)
    log("e", f"daemon on localhost:{srv.port} ({srv.method}, {BATCH} slots), "
             f"{n_clients} native clients x {n_chunks} chunks in "
             f"{time.perf_counter() - t0:.1f} s; last DoA errors "
             f"{np.round(err, 2).tolist()}°")
    if not np.all(err < GATE_DEG):
        raise AssertionError("a served stream missed the 5° gate")


# -------------------------------------------------------------- (f) on-card
def phase_tests():
    import pytest

    rc = pytest.main(["-q", "-p", "no:cacheprovider", "-m", "gpu",
                      os.path.join(REPO, "tests_gpu")])
    log("f", f"tests_gpu exit code {int(rc)}")
    if rc != 0:
        raise AssertionError("tests_gpu failed")


# ----------------------------------------------------------- --four paths
def phase_four(demo, doas):
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from haghighatshoarmuir2024.parallel import make_mesh, make_trial_fn, monte_carlo_sweep
    from haghighatshoarmuir2024.runtime import StreamingLocalizer

    mesh = make_mesh(4, (4, 1))
    sh = NamedSharding(mesh, P("data"))
    Tc = int(FRAME * FS)
    audio = make_audio(demo, doas, 4 * FRAME, seed=3)
    sl = StreamingLocalizer(demo)
    one = sl.init_state(batch=BATCH)
    four = jax.device_put(sl.init_state(batch=BATCH), sh)
    step4 = sl.make_sharded_step(mesh)
    t1 = t4 = 0.0
    for k in range(4):
        chunk = audio[:, k * Tc:(k + 1) * Tc]
        t0 = time.perf_counter()
        one = jax.block_until_ready(sl.process_chunk(one, chunk, return_spikes=False))
        t1 += time.perf_counter() - t0
        t0 = time.perf_counter()
        four = jax.block_until_ready(step4(four, jax.device_put(chunk, sh)))
        t4 += time.perf_counter() - t0
    log("4", f"serving step, {BATCH} streams x 4 chunks: one device {t1:.1f} s, "
             f"four devices {t4:.1f} s (both incl. compile)")
    worst = 0.0
    for name in one._fields:
        a, b = np.asarray(getattr(one, name)), np.asarray(getattr(four, name))
        if a.dtype.kind in "iu":
            if not np.array_equal(a, b):
                raise AssertionError(f"sharded serving state {name} differs")
        else:
            worst = max(worst, float(np.max(np.abs(a - b), initial=0.0)))
    log("4", f"sharded serving state == one device: integer fields (LIF state, counts, "
             f"steps) identical; float fields max |diff| {worst:.3g}")
    if worst > 1e-5:
        raise AssertionError("sharded serving float state differs beyond 1e-5")

    t = np.arange(0, FRAME, 1 / FS)
    fwd = demo._forward_matched_jit
    trial = make_trial_fn(demo.geometry, t, np.sin(2 * np.pi * 1750 * t),
                          lambda s: fwd(s)[0], FS)
    key = jax.random.PRNGKey(0)
    kw = dict(snr_db_vec=[0.0, 10.0], num_sims=32, key=key)
    r1 = monte_carlo_sweep(trial, **kw)
    r4 = monte_carlo_sweep(trial, mesh=mesh, **kw)
    same = np.array_equal(r1["errors"], r4["errors"])
    log("4", f"Monte-Carlo sweep 2 SNR x 32 trials: MAE one device "
             f"{np.rad2deg(r1['mae']).round(3).tolist()}°, four devices "
             f"{np.rad2deg(r4['mae']).round(3).tolist()}°; per-trial errors identical: {same}")
    if not same:
        raise AssertionError("sharded Monte-Carlo sweep differs from the unsharded one")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU paths and what they are compared with")
    args = ap.parse_args()

    kind, count = phase_device(4 if args.four else 1)
    sys.path.insert(0, REPO)
    t0 = time.perf_counter()
    demo = flagship_demo()
    doas = np.linspace(-np.pi, np.pi, BATCH, endpoint=False)
    log("setup", f"flagship Demo with bundled design and calibration in "
                 f"{time.perf_counter() - t0:.1f} s")
    if args.four:
        phase_four(demo, doas)
    else:
        frames = make_audio(demo, doas, FRAME, seed=0)
        phase_kernels(demo, frames)
        phase_flagship(demo, frames, doas, kind)
        phase_streaming(demo, doas)
        phase_served(demo)
        phase_tests()
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))


if __name__ == "__main__":
    main()
