"""Serving daemon: N concurrent audio streams in, DoA estimates out.

The reference's closest analogue is the live demo loop — one sox capture at
a time, re-entering Python per frame, plotting the result
(micloc/xylo_snn_localization.py:446-542, micloc/record.py:54-60).  This is
its production-shaped twin: a native C++ ingestion daemon
(native/streamd.cpp, bound via ctypes) accepts TCP audio streams into
per-stream ring buffers on reader threads, and one Python loop advances ALL
live streams by one carried-state chunk per device launch
(runtime.StreamingLocalizer's batched serving step) and routes each stream's
DoA estimate back over its socket.

Key serving semantics:
  * at most one chunk per stream per step (the carried state advances
    exactly one chunk at a time); streams with nothing pending keep their
    state frozen (masked merge) — silence is NOT synthesized for idle slots;
  * a (re)claimed stream slot has its carried state zeroed before its first
    chunk (the daemon reports such slots through ``sd_take_resets``);
  * the device step runs at the full batch width every time — idle lanes
    compute on stale data and are masked out, which costs nothing extra on
    the device (the batched program is one fixed shape, compiled once).
"""
from __future__ import annotations

import ctypes
import os
import socket
import struct
import subprocess
import threading

import numpy as np
import jax
import jax.numpy as jnp

from .streaming import StreamingLocalizer

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SRC = os.path.join(_REPO_ROOT, "native", "streamd.cpp")
_BUILD_DIR = os.path.join(_REPO_ROOT, "native", "build")
_SO = os.path.join(_BUILD_DIR, "libstreamd.so")

_lock = threading.Lock()
_lib = None


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if not os.path.exists(_SO) or os.path.getmtime(_SO) < os.path.getmtime(_SRC):
            os.makedirs(_BUILD_DIR, exist_ok=True)
            subprocess.run(
                ["g++", "-O2", "-shared", "-fPIC", "-o", _SO, _SRC, "-pthread"],
                check=True,
                capture_output=True,
            )
        lib = ctypes.CDLL(_SO)
        u32p = ctypes.POINTER(ctypes.c_uint32)
        f32p = ctypes.POINTER(ctypes.c_float)
        lib.sd_start.argtypes = [ctypes.c_uint16, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32]
        lib.sd_start.restype = ctypes.c_void_p
        lib.sd_port.argtypes = [ctypes.c_void_p]
        lib.sd_port.restype = ctypes.c_int
        lib.sd_next_batch.argtypes = [ctypes.c_void_p, ctypes.c_uint32, ctypes.c_uint32, u32p, ctypes.c_void_p]
        lib.sd_next_batch.restype = ctypes.c_int
        lib.sd_next_batch_r.argtypes = [
            ctypes.c_void_p, ctypes.c_uint32, ctypes.c_uint32, u32p,
            ctypes.c_void_p, u32p, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
        ]
        lib.sd_next_batch_r.restype = ctypes.c_int
        lib.sd_take_resets.argtypes = [ctypes.c_void_p, u32p, ctypes.c_int]
        lib.sd_take_resets.restype = ctypes.c_int
        lib.sd_post_results.argtypes = [ctypes.c_void_p, ctypes.c_uint32, u32p, f32p]
        lib.sd_post_results.restype = None
        lib.sd_set_window.argtypes = [ctypes.c_void_p, ctypes.c_uint32]
        lib.sd_set_window.restype = None
        lib.sd_set_sources.argtypes = [ctypes.c_void_p, ctypes.c_uint32]
        lib.sd_set_sources.restype = None
        lib.sd_shm_attach.argtypes = [ctypes.c_void_p, ctypes.c_uint32, ctypes.c_char_p]
        lib.sd_shm_attach.restype = ctypes.c_int
        lib.sd_shm_detach.argtypes = [ctypes.c_void_p, ctypes.c_uint32]
        lib.sd_shm_detach.restype = ctypes.c_int
        lib.sd_stop.argtypes = [ctypes.c_void_p]
        lib.sd_stop.restype = None
        _lib = lib
        return lib


class LocalizationServer:
    """TCP serving front-end around :class:`StreamingLocalizer`.

    One instance owns ``max_streams`` stream slots; clients claim a slot id
    and stream PCM (float32, or int16 with ``wire_dtype="i16"`` — half the
    socket and host→device bytes); the server answers with the running DoA
    estimate after every processed chunk.

    Pass ``mesh`` (a ``jax.sharding.Mesh``) to serve over multiple chips:
    every device program — ingest, reset, the fused serve step — is
    shard_mapped with the stream axis split over ``mesh_axis`` (pure data
    parallel, zero collectives; streams are independent).  Validated on the
    virtual 8-device mesh in tests/test_server.py.
    """

    def __init__(self, demo, max_streams: int = 64, chunk_sec: float = 0.25,
                 port: int = 0, method: str | None = None,
                 batch_window_ms: int = 10, wire_dtype: str = "f32",
                 wire_upsample: int = 1, mesh=None, mesh_axis: str = "data",
                 forget: float | None = None, track: bool = False,
                 track_alpha: float = 0.35, track_gate_deg: float = 25.0,
                 sources: int = 1, source_min_sep_deg: float = 20.0,
                 source_rel_height: float = 0.2):
        self.sl = StreamingLocalizer(demo)
        self.demo = demo
        self.B = int(max_streams)
        self.Tc = int(round(chunk_sec * demo.fs))
        self.M = len(demo.geometry)
        self.method = method or (
            "matched" if getattr(demo, "_profiles", None) is not None else "peak"
        )
        if self.method in ("matched_stacked", "matched_auto") and getattr(
            demo, "_profiles_stacked", None
        ) is None:
            raise ValueError(
                f"method={self.method!r} needs "
                "demo.calibrate_profiles(band_stacked=True)"
            )
        if wire_dtype not in ("f32", "i16", "u8", "u4"):
            raise ValueError("wire_dtype must be 'f32', 'i16', 'u8' or 'u4'")
        # multi-source serving: every result frame carries K
        # DoA floats (u32 id + f32[K], NaN-padded) — the daemon config is the
        # single source of truth for the frame size, mirrored by
        # sd_set_sources on the native side and `sources=` on the clients.
        if not (1 <= int(sources) <= 8):
            raise ValueError("sources must be in [1, 8]")
        self.K = int(sources)
        # peak-picker knobs for K > 1: two reported sources must be at least
        # source_min_sep_deg apart (otherwise the second result slot lands on
        # a sidelobe of the first source's beam response — measured on the
        # 65-point grid where the default scipy-style distance allowed
        # 11.25-deg neighbors), and below source_rel_height * max the peak
        # is treated as noise
        self.source_min_sep_deg = float(source_min_sep_deg)
        self.source_rel_height = float(source_rel_height)
        if wire_upsample not in (1, 4):
            raise ValueError("wire_upsample must be 1 or 4")
        if wire_upsample > 1 and abs(float(demo.fs) - 48_000.0) > 1e-6:
            # the anti-alias/reconstruction prototype's cutoff is a FRACTION
            # of the internal rate (ops/resample.design_upsample_fir:
            # 0.09375·fs = 4.5 kHz at 48 k) — at the 24 kHz reduced-rate mode
            # it would fall to 2.25 kHz, INSIDE the 2.0–2.6 kHz reference
            # bands, silently attenuating them on the wire
            raise ValueError(
                "wire_upsample>1 assumes the 48 kHz internal rate; for the "
                "24 kHz reduced-rate mode use wire_dtype i16/u8/u4 at the "
                "native rate instead"
            )
        # Compressed wire formats cut socket AND host->device bytes (the
        # pipeline is amplitude-scale-invariant: linear front-end, extrema
        # spike decisions, binary spikes into the integer SNN):
        #   i16 — PCM16, exact vs production audio (which is int16 anyway);
        #   u8  — mu-law companded (ops/mulaw.py), ~27 dB per-sample SNR,
        #         half of i16 again;
        #   u4  — 4-bit mu-law, two codes per byte (ops/mulaw.py pack4),
        #         half of u8 again (~23 dB in-band after the bandpass).
        # wire_upsample=4 additionally ships audio at fs/4 (12 kHz — the
        # 1.6-2.6 kHz bands are ~9x oversampled at 48 kHz) and reconstructs
        # the 48 kHz stream ON DEVICE with a carried-state polyphase FIR
        # (ops/resample.py), so the pipeline itself still runs at the
        # reference rate.  Encode client-side with :func:`encode_wire`.
        # On a transport-bound host, wire bytes are throughput — see the
        # landmine note in _build_jits.  u4 + upsample: 16x less than f32.
        self.wire_dtype = wire_dtype
        self.wire_upsample = int(wire_upsample)
        if self.Tc % self.wire_upsample:
            raise ValueError("chunk samples must divide by wire_upsample")
        self.Tw = self.Tc // self.wire_upsample  # wire-rate samples/chunk
        np_dt, elem = {
            "f32": (np.float32, 4), "i16": (np.int16, 2),
            "u8": (np.uint8, 1), "u4": (np.uint8, 1),
        }[wire_dtype]
        if wire_dtype == "u4":
            if self.Tw % 2:
                raise ValueError("u4 wire needs an even wire-rate chunk")
            self.Tb = self.Tw // 2  # two codes per byte along time
        else:
            self.Tb = self.Tw
        self._lib = _load()
        self._h = self._lib.sd_start(port, self.B, self.Tb, self.M, elem)
        if not self._h:
            raise OSError("streamd: failed to bind server socket")
        self._lib.sd_set_window(self._h, batch_window_ms)
        if self.K > 1:
            self._lib.sd_set_sources(self._h, self.K)
        self.port = self._lib.sd_port(self._h)
        self._stop = threading.Event()
        self._thread = None

        self._ids_buf = (ctypes.c_uint32 * self.B)()
        self._reset_buf = (ctypes.c_uint32 * self.B)()
        self._n_resets = ctypes.c_int(0)
        self._data_buf = np.zeros((self.B, self.Tb, self.M), np_dt)
        # opt-in per-stage timing (HM2024_SERVE_TIMING=1): cumulative seconds
        # per step() stage, for attributing end-to-end serving wall time
        self.stage_times = {"wait": 0.0, "device": 0.0, "route": 0.0, "steps": 0}
        self._timing = os.environ.get("HM2024_SERVE_TIMING") in ("1", "2")
        # opt-in per-stream DoA tracking (utils/tracking.py): each slot
        # carries a wrapped-angle alpha-beta tracker over its chunk
        # estimates; gross single-chunk outliers coast instead of reaching
        # the client.  Host-side (n<=B scalar updates per step, ~us) so the
        # device program is unchanged; reset claims re-bootstrap the slot.
        self._trackers = None
        if track:
            if self.K > 1:
                # per-slot gated GNN multi-target tracker (utils/tracking.py,
                # the CLI's --sources path): K+2 track slots absorb spurious
                # peaks; confirmed tracks fill the K result slots, NaN-padded
                from ..utils.tracking import MultiDoaTracker

                self._trackers = [
                    MultiDoaTracker(
                        num_tracks=self.K + 2, alpha=track_alpha,
                        gate_deg=track_gate_deg, max_misses=4,
                    )
                    for _ in range(self.B)
                ]
            else:
                from ..utils.tracking import DoaTracker

                self._trackers = [
                    DoaTracker(alpha=track_alpha, gate_deg=track_gate_deg)
                    for _ in range(self.B)
                ]
        # multi-chip serving: shard the stream axis of every device program
        # over `mesh` (pure data parallel — streams are independent, zero
        # collectives; see StreamingLocalizer.make_sharded_step).  The stream
        # count must divide the mesh axis.
        self.mesh = mesh
        self.mesh_axis = mesh_axis
        if mesh is not None and self.B % int(mesh.shape[mesh_axis]):
            raise ValueError("max_streams must divide the mesh axis size")
        # moving-source tracking: `forget` in [0, 1) makes the DoA answer
        # follow an exponentially-forgotten spike-count profile
        # (ema' = forget * ema + chunk_counts) instead of the all-history
        # cumulative counts, so a source that MOVES mid-stream is tracked
        # with an effective window of ~chunk/(1-forget) seconds.  The
        # carried SNN/encode state is untouched — only the estimator's
        # evidence window changes.  None (default) = reference-shaped
        # cumulative behavior.
        if forget is not None and not (0.0 <= float(forget) < 1.0):
            raise ValueError("forget must be in [0, 1)")
        self.forget = None if forget is None else float(forget)
        self._state = self.sl.init_state(batch=self.B)
        self._ema = None
        if self.forget is not None:
            n_hidden = self._state.counts.shape[-1]
            self._ema = jnp.zeros((self.B, n_hidden), jnp.float32)
        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P

            self._stream_sharding = NamedSharding(mesh, P(mesh_axis))
            self._state = jax.device_put(self._state, self._stream_sharding)
            if self._ema is not None:
                self._ema = jax.device_put(self._ema, self._stream_sharding)
        self._build_jits()

    def _wrap_streams(self, fn, n_stream_args, n_repl_args=0, out_streams=1):
        """jit `fn`; under a mesh, shard_map it with the first
        ``n_stream_args`` args (pytrees) split on the stream axis and the
        next ``n_repl_args`` replicated.  All outputs are stream-sharded."""
        if self.mesh is None:
            return jax.jit(fn)
        from jax.sharding import PartitionSpec as P

        specs_in = (P(self.mesh_axis),) * n_stream_args + (P(),) * n_repl_args
        specs_out = (
            P(self.mesh_axis) if out_streams == 1 else (P(self.mesh_axis),) * out_streams
        )
        return jax.jit(
            jax.shard_map(fn, mesh=self.mesh, in_specs=specs_in,
                          out_specs=specs_out)
        )

    # ---- jitted helpers -------------------------------------------------
    def _build_jits(self):
        # Host<->device traffic per step: the wire-format chunk buffer up
        # (compressed formats are decoded on device by a table gather in
        # the ingest program, ops/mulaw.py) and the (B,) DoA vector down;
        # dispatches per step are minimized (ingest + one fused
        # reset/step/merge/estimate program + one small readback).  Closures
        # stay numpy and profiles/grid are uploaded as ARGUMENTS, so the
        # lowered programs carry no device literals.
        num_DoA = len(self.demo.doa_list)
        fs = self.demo.fs
        self._dl_dev = jax.device_put(np.asarray(self.demo.doa_list, np.float32))
        # matched_stacked scores the UNFOLDED (B, F*G) rates against the
        # G x (F*G) stacked table (multi-band; see pipeline.calibrate_profiles)
        # — the serving state's counts are unfolded already, so this is the
        # natural home for it.  "matched" keeps the reference-folded profile.
        stacked = self.method == "matched_stacked"
        auto = self.method == "matched_auto"
        profiles = getattr(
            self.demo,
            "_profiles_stacked" if (stacked or auto) else "_profiles",
            None,
        )
        prof_w = (
            num_DoA if profiles is None
            else int(np.asarray(profiles).shape[-1])
        )
        if profiles is None:
            prof_np = np.zeros((prof_w, num_DoA), np.float32)
        else:
            prof_np = np.asarray(profiles, np.float32)
            if auto:
                # matched_auto recomputes its block/folded normalizations
                # in-program from the raw (P, H) table — (P, H) work per step
                # is trivial next to the SNN step
                pass
            elif stacked:
                # pre-normalize each band block of every profile row (host
                # numpy — the serving path then only normalizes the measured
                # counts per step)
                pb = prof_np.reshape(prof_np.shape[0], -1, num_DoA)
                pb = pb - pb.mean(axis=-1, keepdims=True)
                nrm = np.linalg.norm(pb, axis=-1, keepdims=True)
                prof_np = (pb / np.maximum(nrm, 1e-12)).reshape(prof_np.shape)
            if not auto:
                prof_np = np.ascontiguousarray(prof_np.T)
        self._prof_dev = jax.device_put(prof_np)
        matched = (
            self.method in ("matched", "matched_stacked", "matched_auto")
            and profiles is not None
        )

        from ..ops.mulaw import mulaw4_decode_table, mulaw_decode_table
        from ..ops.resample import (
            TAPS_PER_PHASE,
            design_upsample_fir,
            phase_table,
            upsample_poly_stream,
        )

        wdt = self.wire_dtype
        # decode tables stay NUMPY closures: jit embeds them as literals
        tbl8 = mulaw_decode_table()
        tbl4 = mulaw4_decode_table()

        def decode(raw):
            """(B, Tb, M) wire buffer -> (B, Tw, M) float32 wire-rate audio."""
            if wdt == "i16":
                return raw.astype(jnp.float32) * (1.0 / 32768.0)
            if wdt == "u8":
                return jnp.asarray(tbl8)[raw.astype(jnp.int32)]
            if wdt == "u4":
                r = raw.astype(jnp.int32)
                hi = jnp.asarray(tbl4)[(r >> 4) & 0xF]
                lo = jnp.asarray(tbl4)[r & 0xF]
                x = jnp.stack([hi, lo], axis=2)  # (B, Tb, 2, M)
                return x.reshape(raw.shape[0], raw.shape[1] * 2, raw.shape[2])
            return raw.astype(jnp.float32)

        if self.wire_upsample > 1:
            # stateful ingest: decode, zero reset slots' filter history,
            # polyphase-interpolate back to 48 kHz, advance active slots'
            # carried history (idle lanes hold; see ops/resample.py)
            up = self.wire_upsample
            hp = phase_table(design_upsample_fir(up), up)  # numpy literal
            carry0_np = np.zeros((self.B, TAPS_PER_PHASE - 1, self.M), np.float32)
            if self.mesh is not None:
                self._wire_carry = jax.device_put(carry0_np, self._stream_sharding)
            else:
                self._wire_carry = jax.device_put(carry0_np)

            def ingest_up(raw, carry, activef, resetf):
                rm = (resetf > 0.5)[:, None, None]
                am = (activef > 0.5)[:, None, None]
                carry0 = jnp.where(rm, 0.0, carry)
                y, adv = upsample_poly_stream(decode(raw), carry0, hp, up)
                return y, jnp.where(am, adv, carry0)

            def reset_carry(carry, resetf):
                return jnp.where((resetf > 0.5)[:, None, None], 0.0, carry)

            self._ingest_up = self._wrap_streams(ingest_up, 4, out_streams=2)
            self._reset_carry = self._wrap_streams(reset_carry, 2)
            ingest = None
        else:
            self._wire_carry = None
            ingest = self._wrap_streams(decode, 1)

        def reset(state, resetf):
            # batch from the arg shape: under shard_map this body sees the
            # LOCAL per-device stream slice, not the global B
            zeros = self.sl.init_state(batch=resetf.shape[0])

            def sel(z, o):
                m = (resetf > 0.5).reshape((-1,) + (1,) * (z.ndim - 1))
                return jnp.where(m, z, o)

            return jax.tree.map(sel, zeros, state)

        reset = self._wrap_streams(reset, 2)

        from ..models.xylo.pipeline import _auto_blend_scores, _blockcos

        def _scores(r, prof_t):
            """(B, H) UNFOLDED rate-like evidence -> (B, G) DoA scores."""
            if matched and auto:
                # SNR-adaptive blend (pipeline._auto_blend_scores): prof_t is
                # the RAW (P, H) stacked table here (no host pre-normalize /
                # transpose — the blend derives its own normalizations)
                return _auto_blend_scores(r, prof_t, num_DoA)
            if matched and stacked:
                # per-band cosine scoring (see pipeline._blockcos): the
                # profile table arrives already block-normalized (below)
                rc = _blockcos(r, num_DoA)
                return jnp.matmul(
                    rc, prof_t, precision=jax.lax.Precision.HIGHEST
                )
            r = r.reshape(r.shape[:-1] + (-1, num_DoA)).mean(axis=-2)
            if matched:
                rc = r - jnp.mean(r, axis=-1, keepdims=True)
                # f32-exact scoring: a TF32 matmul can flip
                # near-tie argmaxes over the DoA grid (CLAUDE.md landmine);
                # off the hot path, cost is negligible.  Argmax over the
                # correlation is invariant to positive scaling of r, so the
                # cumulative rate and the forgetting EMA share this path.
                return jnp.matmul(
                    rc, prof_t, precision=jax.lax.Precision.HIGHEST
                )
            return r

        K = self.K

        def _estimate(r, dl, prof_t):
            """(B, H) evidence -> (B,) DoA, or (B, K) NaN-padded top-K peaks
            when serving multiple sources (same picker as the CLI's
            --sources path, tools/localize.py)."""
            scores = _scores(r, prof_t)
            if K == 1:
                return dl[jnp.argmax(scores, axis=-1)]
            from ..ops.peaks import top_k_peaks

            grid_step_deg = 360.0 / max(num_DoA - 1, 1)
            dist = max(int(round(self.source_min_sep_deg / grid_step_deg)), 1)
            idx, _, valid = jax.vmap(
                lambda s: top_k_peaks(
                    s, K, distance=dist, rel_height=self.source_rel_height
                )
            )(scores)
            return jnp.where(valid, dl[idx], jnp.nan)

        def doas_impl(state, dl, prof_t):
            steps = jnp.maximum(state.steps, 1)
            r = state.counts.astype(jnp.float32) / steps[..., None] * fs
            return _estimate(r, dl, prof_t)

        step_fn = self.sl._step_jit_batched_nospikes

        # ONE fused program for zero-reclaimed-slots -> advance all streams
        # -> masked-merge -> estimate; chunks arrive DEVICE-RESIDENT from
        # the ingest program, so this program never touches the host.  Under
        # a mesh the whole program is shard_mapped on the stream axis (the
        # estimator's profile matmul is replicated; everything else is
        # per-stream elementwise — zero collectives).
        def _advance(state, chunks, activef, resetf):
            zeros = self.sl.init_state(batch=resetf.shape[0])

            def selz(z, o):
                m = (resetf > 0.5).reshape((-1,) + (1,) * (z.ndim - 1))
                return jnp.where(m, z, o)

            state = jax.tree.map(selz, zeros, state)
            new_state = step_fn(state, chunks)

            def sel(nw, o):
                m = (activef > 0.5).reshape((-1,) + (1,) * (nw.ndim - 1))
                return jnp.where(m, nw, o)

            return state, jax.tree.map(sel, new_state, state)

        if self.forget is None:
            def serve_step(state, chunks, activef, resetf, dl, prof_t):
                _, state = _advance(state, chunks, activef, resetf)
                return state, doas_impl(state, dl, prof_t)

            serve_step = self._wrap_streams(serve_step, 4, n_repl_args=2,
                                            out_streams=2)
        else:
            gamma = self.forget

            def serve_step(state, ema, chunks, activef, resetf, dl, prof_t):
                prev, state = _advance(state, chunks, activef, resetf)
                ema = jnp.where((resetf > 0.5)[:, None], 0.0, ema)
                # per-chunk spike counts: the merged state already holds the
                # pre-advance counts for idle lanes, so chunk = new - prev(=0)
                chunk_counts = (state.counts - prev.counts).astype(jnp.float32)
                ema = jnp.where(
                    (activef > 0.5)[:, None], gamma * ema + chunk_counts, ema
                )
                return state, ema, _estimate(ema, dl, prof_t)

            serve_step = self._wrap_streams(serve_step, 5, n_repl_args=2,
                                            out_streams=3)
            self._reset_ema = self._wrap_streams(
                lambda e, rf: jnp.where((rf > 0.5)[:, None], 0.0, e), 2
            )
        self._ingest, self._reset, self._serve_step = ingest, reset, serve_step

    # ---- serving loop ---------------------------------------------------
    def step(self, timeout_ms: int = 100) -> int:
        """One serving step: drain ≤B ready chunks, advance those streams,
        answer them.  Returns the number of streams served."""
        # Chunks and pending resets are drained ATOMICALLY (one daemon mutex
        # hold, sd_next_batch_r): a claim clears the slot's queued data under
        # that same mutex, so every returned chunk was ingested after the
        # most recent claim of its slot.  Zero reset slots' carried state
        # FIRST, then process all returned chunks — a new claimant's first
        # chunk runs against fresh state, and a dead predecessor's chunk can
        # never reach the successor's state (or vice versa).
        import time as _time

        t0 = _time.monotonic() if self._timing else 0.0
        n = self._lib.sd_next_batch_r(
            self._h, self.B, timeout_ms, self._ids_buf,
            self._data_buf.ctypes.data_as(ctypes.c_void_p),
            self._reset_buf, self.B, ctypes.byref(self._n_resets),
        )
        t1 = _time.monotonic() if self._timing else 0.0
        n_reset = self._n_resets.value
        reset_mask = np.zeros(self.B, np.float32)
        if n_reset > 0:
            reset_slots = np.ctypeslib.as_array(self._reset_buf)[:n_reset]
            reset_mask[reset_slots] = 1.0
            if self._trackers is not None:
                for s in reset_slots:
                    self._trackers[int(s)].reset()
        if n <= 0:
            if n_reset > 0:
                self._state = self._reset(self._state, reset_mask)
                if self._wire_carry is not None:
                    self._wire_carry = self._reset_carry(
                        self._wire_carry, reset_mask
                    )
                if self._ema is not None:
                    self._ema = self._reset_ema(self._ema, reset_mask)
            if self._timing:
                self.stage_times["wait"] += t1 - t0
            return 0
        ids = np.ctypeslib.as_array(self._ids_buf)[:n].copy()
        active = np.zeros(self.B, np.float32)
        active[ids] = 1.0
        # the daemon wrote each chunk at row=stream_id of the persistent
        # buffer; inactive rows hold stale audio, computed on and masked
        # out.  Two launches: the trivial ingest uploads the raw buffer as
        # its jit argument (the fast transfer path — see _build_jits), then
        # the fused serve program runs entirely on device-resident data and
        # only the (B,) DoA vector comes back.
        if self._wire_carry is not None:
            chunks_dev, self._wire_carry = self._ingest_up(
                self._data_buf, self._wire_carry, active, reset_mask
            )
        else:
            chunks_dev = self._ingest(self._data_buf)
        if self._ema is not None:
            self._state, self._ema, doa_dev = self._serve_step(
                self._state, self._ema, chunks_dev, active, reset_mask,
                self._dl_dev, self._prof_dev,
            )
        else:
            self._state, doa_dev = self._serve_step(
                self._state, chunks_dev, active, reset_mask,
                self._dl_dev, self._prof_dev,
            )
        all_doas = np.asarray(doa_dev, np.float32)  # (B,) or (B, K)
        t2 = _time.monotonic() if self._timing else 0.0
        out_ids = (ctypes.c_uint32 * n)(*ids.tolist())
        if self.K == 1:
            if self._trackers is not None:
                out_vals = [
                    self._trackers[int(i)].update(float(all_doas[int(i)]))
                    for i in ids
                ]
            else:
                out_vals = all_doas[ids].tolist()
            out_doas = (ctypes.c_float * n)(*out_vals)
        else:
            # K-slot frames: confirmed tracks (or raw top-K peaks) per
            # served stream, NaN-padded to exactly K floats
            rows = np.full((n, self.K), np.nan, np.float32)
            for j, i in enumerate(ids):
                z = all_doas[int(i)]
                if self._trackers is not None:
                    thetas, confirmed = self._trackers[int(i)].update(
                        z, valid=np.isfinite(z)
                    )
                    conf = thetas[confirmed][: self.K]
                    rows[j, : conf.size] = conf
                else:
                    rows[j] = z
            out_doas = (ctypes.c_float * (n * self.K))(*rows.ravel().tolist())
        self._lib.sd_post_results(self._h, n, out_ids, out_doas)
        if self._timing:
            t3 = _time.monotonic()
            self.stage_times["wait"] += t1 - t0
            self.stage_times["device"] += t2 - t1
            self.stage_times["route"] += t3 - t2
            self.stage_times["steps"] += 1
        return n

    def attach_shm(self, stream_id: int, name: str) -> None:
        """Attach a co-located producer's shared-memory ring (created by
        :class:`ShmStreamClient`) to a stream slot.  Skips the socket + kernel
        copy tax of the TCP path: the producer memcpys into the ring and the
        compute loop memcpys straight out of it."""
        rc = self._lib.sd_shm_attach(self._h, stream_id, name.encode())
        if rc != 0:
            raise OSError(f"streamd: shm attach failed for slot {stream_id} ({name})")

    def detach_shm(self, stream_id: int) -> None:
        self._lib.sd_shm_detach(self._h, stream_id)

    def serve_forever(self):
        while not self._stop.is_set():
            self.step()

    def start(self):
        self._thread = threading.Thread(target=self.serve_forever, daemon=True)
        self._thread.start()
        return self

    def close(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        if self._h:
            self._lib.sd_stop(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def encode_wire(chunk: np.ndarray, wire_dtype: str = "f32",
                wire_upsample: int = 1) -> np.ndarray:
    """Client-side wire encode matching a server's (wire_dtype,
    wire_upsample) config: (T, M) float audio in [-1, 1] -> wire buffer.

    wire_upsample=4 decimates to fs/4 first (anti-aliased,
    ops/resample.py:decimate_fir); u8/u4 are mu-law companded (ops/mulaw.py),
    u4 packed two codes per byte along time.  T must divide by
    wire_upsample (and the wire-rate length must be even for u4).
    """
    from ..ops.mulaw import mulaw4_encode, mulaw_encode, pack4
    from ..ops.resample import decimate_fir

    x = np.asarray(chunk, np.float32)
    if wire_upsample > 1:
        x = decimate_fir(x, wire_upsample)
    if wire_dtype == "i16":
        return np.clip(x * 32767.0, -32768, 32767).astype(np.int16)
    if wire_dtype == "u8":
        return mulaw_encode(x)
    if wire_dtype == "u4":
        return pack4(mulaw4_encode(x))
    return x


class WireEncoder:
    """Stateful client-side encoder for STREAMING chunks.

    :func:`encode_wire` anti-alias-filters each chunk against zero history;
    for a continuous stream that injects a small transient at every chunk
    seam.  This class carries the filter history so chunked encoding equals
    encoding the concatenated stream exactly (the mirror of the server's
    carried-state polyphase ingest).  Chunk lengths must divide by
    ``wire_upsample`` (and the wire-rate length must be even for u4).
    """

    def __init__(self, wire_dtype: str = "f32", wire_upsample: int = 1):
        from ..ops.resample import design_upsample_fir

        self.wire_dtype = wire_dtype
        self.up = int(wire_upsample)
        if self.up > 1:
            self._h = (design_upsample_fir(self.up) / np.float32(self.up))
            self._carry = None  # (L-1, M), lazily shaped on first chunk

    def encode(self, chunk: np.ndarray) -> np.ndarray:
        from ..ops.mulaw import mulaw4_encode, mulaw_encode, pack4

        x = np.asarray(chunk, np.float32)
        if self.up > 1:
            L = self._h.size
            if self._carry is None:
                self._carry = np.zeros((L - 1,) + x.shape[1:], np.float32)
            ext = np.concatenate([self._carry, x], axis=0)
            self._carry = ext[-(L - 1):].copy()
            flat = ext.reshape(ext.shape[0], -1)
            out = np.empty((x.shape[0], flat.shape[1]), np.float32)
            for c in range(flat.shape[1]):
                out[:, c] = np.convolve(flat[:, c], self._h, mode="valid")
            x = out.reshape((x.shape[0],) + x.shape[1:])[:: self.up]
        if self.wire_dtype == "i16":
            return np.clip(x * 32767.0, -32768, 32767).astype(np.int16)
        if self.wire_dtype == "u8":
            return mulaw_encode(x)
        if self.wire_dtype == "u4":
            return pack4(mulaw4_encode(x))
        return x


class StreamClient:
    """Minimal client for :class:`LocalizationServer` (tests / demos).

    ``sources`` must match the server's config: the result frame is a fixed
    ``u32 id + f32[K]`` record (NaN-padded), so a mismatched K desyncs the
    client's framing.
    """

    def __init__(self, port: int, stream_id: int, host: str = "127.0.0.1",
                 sources: int = 1):
        self.K = int(sources)
        self.sock = socket.create_connection((host, port))
        self.sock.sendall(struct.pack("<II", 0x484D3234, stream_id))

    def send(self, chunk: np.ndarray):
        """Send a (T, M) block (any T; the daemon re-chunks).  The dtype
        must match the server's ``wire_dtype``: float32, int16 PCM, or
        mu-law uint8 (encode with :func:`ops.mulaw.mulaw_encode`)."""
        data = np.ascontiguousarray(chunk)
        if data.dtype not in (np.float32, np.int16, np.uint8):
            data = data.astype(np.float32)
        self.sock.sendall(struct.pack("<I", data.size) + data.tobytes())

    def recv_doa(self, timeout: float = 30.0):
        """Next result: (stream_id, doa) for K=1 servers, or
        (stream_id, np.ndarray (K,)) with NaN padding for multi-source."""
        self.sock.settimeout(timeout)
        want = 4 + 4 * self.K
        buf = b""
        while len(buf) < want:
            part = self.sock.recv(want - len(buf))
            if not part:
                raise ConnectionError("server closed")
            buf += part
        sid = struct.unpack_from("<I", buf)[0]
        doas = np.frombuffer(buf, np.float32, count=self.K, offset=4)
        if self.K == 1:
            return sid, float(doas[0])
        return sid, doas.copy()

    def close(self):
        self.sock.close()


class ShmStreamClient:
    """Shared-memory producer for a co-located :class:`LocalizationServer`.

    Creates a single-producer/single-consumer byte ring under ``/dev/shm``
    (layout documented in native/streamd.cpp) and streams audio with plain
    memcpy — no sockets, no kernel copies, no per-chunk syscalls.  Attach it
    server-side with ``server.attach_shm(stream_id, client.name)``.

    Note: position publication relies on the host's total-store-order
    (x86) / naturally-aligned-store atomicity; the data bytes are written
    before the position field in program order.
    """

    MAGIC = 0x484D5348  # "HMSH"
    HDR = 64

    def __init__(self, name: str, capacity_bytes: int = 1 << 22):
        import mmap as mmap_mod

        self.name = name
        self.path = "/dev/shm/" + name
        self.cap = int(capacity_bytes)
        self._f = open(self.path, "w+b")
        self._f.truncate(self.HDR + self.cap)
        self.mm = mmap_mod.mmap(self._f.fileno(), self.HDR + self.cap)
        self.mm[: self.HDR] = b"\x00" * self.HDR
        struct.pack_into("<I", self.mm, 4, self.cap)
        struct.pack_into("<I", self.mm, 0, self.MAGIC)  # magic last: ring valid
        self._last_seq = 0

    def _write_pos(self):
        return struct.unpack_from("<Q", self.mm, 8)[0]

    def _read_pos(self):
        return struct.unpack_from("<Q", self.mm, 16)[0]

    def send(self, chunk: np.ndarray, timeout: float = 30.0):
        """Append a (T, M) block (dtype must match the server's wire_dtype).
        Blocks (sleep-polls) while the ring is full — natural backpressure."""
        import time

        data = np.ascontiguousarray(chunk).tobytes()
        n = len(data)
        off = 0
        deadline = time.monotonic() + timeout
        while off < n:
            wp = self._write_pos()
            free = self.cap - (wp - self._read_pos())
            if free == 0:
                if time.monotonic() > deadline:
                    raise TimeoutError("shm ring full: consumer not draining")
                time.sleep(0.0002)
                continue
            take = min(free, n - off)
            idx = int(wp % self.cap)
            first = min(take, self.cap - idx)
            self.mm[self.HDR + idx : self.HDR + idx + first] = data[off : off + first]
            if first < take:
                self.mm[self.HDR : self.HDR + take - first] = data[
                    off + first : off + take
                ]
            struct.pack_into("<Q", self.mm, 8, wp + take)
            off += take

    def recv_doa(self, timeout: float = 30.0, sources: int = 1):
        """Latest DoA result (seq-tagged slot; each result supersedes the
        last).  Returns the radians value once a NEW result is posted; with
        ``sources=K`` > 1, a (K,) NaN-padded array (slot 0 at offset 28,
        slots 1..K-1 at 36+4(k-1) — see native/streamd.cpp)."""
        import time

        deadline = time.monotonic() + timeout
        while True:
            seq = struct.unpack_from("<I", self.mm, 24)[0]
            if seq != self._last_seq:
                self._last_seq = seq
                if sources == 1:
                    return struct.unpack_from("<f", self.mm, 28)[0]
                out = np.empty(sources, np.float32)
                out[0] = struct.unpack_from("<f", self.mm, 28)[0]
                for k in range(1, sources):
                    out[k] = struct.unpack_from("<f", self.mm, 36 + 4 * (k - 1))[0]
                return out
            if time.monotonic() > deadline:
                raise TimeoutError("no shm result")
            time.sleep(0.0002)

    def close(self, unlink: bool = True):
        self.mm.close()
        self._f.close()
        if unlink:
            try:
                os.unlink(self.path)
            except OSError:
                pass
