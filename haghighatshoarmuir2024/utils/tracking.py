"""Wrapped-angle DoA tracking (beyond reference parity).

The reference has no temporal filtering at all: its moving-target harness
(`/root/reference/micloc/tests/test_snn_hilbert_localization.py:224-334`)
scores raw per-frame argmax estimates, and its only smoother is the
amplitude Envelope follower.  Production localization wants a tracker: the
per-frame estimators here emit one DoA every `frame` seconds with occasional
gross outliers (wrong lobe, low-SNR frames), and the target moves slowly
against the frame rate.

This module provides an alpha-beta tracker ON THE CIRCLE:

* state is (theta, omega) — angle and angular rate;
* the innovation is the WRAPPED difference
  ``delta = atan2(sin(z - theta_pred), cos(z - theta_pred))`` so a target
  crossing the ±pi seam tracks through it instead of snapping 360 degrees;
* measurements whose innovation exceeds ``gate_rad`` are treated as
  outliers: the tracker coasts on its own prediction (no update) and counts
  consecutive misses; after ``max_misses`` of them it re-acquires by
  snapping to the measurement (a real maneuver, not noise);
* the step is a pure function, so the batch API runs under ``lax.scan``
  inside jit — one compiled program tracks a whole recording, and ``vmap``
  tracks many streams at once.  Accelerator-first: no data-dependent Python control
  flow, static shapes, float32 throughout.

Tuning: alpha/beta follow the critically-damped alpha-beta relation
``beta = alpha**2 / (2 - alpha)``; ``DoaTracker(alpha=0.35)`` tracks a
120 deg/4 s sweep at 4 Hz frames with ~1 frame of lag while rejecting
single-frame outliers beyond the 25 deg gate.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import jax
import jax.numpy as jnp

__all__ = ["TrackState", "track_step", "track_angles", "DoaTracker"]


class TrackState(NamedTuple):
    """Tracker carry: wrapped angle, angular rate [rad/frame], consecutive
    gated-out measurements, and an init counter (0 = empty, 1 = have theta,
    2 = tracking).  The two-point bootstrap matters: starting omega at zero
    makes an alpha-beta filter lag a constant-rate target for ~1/beta
    frames (measured: it DOUBLED the moving-target error at 4 Hz frames),
    so the second inlier sets omega = wrapped(z - theta) directly."""

    theta: jnp.ndarray
    omega: jnp.ndarray
    misses: jnp.ndarray
    initialized: jnp.ndarray


def _wrap(x):
    return jnp.arctan2(jnp.sin(x), jnp.cos(x))


def track_step(
    state: TrackState,
    z,
    alpha: float = 0.35,
    beta: Optional[float] = None,
    gate_rad: float = np.deg2rad(25.0),
    max_misses: int = 3,
):
    """One predict/gate/update on the circle.  Pure; scan/vmap-friendly.

    Returns ``(next_state, theta_filtered)``.
    """
    if beta is None:
        beta = alpha * alpha / (2.0 - alpha)
    z = jnp.asarray(z, jnp.float32)

    theta_pred = _wrap(state.theta + state.omega)
    delta = _wrap(z - theta_pred)
    inlier = jnp.abs(delta) <= gate_rad

    theta_upd = _wrap(theta_pred + alpha * delta)
    omega_upd = state.omega + beta * delta

    misses = jnp.where(inlier, 0, state.misses + 1)
    reacquire = misses > max_misses

    theta_next = jnp.where(
        reacquire, z, jnp.where(inlier, theta_upd, theta_pred)
    )
    omega_next = jnp.where(
        reacquire,
        jnp.zeros_like(state.omega),
        jnp.where(inlier, omega_upd, state.omega),
    )
    misses = jnp.where(reacquire, 0, misses)
    # a tracking-state machine in pure selects: 2 = steady alpha-beta,
    # re-acquisition drops back to 1 so the NEXT inlier re-derives omega
    init_next = jnp.where(reacquire, 1, state.initialized)

    # bootstrap step 2: the second measurement sets omega from the raw
    # difference, UNGATED — a fast target's second point may exceed the
    # gate, and an outlier here self-heals (the poisoned omega gates out
    # every later inlier until re-acquisition drops back to state 1)
    boot = state.initialized == 1
    theta_next = jnp.where(boot, z, theta_next)
    omega_next = jnp.where(boot, _wrap(z - state.theta), omega_next)
    init_next = jnp.where(boot, 2, init_next)

    # bootstrap step 1: first measurement initializes theta verbatim
    fresh = state.initialized == 0
    theta_next = jnp.where(fresh, z, theta_next)
    omega_next = jnp.where(fresh, jnp.zeros_like(omega_next), omega_next)
    misses = jnp.where(fresh | boot, 0, misses)
    init_next = jnp.where(fresh, 1, init_next)

    next_state = TrackState(
        theta=theta_next.astype(jnp.float32),
        omega=omega_next.astype(jnp.float32),
        misses=misses.astype(jnp.int32),
        initialized=init_next.astype(jnp.int32),
    )
    return next_state, theta_next.astype(jnp.float32)


def _init_state(batch_shape=()) -> TrackState:
    z = jnp.zeros(batch_shape, jnp.float32)
    return TrackState(
        theta=z, omega=z, misses=jnp.zeros(batch_shape, jnp.int32),
        initialized=jnp.zeros(batch_shape, jnp.int32),
    )


def track_angles(
    angles,
    alpha: float = 0.35,
    beta: Optional[float] = None,
    gate_deg: float = 25.0,
    max_misses: int = 3,
):
    """Track a sequence (or batch of sequences) of per-frame DoA estimates.

    ``angles``: (T,) or (T, B) radians.  Returns filtered angles of the same
    shape.  Runs as one ``lax.scan`` under jit; vmapped over the trailing
    batch axis when present.
    """
    angles = jnp.asarray(angles, jnp.float32)
    gate_rad = float(np.deg2rad(gate_deg))

    def scan_one(seq):
        def body(carry, z):
            return track_step(
                carry, z, alpha=alpha, beta=beta,
                gate_rad=gate_rad, max_misses=max_misses,
            )

        _, out = jax.lax.scan(body, _init_state(), seq)
        return out

    if angles.ndim == 1:
        return scan_one(angles)
    return jax.vmap(scan_one, in_axes=1, out_axes=1)(angles)


class DoaTracker:
    """Host-side streaming wrapper: feed one estimate per frame, read the
    filtered DoA.  Mirrors ``track_step`` exactly (numpy, no device work) —
    parity is pinned by tests/test_tracking.py."""

    def __init__(
        self,
        alpha: float = 0.35,
        beta: Optional[float] = None,
        gate_deg: float = 25.0,
        max_misses: int = 3,
    ):
        self.alpha = float(alpha)
        self.beta = (
            float(beta)
            if beta is not None
            else self.alpha * self.alpha / (2.0 - self.alpha)
        )
        self.gate_rad = float(np.deg2rad(gate_deg))
        self.max_misses = int(max_misses)
        self.reset()

    def reset(self):
        self.theta = 0.0
        self.omega = 0.0
        self.misses = 0
        self.initialized = 0  # 0 = empty, 1 = have theta, 2 = tracking

    @staticmethod
    def _wrap(x: float) -> float:
        return float(np.arctan2(np.sin(x), np.cos(x)))

    def update(self, z: float) -> float:
        z = float(z)
        if self.initialized == 0:
            self.theta, self.omega, self.misses = z, 0.0, 0
            self.initialized = 1
            return self.theta
        if self.initialized == 1:
            # two-point bootstrap: derive the rate, ungated (see track_step)
            self.omega = self._wrap(z - self.theta)
            self.theta, self.misses = z, 0
            self.initialized = 2
            return self.theta
        theta_pred = self._wrap(self.theta + self.omega)
        delta = self._wrap(z - theta_pred)
        if abs(delta) <= self.gate_rad:
            self.theta = self._wrap(theta_pred + self.alpha * delta)
            self.omega = self.omega + self.beta * delta
            self.misses = 0
        else:
            self.misses += 1
            if self.misses > self.max_misses:
                # snap and drop to state 1: the next point re-derives omega
                self.theta, self.omega, self.misses = z, 0.0, 0
                self.initialized = 1
            else:
                self.theta = theta_pred
        return self.theta


# ---------------------------------------------------------------------------
# Multi-target tracking
# ---------------------------------------------------------------------------
#
# The reference's multi-target harnesses (paper_plots/multiple_targets_snn.py
# :87-246) only check STATIC resolvability — two peaks in one frame's
# response.  Production multi-source localization needs per-frame peak
# measurements associated into persistent tracks.  This is the classic
# gated global-nearest-neighbour (GNN) multi-target tracker, specialised to
# the circle and to XLA: M track slots, K measurements per frame (both
# static), greedy globally-min-cost assignment unrolled min(M, K) times,
# per-slot alpha-beta updates in pure selects.  Track lifecycle: spawn
# tentative on an unassigned measurement -> two-point bootstrap -> confirmed
# after ``confirm_hits`` inlier updates -> killed after ``max_misses``
# consecutive coasts (tentative tracks die on their first missed frame).
# Identity through target crossings comes from the velocity state: while the
# measurements merge, each track coasts/updates along its own omega and
# re-gates on the correct target as they separate.


class MultiTrackState(NamedTuple):
    """Vectorized carry for ``num_tracks`` slots.  ``initialized`` uses the
    single-target convention per slot (0 = empty/dead, 1 = have theta,
    2 = tracking); ``hits`` counts inlier updates since birth (confirmation
    threshold)."""

    theta: jnp.ndarray  # (M,) f32
    omega: jnp.ndarray  # (M,) f32 rad/frame
    misses: jnp.ndarray  # (M,) i32
    initialized: jnp.ndarray  # (M,) i32
    hits: jnp.ndarray  # (M,) i32


def multi_track_init(num_tracks: int) -> MultiTrackState:
    z = jnp.zeros((num_tracks,), jnp.float32)
    zi = jnp.zeros((num_tracks,), jnp.int32)
    return MultiTrackState(theta=z, omega=z, misses=zi, initialized=zi, hits=zi)


def multi_track_step(
    state: MultiTrackState,
    z,
    valid,
    alpha: float = 0.35,
    beta: Optional[float] = None,
    gate_rad: float = np.deg2rad(25.0),
    max_misses: int = 3,
    confirm_hits: int = 2,
):
    """One gated-GNN predict/assign/update over M slots and K measurements.

    Args:
        z: (K,) candidate DoAs [rad] (e.g. from ``ops.peaks.top_k_peaks``).
        valid: (K,) bool — which candidates are real peaks this frame.

    Returns ``(next_state, (theta (M,), confirmed (M,) bool))``.  Pure and
    static-shape: runs under ``lax.scan``/jit; the greedy assignment is an
    unrolled min(M, K)-round argmin over the masked cost matrix.
    """
    if beta is None:
        beta = alpha * alpha / (2.0 - alpha)
    z = jnp.asarray(z, jnp.float32)
    valid = jnp.asarray(valid, jnp.bool_)
    M = state.theta.shape[0]
    K = z.shape[0]

    tracking = state.initialized == 2
    booting = state.initialized == 1
    theta_pred = _wrap(state.theta + state.omega)

    # cost matrix: wrapped distance measurement<->prediction.  Booting slots
    # gate wide (pi) — the single-target bootstrap is ungated for the same
    # reason (a fast target's second point may exceed the steady gate); the
    # greedy global order still hands confirmed tracks their nearest
    # measurements first because their costs are smaller.
    dist = jnp.abs(_wrap(z[None, :] - theta_pred[:, None]))  # (M, K)
    slot_gate = jnp.where(tracking, gate_rad, jnp.pi)[:, None]
    feasible = (tracking | booting)[:, None] & valid[None, :] & (dist <= slot_gate)
    inf = jnp.float32(jnp.inf)
    cost = jnp.where(feasible, dist, inf)

    # greedy global-min assignment, unrolled (M and K are small statics)
    assign = jnp.full((M,), -1, jnp.int32)  # measurement index per slot
    taken = jnp.zeros((K,), jnp.bool_)
    for _ in range(min(M, K)):
        flat = jnp.argmin(cost)
        m, k = flat // K, flat % K
        ok = cost[m, k] < inf
        assign = jnp.where(ok & (jnp.arange(M) == m), k, assign)
        taken = taken | (ok & (jnp.arange(K) == k))
        row = jnp.arange(M)[:, None] == m
        col = jnp.arange(K)[None, :] == k
        cost = jnp.where(ok & (row | col), inf, cost)

    has_meas = assign >= 0
    z_m = z[jnp.clip(assign, 0)]  # gathered measurement per slot (garbage if none)

    # steady alpha-beta update (state 2, assigned)
    delta = _wrap(z_m - theta_pred)
    theta_upd = _wrap(theta_pred + alpha * delta)
    omega_upd = state.omega + beta * delta

    upd = tracking & has_meas
    coast = tracking & ~has_meas
    theta = jnp.where(upd, theta_upd, jnp.where(coast, theta_pred, state.theta))
    omega = jnp.where(upd, omega_upd, state.omega)
    misses = jnp.where(upd, 0, jnp.where(coast, state.misses + 1, state.misses))
    hits = jnp.where(upd, state.hits + 1, state.hits)
    init = state.initialized

    # two-point bootstrap (state 1, assigned): derive omega from the raw
    # wrapped difference, promote to tracking
    boot = booting & has_meas
    omega = jnp.where(boot, _wrap(z_m - state.theta), omega)
    theta = jnp.where(boot, z_m, theta)
    hits = jnp.where(boot, state.hits + 1, hits)
    misses = jnp.where(boot, 0, misses)
    init = jnp.where(boot, 2, init)

    # lifecycle: tentative slots die on their first missed frame; confirmed
    # slots die after max_misses consecutive coasts
    die = (booting & ~has_meas) | (coast & (misses > max_misses))
    init = jnp.where(die, 0, init)
    hits = jnp.where(die, 0, hits)
    misses = jnp.where(die, 0, misses)

    # spawn tentative tracks: each leftover valid measurement claims the
    # first free slot (unrolled over K so later measurements see the claim)
    for k in range(K):
        free = init == 0
        spawn_ok = valid[k] & ~taken[k] & jnp.any(free)
        slot = jnp.argmax(free)  # first free slot
        sel = spawn_ok & (jnp.arange(M) == slot)
        theta = jnp.where(sel, z[k], theta)
        omega = jnp.where(sel, 0.0, omega)
        misses = jnp.where(sel, 0, misses)
        hits = jnp.where(sel, 0, hits)
        init = jnp.where(sel, 1, init)

    next_state = MultiTrackState(
        theta=theta.astype(jnp.float32),
        omega=omega.astype(jnp.float32),
        misses=misses.astype(jnp.int32),
        initialized=init.astype(jnp.int32),
        hits=hits.astype(jnp.int32),
    )
    confirmed = (next_state.initialized == 2) & (next_state.hits >= confirm_hits)
    return next_state, (next_state.theta, confirmed)


def track_multi_angles(
    z_seq,
    valid_seq,
    num_tracks: int,
    alpha: float = 0.35,
    beta: Optional[float] = None,
    gate_deg: float = 25.0,
    max_misses: int = 3,
    confirm_hits: int = 2,
):
    """Track a (T, K) sequence of per-frame peak measurements into
    ``num_tracks`` persistent tracks.  One ``lax.scan`` under jit.

    Returns ``(thetas (T, M), confirmed (T, M) bool)``.
    """
    z_seq = jnp.asarray(z_seq, jnp.float32)
    valid_seq = jnp.asarray(valid_seq, jnp.bool_)
    gate_rad = float(np.deg2rad(gate_deg))

    def body(carry, zv):
        z, v = zv
        return multi_track_step(
            carry, z, v, alpha=alpha, beta=beta, gate_rad=gate_rad,
            max_misses=max_misses, confirm_hits=confirm_hits,
        )

    _, (thetas, confirmed) = jax.lax.scan(
        body, multi_track_init(num_tracks), (z_seq, valid_seq)
    )
    return thetas, confirmed


class MultiDoaTracker:
    """Host-side streaming GNN tracker mirroring ``multi_track_step`` exactly
    (numpy; parity pinned by tests/test_tracking.py).  Feed K candidate
    (angle, valid) pairs per frame; read (thetas, confirmed) per slot."""

    def __init__(
        self,
        num_tracks: int,
        alpha: float = 0.35,
        beta: Optional[float] = None,
        gate_deg: float = 25.0,
        max_misses: int = 3,
        confirm_hits: int = 2,
    ):
        self.M = int(num_tracks)
        self.alpha = float(alpha)
        self.beta = (
            float(beta)
            if beta is not None
            else self.alpha * self.alpha / (2.0 - self.alpha)
        )
        self.gate_rad = float(np.deg2rad(gate_deg))
        self.max_misses = int(max_misses)
        self.confirm_hits = int(confirm_hits)
        self.reset()

    def reset(self):
        self.theta = np.zeros(self.M, np.float32)
        self.omega = np.zeros(self.M, np.float32)
        self.misses = np.zeros(self.M, np.int32)
        self.initialized = np.zeros(self.M, np.int32)
        self.hits = np.zeros(self.M, np.int32)

    @staticmethod
    def _wrap(x):
        return np.arctan2(np.sin(x), np.cos(x))

    def update(self, z, valid=None):
        z = np.asarray(z, np.float32)
        K = z.shape[0]
        valid = (
            np.ones(K, bool) if valid is None else np.asarray(valid, bool)
        )
        M = self.M
        tracking = self.initialized == 2
        booting = self.initialized == 1
        theta_pred = self._wrap(self.theta + self.omega)

        dist = np.abs(self._wrap(z[None, :] - theta_pred[:, None]))
        slot_gate = np.where(tracking, self.gate_rad, np.pi)[:, None]
        feasible = (tracking | booting)[:, None] & valid[None, :] & (dist <= slot_gate)
        cost = np.where(feasible, dist, np.inf)

        assign = np.full(M, -1, np.int32)
        taken = np.zeros(K, bool)
        for _ in range(min(M, K)):
            flat = int(np.argmin(cost))
            m, k = flat // K, flat % K
            if not np.isfinite(cost[m, k]):
                break
            assign[m] = k
            taken[k] = True
            cost[m, :] = np.inf
            cost[:, k] = np.inf

        has_meas = assign >= 0
        z_m = z[np.clip(assign, 0, None)]

        delta = self._wrap(z_m - theta_pred)
        theta_upd = self._wrap(theta_pred + self.alpha * delta)
        omega_upd = self.omega + self.beta * delta

        upd = tracking & has_meas
        coast = tracking & ~has_meas
        theta = np.where(upd, theta_upd, np.where(coast, theta_pred, self.theta))
        omega = np.where(upd, omega_upd, self.omega)
        misses = np.where(upd, 0, np.where(coast, self.misses + 1, self.misses))
        hits = np.where(upd, self.hits + 1, self.hits)
        init = self.initialized.copy()

        boot = booting & has_meas
        omega = np.where(boot, self._wrap(z_m - self.theta), omega)
        theta = np.where(boot, z_m, theta)
        hits = np.where(boot, self.hits + 1, hits)
        misses = np.where(boot, 0, misses)
        init = np.where(boot, 2, init)

        die = (booting & ~has_meas) | (coast & (misses > self.max_misses))
        init = np.where(die, 0, init)
        hits = np.where(die, 0, hits)
        misses = np.where(die, 0, misses)

        for k in range(K):
            free = init == 0
            if valid[k] and not taken[k] and free.any():
                slot = int(np.argmax(free))
                theta[slot], omega[slot] = z[k], 0.0
                misses[slot], hits[slot], init[slot] = 0, 0, 1

        self.theta = theta.astype(np.float32)
        self.omega = omega.astype(np.float32)
        self.misses = misses.astype(np.int32)
        self.hits = hits.astype(np.int32)
        self.initialized = init.astype(np.int32)
        confirmed = (init == 2) & (hits >= self.confirm_hits)
        return self.theta.copy(), confirmed
