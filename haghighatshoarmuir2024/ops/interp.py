"""Fractional-delay interpolation — the wave-propagation simulation model.

The reference's entire propagation model is ``np.interp`` of a template signal
onto per-mic (optionally per-sample) delayed time grids
(micloc/beamformer.py:113-129,233-245, micloc/snn_beamformer.py:139-154,252-267,
micloc/xylo_snn_localization.py:44-71).  Here it becomes a vectorized
gather + linear blend on a uniform grid, batched over microphones, DoAs and
samples in one shot.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp


def interp_uniform(tq, f, t0, dt):
    """Linear interpolation of samples ``f`` (uniform grid ``t0 + k*dt``) at
    query times ``tq``; clamps to the end values outside the grid, matching
    ``np.interp``'s default left/right behavior.

    ``tq`` may have any shape; broadcasting applies over leading dims of ``f``
    is NOT supported — ``f`` is 1-D (T,), result has ``tq``'s shape.
    """
    f = jnp.asarray(f)
    tq = jnp.asarray(tq)
    T = f.shape[0]
    idx = (tq - t0) / dt
    idx = jnp.clip(idx, 0.0, T - 1.0)
    i0 = jnp.floor(idx).astype(jnp.int32)
    i0 = jnp.minimum(i0, T - 2) if T > 1 else i0
    w = (idx - i0).astype(f.dtype) if not jnp.iscomplexobj(f) else (idx - i0)
    f0 = jnp.take(f, i0, axis=0)
    f1 = jnp.take(f, jnp.minimum(i0 + 1, T - 1), axis=0)
    return f0 + (f1 - f0) * w


def delayed_copies(sig, delays, fs, clamp_left: bool = True):
    """Delayed copies of a template: out[..., t, m] = sig((t/fs) - delays[..., m]).

    Args:
        sig: (T,) template sampled at ``fs`` with t0 = 0.
        delays: (..., M) per-mic delays in seconds; may also be (..., T, M) for a
            per-sample (moving-source) delay trajectory.
        fs: sampling rate.

    Returns:
        (..., T, M) array of the delayed signal copies.

    Mirrors the reference's ``time_delayed = time - delays; clip at t_min;
    np.interp`` pattern (micloc/beamformer.py:120-129).
    """
    sig = jnp.asarray(sig)
    delays = jnp.asarray(delays)
    T = sig.shape[0]
    t = jnp.arange(T, dtype=delays.dtype) / fs
    if delays.ndim >= 2 and delays.shape[-2] == T:
        tq = t[:, None] - delays  # (..., T, M)
    else:
        tq = t[:, None] - delays[..., None, :]  # (..., T, M)
    return interp_uniform(tq, sig, 0.0, 1.0 / fs)


def resample_to_fs(time_temp: np.ndarray, sig_temp: np.ndarray, fs: float):
    """Host-side resampling of an arbitrary template onto the array clock,
    mirroring ``np.arange(t.min(), t.max(), 1/fs); np.interp``
    (micloc/beamformer.py:100-103).  Returns (time, sig) as float64 ndarrays."""
    time_temp = np.asarray(time_temp, dtype=np.float64)
    sig_temp = np.asarray(sig_temp, dtype=np.float64)
    time_interp = np.arange(time_temp.min(), time_temp.max(), step=1.0 / fs)
    sig_interp = np.interp(time_interp, time_temp, sig_temp)
    return time_interp, sig_interp


def signal_from_template(geometry, time_temp, sig_temp, doa, fs: Optional[float] = None,
                         delay_sign: int = 1):
    """Build the T×M array signal received from a source at DoA ``doa``.

    Equivalent of ``signal_from_template`` at micloc/xylo_snn_localization.py:44-71:
    uses *non-normalized* delays and evaluates the template at ``t + delay``.

    ``delay_sign=-1`` selects the reference's OTHER synthesis convention —
    ``t - delay``, as used by its MUSIC harnesses
    (paper_plots/multiple_targets_music.py:147,
    micloc/music_beamformer.py:307-312).  The two conventions differ by a
    front/back bearing flip: MUSIC's physics-based steering
    ``exp(-1j 2π f delay)`` (micloc/music_beamformer.py:83-87) matches the
    minus convention, so MUSIC inputs MUST be synthesized with
    ``delay_sign=-1`` (or :func:`received_signal`, which normalizes delays) —
    feeding it plus-convention audio mirrors every estimate by 180°.

    Args:
        geometry: ArrayGeometry.
        time_temp: (T,) uniform time grid starting at ``time_temp[0]``.
        sig_temp: (T,) template samples.
        doa: scalar DoA or per-sample (T,) DoA trajectory.
        fs: sampling rate; inferred from the time grid when None.
        delay_sign: +1 (xylo/beamformer convention) or -1 (MUSIC convention).

    Returns:
        (T, M) jnp array.
    """
    time_temp = jnp.asarray(time_temp)
    sig_temp = jnp.asarray(sig_temp)
    if fs is None:
        fs = 1.0 / float(time_temp[1] - time_temp[0])
    doa = jnp.asarray(doa)
    delays = geometry.delays(doa if doa.ndim else doa[None], normalized=False)
    if doa.ndim == 0:
        delays = delays[0]
    delays = delay_sign * delays
    tq = time_temp[:, None] + (delays if delays.ndim == 2 else delays[None, :])
    if delays.ndim == 2:
        tq = time_temp[:, None] + delays  # (T, M) trajectory
    t0 = time_temp[0]
    return interp_uniform(tq, sig_temp, t0, 1.0 / fs)


def received_signal(geometry, time_temp, sig_temp, doa, snr_db=None, key=None, fs=None):
    """Template → array signal with optional white noise at ``snr_db`` per mic.

    This is the simulation harness pattern shared by every ``apply_to_template``
    in the reference (micloc/beamformer.py:233-253): *normalized-together*
    delays (global min subtracted), template evaluated at ``t - delay``,
    then AWGN with sigma = rms(sig)/sqrt(snr).

    Args:
        doa: scalar or per-sample (T,) trajectory.
        key: jax PRNG key for the noise (required when snr_db is not None).
    """
    import jax

    time_temp = jnp.asarray(time_temp)
    sig_temp = jnp.asarray(sig_temp)
    if fs is None:
        fs = 1.0 / float(time_temp[1] - time_temp[0])
    doa = jnp.asarray(doa)
    doa_vec = doa if doa.ndim else doa[None]
    delays = geometry.delays(doa_vec, normalized=False)  # (Td, M) or (1, M)
    delays = delays - jnp.min(delays)
    t0 = time_temp[0]
    tq = time_temp[:, None] - (delays if delays.shape[0] == time_temp.shape[0] else delays[0][None, :])
    tq = jnp.maximum(tq, t0)
    sig_in_vec = interp_uniform(tq, sig_temp, t0, 1.0 / fs)  # (T, M)

    if snr_db is not None:
        if key is None:
            raise ValueError("pass a jax PRNG `key` when snr_db is given")
        snr = 10.0 ** (jnp.asarray(snr_db) / 10.0)
        sigma = jnp.sqrt(jnp.mean(sig_in_vec**2)) / jnp.sqrt(snr)
        sig_in_vec = sig_in_vec + sigma * jax.random.normal(key, sig_in_vec.shape, sig_in_vec.dtype)
    return sig_in_vec


def signal_from_template_multipath(
    geometry, time_temp, sig_temp, doas, extra_delays, gains,
    fs: Optional[float] = None,
):
    """Array signal for a source arriving over MULTIPLE plane-wave paths.

    Beyond parity: the reference's propagation model is anechoic free field
    only (one plane wave per source, micloc/xylo_snn_localization.py:44-71);
    real rooms add wall reflections.  Each path is a plane wave from DoA
    ``doas[p]``, delayed by ``extra_delays[p]`` seconds (path length
    difference to the direct path) and scaled by ``gains[p]`` (wall
    absorption + spreading); the received signal is their sum.  Use
    :func:`room_image_paths` to derive the path table from a rectangular
    room via the image-source method.

    Args:
        doas: (P,) path DoAs (radians).
        extra_delays: (P,) per-path delay in seconds (0 for the direct path).
        gains: (P,) per-path amplitude.

    Returns:
        (T, M) jnp array: sum_p gains[p] * sig(t + mic_delay(doas[p]) - extra_delays[p]).
    """
    time_temp = jnp.asarray(time_temp)
    sig_temp = jnp.asarray(sig_temp)
    if fs is None:
        fs = 1.0 / float(time_temp[1] - time_temp[0])
    doas = jnp.atleast_1d(jnp.asarray(doas))
    extra_delays = jnp.atleast_1d(jnp.asarray(extra_delays))
    gains = jnp.atleast_1d(jnp.asarray(gains))
    delays = geometry.delays(doas, normalized=False)  # (P, M)
    # (P, T, M) query grid — same convention as signal_from_template
    # (template evaluated at t + mic delay), minus the path's travel delay
    tq = time_temp[None, :, None] + delays[:, None, :] - extra_delays[:, None, None]
    t0 = time_temp[0]
    copies = interp_uniform(tq, sig_temp, t0, 1.0 / fs)  # (P, T, M)
    return jnp.einsum(
        "p,ptm->tm", gains.astype(copies.dtype), copies,
        precision=jax.lax.Precision.HIGHEST,
    )


def room_image_paths(
    source_xy, array_xy, room_wh, reflection: float = 0.7, order: int = 1,
    speed: float = 340.0,
):
    """First/second-order image-source path table for a 2-D rectangular room.

    Host-side (numpy) helper for :func:`signal_from_template_multipath`.
    Images of the source across each wall (and wall pairs up to ``order``)
    arrive as plane waves from the image's direction with gain
    ``reflection**bounces * d_direct/d_image`` (relative spherical
    spreading, direct path normalized to gain 1) and extra delay
    ``(d_image - d_direct)/speed``.

    Args:
        source_xy: (2,) source position (meters).
        array_xy: (2,) array-center position.
        room_wh: (2,) room width/height; walls at x=0, x=W, y=0, y=H.
        reflection: wall amplitude reflection coefficient in [0, 1].
        order: max reflections per path (1 or 2).

    Returns:
        (doas (P,), extra_delays (P,), gains (P,)) float64 numpy arrays,
        direct path first.
    """
    sx, sy = float(source_xy[0]), float(source_xy[1])
    ax, ay = float(array_xy[0]), float(array_xy[1])
    W, H = float(room_wh[0]), float(room_wh[1])
    if not (0 < sx < W and 0 < sy < H and 0 < ax < W and 0 < ay < H):
        raise ValueError("source and array must lie inside the room")

    # explicit image enumeration per axis: reflecting across x=0 gives -x
    # (1 bounce), across x=W gives 2W-x (1 bounce); second order re-reflects
    # those (2W+x, -2W+x).  A 2-D image is an (x-image, y-image) pair with
    # summed bounce count.
    xs = [(sx, 0), (-sx, 1), (2 * W - sx, 1)]
    ys = [(sy, 0), (-sy, 1), (2 * H - sy, 1)]
    if order >= 2:
        xs += [(2 * W + sx, 2), (-2 * W + sx, 2)]
        ys += [(2 * H + sy, 2), (-2 * H + sy, 2)]
    paths = []
    for ix, bx in xs:
        for iy, by in ys:
            b = bx + by
            if b == 0 and not (ix == sx and iy == sy):
                continue
            if b > order:
                continue
            d = np.hypot(ix - ax, iy - ay)
            doa = np.arctan2(iy - ay, ix - ax)
            paths.append((doa, d, b))
    d_direct = paths[0][1]
    doas = np.array([p[0] for p in paths])
    dists = np.array([p[1] for p in paths])
    bounces = np.array([p[2] for p in paths])
    gains = (reflection ** bounces) * (d_direct / dists)
    extra = (dists - d_direct) / speed
    return doas, extra, gains
