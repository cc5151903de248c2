"""Peak detection with scipy ``find_peaks(distance=...)`` semantics, under jit.

This is the core of the RZCC spike encoder (reference:
micloc/spike_encoder.py:115-137 calls ``scipy.signal.find_peaks(cumsum(sig),
distance=robust_width)`` per channel) and the first genuinely hard kernel for an
accelerator port: scipy's distance filter is a *greedy, height-ordered, sequential*
suppression.  We reproduce it exactly with a data-parallel fixed-point
iteration:

1. Local maxima with scipy's plateau handling: a peak is the midpoint
   ``(left_edge + right_edge) // 2`` of a maximal plateau that strictly rises
   on the left and strictly falls on the right; signal edges are excluded
   (scipy `_local_maxima_1d`).
2. Distance selection: scipy sorts peaks by height and keeps them greedily,
   deleting any candidate within ``ceil(distance) - 1`` samples of a kept
   peak.  The
   parallel simulation: in each round, a candidate wins iff it is the maximum
   of its own +/- (d-1) window; two surviving window-maxima within one window
   provably have equal heights, so the rightmost-index tiebreak resolves them.
   Winners are kept, candidates inside a winner's window are deleted, and the
   round repeats until no candidates remain.  Each round is a couple of
   ``reduce_window`` max-pools — fully vectorized over time and channels.

The iteration count equals the longest "domino chain" of overlapping peaks
(1-2 rounds for oscillatory audio signals); a ``lax.while_loop`` runs until the
candidate set is empty, so the result is *exactly* scipy's, not an
approximation — with one documented exception: when two candidate peaks inside
one distance window have *bit-identical* heights, scipy's order is whatever its
unstable ``np.argsort`` (introsort) produces, which is not a specifiable
semantic; we deterministically keep the rightmost, matching scipy's intent for
its greedy reverse iteration.  Exact float ties cannot occur for the cumsum of
continuous-valued signals that feeds the RZCC encoder.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp


def local_maxima_mask(x):
    """Boolean mask of scipy-style local maxima (plateau midpoints) along the
    last axis of ``x`` (any leading batch dims).

    Gather/scatter-free formulation: for every position p, the enclosing run
    of equal values is [l(p), r(p)] where l−1 is the last nonzero diff before p and r the next
    nonzero diff at/after p (forward cummax / reverse cummin of marked
    indices).  p is a peak iff the run rises on the left (last nonzero diff is
    +1), falls on the right (next nonzero diff is −1), and p is the run's
    midpoint ``(l + r) // 2`` — exactly scipy `_local_maxima_1d` including
    plateaus, with signal edges excluded automatically (no boundary ⇒ the
    rise/fall test fails).
    """
    x = jnp.asarray(x)
    T = x.shape[-1]
    d = jnp.sign(x[..., 1:] - x[..., :-1])  # (..., T-1), d[i] = sign(x[i+1]-x[i])
    axis = d.ndim - 1
    idx = jnp.arange(T - 1, dtype=jnp.int32)
    big = jnp.int32(T)  # sentinel "no next boundary"

    # last +1/-1 boundary strictly before p (shift the inclusive cummax by one)
    last_pos = jax.lax.cummax(jnp.where(d == 1, idx, -1), axis=axis)
    last_neg = jax.lax.cummax(jnp.where(d == -1, idx, -1), axis=axis)
    pad = jnp.full(x.shape[:-1] + (1,), -1, jnp.int32)
    last_pos = jnp.concatenate([pad, last_pos], axis=-1)  # (..., T)
    last_neg = jnp.concatenate([pad, last_neg], axis=-1)

    # next +1/-1 boundary at/after p
    next_pos = jax.lax.cummin(jnp.where(d == 1, idx, big), axis=axis, reverse=True)
    next_neg = jax.lax.cummin(jnp.where(d == -1, idx, big), axis=axis, reverse=True)
    pad_b = jnp.full(x.shape[:-1] + (1,), big, jnp.int32)
    next_pos = jnp.concatenate([next_pos, pad_b], axis=-1)  # (..., T)
    next_neg = jnp.concatenate([next_neg, pad_b], axis=-1)

    rising_into = last_pos > last_neg  # boundary before the run is a rise
    falling_out = next_neg < next_pos  # boundary after the run is a fall
    l = last_pos + 1
    r = next_neg
    p = jnp.arange(T, dtype=jnp.int32)
    return rising_into & falling_out & (p == (l + r) // 2)


def _shift_right(v, k: int, fill):
    pad = jnp.full(v.shape[:-1] + (k,), fill, v.dtype)
    return jnp.concatenate([pad, v[..., :-k]], axis=-1)


def _window_max(v, w: int):
    """Max over a centered window of full width ``2*w + 1`` along the last
    axis (same length out; leading dims are batch).

    Log-dilated doubling: O(log w) shift+max passes, which XLA fuses into
    elementwise loop fusions.
    """
    neg_inf = jnp.array(-jnp.inf, v.dtype) if jnp.issubdtype(v.dtype, jnp.floating) else jnp.iinfo(v.dtype).min
    L = 2 * w + 1
    T = v.shape[-1]
    # pad right so the centered window is exact at the signal end, then
    # trailing max over [i-L+1, i] via Hillis-Steele doubling
    y = jnp.concatenate([v, jnp.full(v.shape[:-1] + (w,), neg_inf, v.dtype)], axis=-1)
    k = 1
    while k < L:
        step = min(k, L - k)
        y = jnp.maximum(y, _shift_right(y, step, neg_inf))
        k += step
    # center: cmax[i] = trailing[i + w]
    return y[..., w : w + T]


def local_maxima_mask_bounded(x, max_plateau: int):
    """Local maxima with the plateau search bounded to ``max_plateau`` samples.

    Identical to :func:`local_maxima_mask` whenever no run of exactly-equal
    values exceeds ``max_plateau`` — true for any continuous-valued signal
    (runs of equal floats are digital silence).  The bounded search replaces
    the O(log T) full-length cummax/cummin passes with O(log max_plateau)
    dilated shift-max passes, a large win on long signals; the hot encode
    path uses this with ``max_plateau = 2·robust_width`` (a plateau longer
    than that carries no spike anyway — peaks closer than robust_width are
    suppressed, and true silence has no peaks).
    """
    x = jnp.asarray(x)
    T = x.shape[-1]
    d = jnp.sign(x[..., 1:] - x[..., :-1])
    idx = jnp.arange(T - 1, dtype=jnp.int32)
    W = int(max_plateau)
    big = jnp.int32(T)
    neg = jnp.int32(-1)

    def trailing_max(v, L, fill):
        y = v
        k = 1
        while k < L:
            step = min(k, L - k)
            y = jnp.maximum(y, _shift_right(y, step, fill))
            k += step
        return y

    def leading_min(v, L, fill):
        y = v
        k = 1
        while k < L:
            step = min(k, L - k)
            pad = jnp.full(v.shape[:-1] + (step,), fill, v.dtype)
            y = jnp.minimum(y, jnp.concatenate([y[..., step:], pad], axis=-1))
            k += step
        return y

    # last +1/-1 boundary within the trailing window, strictly before p
    last_pos = trailing_max(jnp.where(d == 1, idx, neg), W, neg)
    last_neg = trailing_max(jnp.where(d == -1, idx, neg), W, neg)
    pad1 = jnp.full(x.shape[:-1] + (1,), -1, jnp.int32)
    last_pos = jnp.concatenate([pad1, last_pos], axis=-1)
    last_neg = jnp.concatenate([pad1, last_neg], axis=-1)

    # next +1/-1 boundary within the leading window, at/after p
    next_pos = leading_min(jnp.where(d == 1, idx, big), W, big)
    next_neg = leading_min(jnp.where(d == -1, idx, big), W, big)
    padb = jnp.full(x.shape[:-1] + (1,), T, jnp.int32)
    next_pos = jnp.concatenate([next_pos, padb], axis=-1)
    next_neg = jnp.concatenate([next_neg, padb], axis=-1)

    rising_into = last_pos > last_neg
    falling_out = next_neg < next_pos
    l = last_pos + 1
    r = next_neg
    p = jnp.arange(T, dtype=jnp.int32)
    return rising_into & falling_out & (p == (l + r) // 2)


def local_extrema_mask_bounded(x, max_plateau: int):
    """Bounded-plateau local maxima AND minima of ``x`` in one pass pair.

    The run boundaries of ``x`` and ``-x`` are identical — only the rise/fall
    test flips — so both polarities come from a single trailing-max and a
    single leading-min over *sign-encoded* boundary indices (``2·idx + (d>0)``:
    the max/min picks the nearest boundary, the low bit recovers its sign).
    Uses int16 encoding when the length permits (halves the pool traffic).

    Returns ``(maxima_mask, minima_mask)``; each equals
    ``local_maxima_mask_bounded(±x, max_plateau)``.
    """
    x = jnp.asarray(x)
    T = x.shape[-1]
    d = jnp.sign(x[..., 1:] - x[..., :-1])
    W = int(max_plateau)
    idt = jnp.int16 if 2 * T + 1 < 2**15 - 1 else jnp.int32
    idx = jnp.arange(T - 1, dtype=idt)
    enc = jnp.where(d != 0, 2 * idx + (d == 1).astype(idt), idt(-1))
    big = idt(jnp.iinfo(idt).max)
    encN = jnp.where(d != 0, 2 * idx + (d == 1).astype(idt), big)

    def trailing_max(v, L, fill):
        y = v
        k = 1
        while k < L:
            step = min(k, L - k)
            y = jnp.maximum(y, _shift_right(y, step, fill))
            k += step
        return y

    def leading_min(v, L, fill):
        y = v
        k = 1
        while k < L:
            step = min(k, L - k)
            pad = jnp.full(v.shape[:-1] + (step,), fill, v.dtype)
            y = jnp.minimum(y, jnp.concatenate([y[..., step:], pad], axis=-1))
            k += step
        return y

    last = trailing_max(enc, W, idt(-1))
    pad1 = jnp.full(x.shape[:-1] + (1,), -1, idt)
    last = jnp.concatenate([pad1, last], axis=-1)  # strictly-before shift

    nxt = leading_min(encN, W, big)
    padb = jnp.full(x.shape[:-1] + (1,), big, idt)
    nxt = jnp.concatenate([nxt, padb], axis=-1)

    has_last = last >= 0
    last_rise = has_last & ((last & 1) == 1)
    has_next = nxt < big
    next_fall = has_next & ((nxt & 1) == 0)

    l = (last >> 1).astype(jnp.int32) + 1  # valid only when has_last
    r = (nxt >> 1).astype(jnp.int32)
    p = jnp.arange(T, dtype=jnp.int32)
    mid_ok = p == (l + r) // 2

    maxima = last_rise & next_fall & mid_ok
    minima = (has_last & ~last_rise) & (has_next & ~next_fall) & mid_ok
    return maxima, minima


def select_by_distance(cand_mask, height, distance):
    """Greedy height-ordered distance suppression (scipy `_select_by_peak_distance`).

    Args:
        cand_mask: (T,) bool — candidate peak positions.
        height: (T,) priorities (the signal values at candidates).
        distance: minimal allowed spacing; peaks closer than ``ceil(distance)``
            samples to a higher kept peak are removed.

    Batch-native: operates along the last axis with any leading batch dims.

    Returns:
        (..., T) bool mask of kept peaks.
    """
    T = cand_mask.shape[-1]
    w = int(np.ceil(distance)) - 1
    if w <= 0:
        return cand_mask
    fdtype = height.dtype if jnp.issubdtype(height.dtype, jnp.floating) else jnp.float32
    height = height.astype(fdtype)
    # narrow integer types for the index/mask pools (halves pool traffic)
    idt = jnp.int16 if T < 2**15 - 1 else jnp.int32
    idx = jnp.arange(T, dtype=idt)
    neg_inf = jnp.array(-jnp.inf, dtype=fdtype)

    def cond(state):
        active, kept = state
        return jnp.any(active)

    def body(state):
        active, kept = state
        h = jnp.where(active, height, neg_inf)
        wmax = _window_max(h, w)
        top = active & (h == wmax) & jnp.isfinite(h)
        # rightmost tiebreak among window-maxima (all equal-height within a window)
        tid = jnp.where(top, idx, idt(-1))
        wtid = _window_max(tid, w)
        winner = top & (wtid == idx)
        # delete candidates inside any winner's window
        in_winner_win = _window_max(winner.astype(jnp.int8), w) > 0
        kept = kept | winner
        active = active & ~in_winner_win
        return active, kept

    # Round 1 hoisted out of the while loop: it always runs, and for the RZCC
    # encode path it resolves everything (candidates interact only through
    # noise-induced pairs, which the window-max round settles immediately) —
    # hoisting lets XLA fuse it with the surrounding program instead of
    # paying loop-carry copies; the while loop then starts on an (almost
    # always empty) residual of ≥3-candidate chains.
    state = body((cand_mask, jnp.zeros_like(cand_mask)))
    _, kept = jax.lax.while_loop(cond, body, state)
    return kept


def select_by_distance_tm(cand_tm, height_tm, distance):
    """Time-major :func:`select_by_distance`: (T, rows) in, (T, rows) bool
    out."""
    return jnp.swapaxes(
        select_by_distance(
            jnp.swapaxes(jnp.asarray(cand_tm, jnp.bool_), 0, -1),
            jnp.swapaxes(jnp.asarray(height_tm), 0, -1),
            distance,
        ),
        0,
        -1,
    )


def rzcc_select_bipolar_tm(cs_tm, maxima_tm, minima_tm, distance):
    """Bipolar RZCC suppression, time-major: ``(kept_pos, kept_neg)`` bool
    (T, rows) masks — :func:`select_by_distance` on (maxima, cs) and
    (minima, -cs), run as ONE suppression over the stacked polarities."""
    R = jnp.shape(cs_tm)[-1]
    cs_tm = jnp.asarray(cs_tm)
    kept = select_by_distance_tm(
        jnp.concatenate([maxima_tm, minima_tm], axis=-1),
        jnp.concatenate([cs_tm, -cs_tm], axis=-1),
        distance,
    )
    return kept[:, :R], kept[:, R:]


def rzcc_encode_bipolar_tm(cs_tm, distance, max_plateau: int):
    """Bipolar RZCC spike extraction, time-major: bounded-plateau extrema of
    ±cs (:func:`local_extrema_mask_bounded`) followed by the greedy distance
    suppression of each polarity.  Returns ``(kept_pos, kept_neg)`` bool
    masks of shape (T, rows)."""
    cs_tm = jnp.asarray(cs_tm)
    maxima, minima = local_extrema_mask_bounded(jnp.swapaxes(cs_tm, 0, -1), max_plateau)
    return rzcc_select_bipolar_tm(
        cs_tm, jnp.swapaxes(maxima, 0, -1), jnp.swapaxes(minima, 0, -1), distance
    )


def find_peaks_mask(x, distance=None, max_plateau=None):
    """jit-compatible ``scipy.signal.find_peaks(x, distance=d)`` along the last
    axis, returning a boolean mask instead of an index list (static shapes for
    XLA).  Leading dims are batch.

    ``max_plateau``: bound the plateau search window (see
    :func:`local_maxima_mask_bounded`) — exact for continuous-valued signals,
    much faster on long inputs."""
    x = jnp.asarray(x)
    if max_plateau is None:
        cand = local_maxima_mask(x)
    else:
        cand = local_maxima_mask_bounded(x, max_plateau)
    if distance is None or distance <= 1:
        return cand
    return select_by_distance(cand, x, distance)


def top_k_peaks(x, k: int, distance=None, max_plateau=None, rel_height=0.0):
    """Top-``k`` peaks of a 1-D profile by height, jit-compatible.

    The multi-target harnesses (reference:
    paper_plots/multiple_targets_snn.py:194-246 picks the two best-separated
    response maxima by hand) need "the K best well-separated peaks" as a
    static-shape op: this runs :func:`find_peaks_mask` and selects the ``k``
    highest survivors with ``lax.top_k``.

    Args:
        x: (T,) profile (e.g. an angular power/rate response).
        k: static number of peaks to return.
        distance: minimal peak spacing in samples (scipy semantics).
        max_plateau: bounded plateau search (see :func:`find_peaks_mask`).
        rel_height: drop peaks below ``rel_height * max(x)`` — the
            resolvability threshold the multi-target experiments apply.

    Returns:
        ``(idx, height, valid)`` — each ``(k,)``; invalid entries (fewer than
        ``k`` qualifying peaks) have ``valid=False`` and ``idx=0``.
    """
    x = jnp.asarray(x)
    mask = find_peaks_mask(x, distance=distance, max_plateau=max_plateau)
    if rel_height > 0.0:
        mask = mask & (x >= rel_height * jnp.max(x))
    fdtype = x.dtype if jnp.issubdtype(x.dtype, jnp.floating) else jnp.float32
    vals = jnp.where(mask, x.astype(fdtype), -jnp.inf)
    height, idx = jax.lax.top_k(vals, k)
    valid = jnp.isfinite(height)
    return jnp.where(valid, idx, 0), height, valid
