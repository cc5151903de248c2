"""IIR filtering on the time axis under jit.

JAX replacement for the IIR path of ``scipy.signal.lfilter(b, a, x)``
(reference call sites: micloc/beamformer.py:137-138, micloc/snn_beamformer.py:163-164,
micloc/filterbank.py:41 — order-1/2 Butterworth bandpass filters).

The filter is expressed in transposed direct-form II as a linear state-space
recurrence ``s[n] = A s[n-1] + B x[n]``, ``y[n] = b0 x[n] + s[n-1][0]`` with a
constant companion-like matrix A (state dim N = len(a) - 1).  Two evaluation
strategies:

* ``method="scan"`` — exact sequential ``lax.scan`` over time.  Supports a
  carried initial state for streaming.  O(T) sequential steps, each a tiny
  fused elementwise update over all batch lanes — fine when many channels /
  DoAs / Monte-Carlo lanes are vmapped together.
* ``method="parallel"`` — Hillis–Steele parallel prefix on the recurrence using
  host-precomputed matrix powers A^(2^k): ``s += s_shifted @ (A^(2^k))^T``.
  log2(T) fully parallel passes.

Filter design (``butter_bandpass``) happens on the host with scipy at setup
time, as in the reference (micloc/beamformer.py:69-71); only the application of
the filter runs on device.
"""
from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import jax
import jax.numpy as jnp


def butter_bandpass(order: int, freq_range, fs: float) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side Butterworth bandpass design; mirrors the scipy call used at
    micloc/beamformer.py:69-71 / micloc/filterbank.py:80."""
    from scipy.signal import butter

    b, a = butter(order, list(freq_range), btype="bandpass", analog=False, output="ba", fs=fs)
    return np.asarray(b, dtype=np.float64), np.asarray(a, dtype=np.float64)


def _tdf2_matrices(b: np.ndarray, a: np.ndarray):
    """Transposed direct-form II state-space matrices (host, float64).

    s_i[n] = (b_i - a_i b0) x[n] - a_i s_1[n-1] + s_{i+1}[n-1]
    y[n]   = b0 x[n] + s_1[n-1]
    """
    b = np.asarray(b, dtype=np.float64)
    a = np.asarray(a, dtype=np.float64)
    if a[0] != 1.0:
        b = b / a[0]
        a = a / a[0]
    N = len(a) - 1
    bp = np.zeros(N + 1)
    bp[: len(b)] = b
    A = np.zeros((N, N))
    for i in range(N):
        A[i, 0] = -a[i + 1]
        if i + 1 < N:
            A[i, i + 1] += 1.0
    Bvec = bp[1:] - a[1:] * bp[0]
    return A, Bvec, float(bp[0])


@functools.lru_cache(maxsize=64)
def _cached_powers(key, log2T: int):
    A = np.array(key, dtype=np.float64)
    pows = [A]
    for _ in range(log2T - 1):
        pows.append(pows[-1] @ pows[-1])
    return np.stack(pows)  # (log2T, N, N)


def _modal_transform(A: np.ndarray):
    """Real modal basis of ``A`` (host, float64): columns are [Re v, Im v]
    per conjugate eigenpair (plus real eigenvectors), normalized.  In this
    basis A becomes block-diagonal 2×2 rotations-with-decay, so
    ``‖A_modal^k‖ ≈ radius^k`` — the companion form's huge non-normal
    transients (‖A^k‖ ~ 500 for a bandpass TDF2) disappear, which is what
    makes explicitly-powered lifted matrices float-safe.

    Returns (T, Tinv) or None when the eigenbasis is ill-conditioned
    (clustered poles) and the transform would hurt instead.
    """
    N = A.shape[0]
    eigvals, eigvecs = np.linalg.eig(A)
    used = np.zeros(N, bool)
    cols = []
    for i in range(N):
        if used[i]:
            continue
        lam, v = eigvals[i], eigvecs[:, i]
        if abs(lam.imag) <= 1e-12 * max(1.0, abs(lam.real)):
            used[i] = True
            re = v.real
            cols.append(re / np.linalg.norm(re))
        else:
            js = [
                j
                for j in range(i + 1, N)
                if not used[j] and abs(eigvals[j] - np.conj(lam)) < 1e-8 * abs(lam)
            ]
            if not js:
                return None
            used[i] = used[js[0]] = True
            re, im = v.real, v.imag
            sc = max(np.linalg.norm(re), np.linalg.norm(im))
            cols.extend([re / sc, im / sc])
    T = np.stack(cols, axis=1)
    if np.linalg.cond(T) > 1e8:
        return None
    return T, np.linalg.inv(T)


@functools.lru_cache(maxsize=64)
def _cached_level2_matrices(b_key, a_key, SB: int, Q: int):
    """Second lifting level over ``Q`` SB-sample blocks (host, float64).

    The level-1 inter-block recurrence ``s_{k+1} = A^SB s_k + sP_k`` with the
    exactly-carried integrator offset ``c_{k+1} = c_k + h1·s_k + cP_k``
    (see :func:`_iir_cumsum_blocked`) is itself linear, so Q of its steps
    collapse into matmuls:

        s_prev(all q)  = Ws @ vec(sP) + Ps @ s_in
        c_prev(all q)  = c_in + cumE + Hc @ s_in
        s_out          = A^(SB·Q) s_in + Bm2 @ vec(sP)
        c_out          = c_in + Σ_q e_q + sum_h · s_in

    Everything is expressed in the MODAL basis of A (s' = T⁻¹ s): the
    companion form's non-normal transients (‖A^k‖ ≫ 1) would otherwise
    amplify float error ~1e3× through the explicitly-powered maps; in the
    modal basis every power is norm-bounded by the pole radius.  The
    integrator's marginal eigenvalue stays OUT of every lifted matrix, and
    the offset remains an exactly-carried float sum — the same associativity
    as blocked cumsum.  The caller converts the carried state at the seam
    (``s' = T⁻¹ s`` in, ``s = T s'`` out); returns None when no
    well-conditioned modal basis exists (fall back to the level-1 scan).
    """
    G_np, H_np, Bm_np, ASB = _cached_block_matrices(b_key, a_key, SB)
    A_np, _, _ = _tdf2_matrices(np.asarray(b_key), np.asarray(a_key))
    tr = _modal_transform(A_np)
    if tr is None:
        return None
    T, Tinv = tr
    N = ASB.shape[0]
    ASBm = Tinv @ ASB @ T
    Bm_m = Tinv @ Bm_np  # (N, SB): input → modal state increment
    LT = np.tril(np.ones((SB, SB)))
    H2m = (LT @ H_np) @ T  # (SB, N): modal state → in-block integrated output
    h1m = H_np.sum(axis=0) @ T

    Apow = [np.eye(N)]
    for _ in range(Q):
        Apow.append(ASBm @ Apow[-1])

    Ws = np.zeros((Q * N, Q * N))
    Ps = np.zeros((Q * N, N))
    Bm2 = np.zeros((N, Q * N))
    hvec = np.zeros((Q, N))
    for q in range(Q):
        Ps[q * N : (q + 1) * N] = Apow[q]
        hvec[q] = h1m @ Apow[q]
        Bm2[:, q * N : (q + 1) * N] = Apow[Q - 1 - q]
        for j in range(q):
            Ws[q * N : (q + 1) * N, j * N : (j + 1) * N] = Apow[q - 1 - j]
    LTex = np.tril(np.ones((Q, Q)), k=-1)
    Hc = LTex @ hvec
    sum_h = hvec.sum(axis=0)
    return Ws, Ps, Bm2, h1m, Hc, sum_h, LTex, Apow[Q], T, Tinv, Bm_m, H2m


@functools.lru_cache(maxsize=64)
def _cached_block_matrices(b_key, a_key, SB: int):
    """Lifted SB-sample block form of the recurrence (host, float64):

        y_blk = G @ x_blk + H @ s_in        (intra-block, batched matmuls)
        s_out = A^SB @ s_in + Bm @ x_blk    (inter-block, tiny scan)

    G = lower-triangular Toeplitz of the truncated impulse response,
    H[j] = c·A^j (observability), Bm[:, i] = A^{SB-1-i}·B (controllability).
    """
    b = np.asarray(b_key, np.float64)
    a = np.asarray(a_key, np.float64)
    A, Bv, b0 = _tdf2_matrices(b, a)
    N = A.shape[0]
    c = np.zeros(N)
    c[0] = 1.0

    Apow = [np.eye(N)]
    for _ in range(SB):
        Apow.append(A @ Apow[-1])

    G = np.zeros((SB, SB))
    H = np.zeros((SB, N))
    Bm = np.zeros((N, SB))
    for j in range(SB):
        H[j] = c @ Apow[j]
        G[j, j] = b0
        for i in range(j):
            G[j, i] = c @ Apow[j - 1 - i] @ Bv
    for i in range(SB):
        Bm[:, i] = Apow[SB - 1 - i] @ Bv
    return G, H, Bm, Apow[SB]


def iir_filter(b, a, x, axis: int = 0, method: str = "scan", zi=None, return_state: bool = False,
               sb: int = 32):
    """Apply the IIR filter defined by (b, a) along ``axis``.

    Matches ``scipy.signal.lfilter(b, a, x, axis=axis)`` with zero initial
    conditions, or ``zi`` for streaming.

    Args:
        b, a: host-side filter coefficients (array-like, not traced).
        x: input, real or complex.
        axis: time axis.
        method: "scan" (sequential, bit-faithful) | "parallel" (associative
            scan) | "blocked" (lifted ``sb``-sample block form, batched matmuls)
            | "blocked_cumsum" (``cumsum(lfilter(...))`` fused into one
            lifted pass — the accelerator encode/streaming path).
        zi: optional initial state, batch_shape + (N,) — for
            "blocked_cumsum" it is batch_shape + (N+1,): TDF2 state plus
            the running integrator total.
        return_state: also return the final filter state (scan and the two
            blocked methods; the blocked forms require the time axis to be
            a multiple of ``sb``).
        sb: lifted block size for the blocked methods (default 32).  Streaming callers whose chunk length is not a
            multiple of 32 pass the largest divisor from
            {48, 40, 24, 16, 8} (runtime/streaming.py) instead of falling
            back to the sequential scan.
    """
    b = np.asarray(b)
    a = np.asarray(a)
    if len(a) == 1:
        from .fir import fir_filter

        y = fir_filter(np.asarray(b) / a[0], x, axis=axis)
        if return_state:
            raise ValueError("return_state is not supported for pure-FIR filters")
        return y

    A_np, B_np, b0 = _tdf2_matrices(b, a)
    x = jnp.asarray(x)
    xm = jnp.moveaxis(x, axis, 0)  # (T, ...)
    T = xm.shape[0]
    N = A_np.shape[0]
    cdtype = xm.dtype
    rdtype = jnp.real(jnp.zeros((), cdtype)).dtype

    A = jnp.asarray(A_np, dtype=rdtype)
    Bv = jnp.asarray(B_np, dtype=rdtype)
    b0 = jnp.asarray(b0, dtype=rdtype)

    if method == "scan":
        if zi is None:
            s0 = jnp.zeros(xm.shape[1:] + (N,), dtype=cdtype)
        else:
            s0 = jnp.asarray(zi, dtype=cdtype)

        a64 = np.asarray(a, np.float64)
        b64 = np.zeros(N + 1)
        b64[: len(b)] = np.asarray(b, np.float64) / a64[0]
        a_tail = jnp.asarray(a64[1:] / a64[0], dtype=rdtype)
        b_tail = jnp.asarray(b64[1:], dtype=rdtype)

        def step(s, x_t):
            # transposed direct-form II: y = b0 x + z1;  z_i = b_i x - a_i y + z_{i+1}
            y_t = b0 * x_t + s[..., 0]
            s_shift = jnp.concatenate(
                [s[..., 1:], jnp.zeros(s.shape[:-1] + (1,), s.dtype)], axis=-1
            )
            s_new = b_tail * x_t[..., None] - a_tail * y_t[..., None] + s_shift
            return s_new, y_t

        s_fin, y = jax.lax.scan(step, s0, xm)
        y = jnp.moveaxis(y, 0, axis)
        if return_state:
            return y, s_fin
        return y

    if method == "blocked":
        SB = int(sb)  # 32 unless the caller's seam length forces another divisor
        G_np, H_np, Bm_np, ASB_np = _cached_block_matrices(
            tuple(np.asarray(b, np.float64).tolist()),
            tuple(np.asarray(a, np.float64).tolist()),
            SB,
        )
        # NOTE: only safe for stable filters — the lifted matrices round in the
        # working dtype, and pole powers amplify that for marginally-stable
        # systems (use scan, or split out integrators, in that case).
        batch_shape = xm.shape[1:]
        xf = xm.reshape(T, -1)
        L = xf.shape[1]
        pad = (-T) % SB
        if pad and return_state:
            raise ValueError(
                "return_state with method='blocked' requires the time axis to "
                f"be a multiple of the block size {SB} (got T={T})"
            )
        if pad:
            xf = jnp.concatenate([xf, jnp.zeros((pad, L), xf.dtype)], axis=0)
        nb = xf.shape[0] // SB
        xb = xf.reshape(nb, SB, L)
        G = jnp.asarray(G_np, dtype=rdtype)
        H = jnp.asarray(H_np, dtype=rdtype)
        Bm = jnp.asarray(Bm_np, dtype=rdtype)
        ASB = jnp.asarray(ASB_np, dtype=rdtype)

        # float32-exact accumulation, not TF32
        prec = jax.lax.Precision.HIGHEST
        yP = jnp.einsum("ji,bil->bjl", G, xb, precision=prec)
        sP = jnp.einsum("ni,bil->bnl", Bm, xb, precision=prec)

        def blk(s, sp):
            return ASB @ s + sp, s

        if zi is None:
            s0 = jnp.zeros((N, L), xf.dtype)
        else:
            # zi: batch_shape + (N,) → (N, L), matching the flattened lanes
            s0 = jnp.asarray(zi, dtype=xf.dtype).reshape(-1, N).T
        s_fin, s_prev = jax.lax.scan(blk, s0, sP)
        y = yP + jnp.einsum("jn,bnl->bjl", H, s_prev, precision=prec)
        y = y.reshape(nb * SB, L)[:T].reshape((T,) + batch_shape)
        y = jnp.moveaxis(y, 0, axis)
        if return_state:
            return y, s_fin.T.reshape(batch_shape + (N,))
        return y

    if method == "blocked_cumsum":
        return _iir_cumsum_blocked(b, a, x, axis=axis, zi=zi,
                                   return_state=return_state, sb=sb)

    if method == "parallel":
        if zi is not None or return_state:
            raise ValueError("zi/return_state require method='scan'")
        log2T = max(1, int(np.ceil(np.log2(max(T, 2)))))
        pows = _cached_powers(tuple(map(tuple, A_np)), log2T)
        # c[n] = Bvec * x[n], shape (T, ..., N)
        s = xm[..., None] * Bv
        for k in range(log2T):
            Ak = jnp.asarray(pows[k], dtype=rdtype)
            shift = 1 << k
            if shift >= T:
                break
            s_shifted = jnp.concatenate(
                [jnp.zeros((shift,) + s.shape[1:], s.dtype), s[:-shift]], axis=0
            )
            s = s + jnp.einsum(
                "...j,ij->...i", s_shifted, Ak,
                precision=jax.lax.Precision.HIGHEST,
            )
        s_prev = jnp.concatenate([jnp.zeros((1,) + s.shape[1:], s.dtype), s[:-1]], axis=0)
        y = b0 * xm + s_prev[..., 0]
        return jnp.moveaxis(y, 0, axis)

    raise ValueError(f"unknown IIR method: {method}")


def _iir_cumsum_blocked(b, a, x, axis: int = 0, zi=None, return_state: bool = False,
                        sb: int = 32):
    # Every matmul, einsum and ``@`` of the lifted form runs at HIGHEST
    # precision, set once for the whole body: a reduced-precision default
    # (TF32 on the GPU) costs percent-level error on the integrated signal
    # against the float64 reference (2.6 % was measured with 8-bit
    # mantissas).  Float32-exact accumulation keeps ~1e-6 parity.
    with jax.default_matmul_precision("highest"):
        return _iir_cumsum_blocked_impl(
            b, a, x, axis=axis, zi=zi, return_state=return_state, sb=sb
        )


def _iir_cumsum_blocked_impl(b, a, x, axis: int = 0, zi=None, return_state: bool = False,
                             sb: int = 32):
    """``cumsum(lfilter(b, a, x), axis)`` as ONE lifted blocked pass.

    The RZCC encoder peaks the *integrated* bandpassed signal
    (micloc/spike_encoder.py:115-127 via micloc/xylo_snn_localization.py:344);
    running the integrator as a separate full-length cumsum costs extra HBM
    sweeps, and folding ``[1, -1]`` into the denominator makes the lifted
    matrices marginally stable (they do not survive float32).
    Instead the integrator is *part of the lifted block form* of the stable
    filter: with ``y_blk = G x_blk + H s_in`` the within-block prefix sums are
    ``z_blk = (LT·G) x_blk + (LT·H) s_in + c_in`` (LT = lower-triangular ones)
    and the carried offset updates exactly like a blocked cumsum,
    ``c_out = c_in + 1ᵀG x_blk + 1ᵀH s_in`` — all instability confined to the
    float addition of per-block sums, the same associativity as
    ``cumsum``-of-blocks.  Matches ``cumsum(lfilter(...))`` to float
    associativity; golden-tested against the scipy composition.

    State (``zi`` / returned): batch_shape + (N+1,) — the TDF2 filter state
    with the running integrator total appended.
    """
    SB = int(sb)  # 32 unless the caller's seam length forces another divisor
    b64 = np.asarray(b, np.float64)
    a64 = np.asarray(a, np.float64)
    G_np, H_np, Bm_np, ASB_np = _cached_block_matrices(
        tuple(b64.tolist()), tuple(a64.tolist()), SB
    )
    LT = np.tril(np.ones((SB, SB)))
    G2_np, H2_np = LT @ G_np, LT @ H_np
    g1_np, h1_np = G_np.sum(axis=0), H_np.sum(axis=0)
    N = ASB_np.shape[0]

    x = jnp.asarray(x)
    xm = jnp.moveaxis(x, axis, 0)
    T = xm.shape[0]
    batch_shape = xm.shape[1:]
    rdtype = jnp.real(jnp.zeros((), xm.dtype)).dtype

    xf = xm.reshape(T, -1)
    L = xf.shape[1]
    pad = (-T) % SB
    if pad and return_state:
        raise ValueError(
            "return_state with method='blocked_cumsum' requires the time axis "
            f"to be a multiple of the block size {SB} (got T={T})"
        )
    if pad:
        xf = jnp.concatenate([xf, jnp.zeros((pad, L), xf.dtype)], axis=0)
    nb = xf.shape[0] // SB
    xb = xf.reshape(nb, SB, L)

    G2 = jnp.asarray(G2_np, rdtype)
    H2 = jnp.asarray(H2_np, rdtype)
    Bm = jnp.asarray(Bm_np, rdtype)
    ASB = jnp.asarray(ASB_np, rdtype)
    g1 = jnp.asarray(g1_np, rdtype)
    h1 = jnp.asarray(h1_np, rdtype)

    zP = jnp.einsum("ji,bil->bjl", G2, xb)  # within-block prefix sums of y
    cP = jnp.einsum("i,bil->bl", g1, xb)  # per-block sums of y

    if zi is None:
        s0 = jnp.zeros((N, L), xf.dtype)
        c0 = jnp.zeros((L,), xf.dtype)
    else:
        zif = jnp.asarray(zi, xf.dtype).reshape(-1, N + 1)
        s0 = zif[:, :N].T
        c0 = zif[:, N]

    # ---- second lifting level: collapse Q level-1 steps into matmuls.
    # Q = largest divisor of nb keeping the (Q·N)² map small; Q == 1 (e.g.
    # prime nb) or a filter without a well-conditioned modal basis falls
    # back to the plain level-1 scan below.
    Qmax = max(1, 512 // max(N, 1))
    Q = max((q for q in range(1, min(nb, Qmax) + 1) if nb % q == 0), default=1)
    lvl2 = (
        _cached_level2_matrices(tuple(b64.tolist()), tuple(a64.tolist()), SB, Q)
        if Q > 2
        else None
    )
    if lvl2 is not None:
        (Ws_np, Ps_np, Bm2_np, h1m_np, Hc_np, sumh_np, LTex_np, ASBQ_np,
         T_np, Tinv_np, Bmm_np, H2m_np) = lvl2
        nb2 = nb // Q
        Ws = jnp.asarray(Ws_np, rdtype)
        Ps = jnp.asarray(Ps_np, rdtype)
        h1m = jnp.asarray(h1m_np, rdtype)
        Hc = jnp.asarray(Hc_np, rdtype)
        sum_h = jnp.asarray(sumh_np, rdtype)
        LTex = jnp.asarray(LTex_np, rdtype)
        ASBQ = jnp.asarray(ASBQ_np, rdtype)
        Tm = jnp.asarray(T_np, rdtype)
        Tinv = jnp.asarray(Tinv_np, rdtype)
        Bm2 = jnp.asarray(Bm2_np, rdtype)

        # modal-basis input increments; the carried state converts at the seam
        sP = jnp.einsum("ni,bil->bnl", jnp.asarray(Bmm_np, rdtype), xb)
        s0 = Tinv @ s0
        sP2 = sP.reshape(nb2, Q * N, L)
        cP2 = cP.reshape(nb2, Q, L)
        # input-driven parts of all Q inner states/offsets, batched matmuls
        U = jnp.einsum("ab,ibl->ial", Ws, sP2)  # (nb2, Q·N, L)
        V = jnp.einsum("nb,ibl->inl", Bm2, sP2)  # (nb2, N, L)
        e = cP2 + jnp.einsum("n,iqnl->iql", h1m, U.reshape(nb2, Q, N, L))
        cumE = jnp.einsum("pq,iql->ipl", LTex, e)  # exclusive in-super prefix
        sumE = e.sum(axis=1)  # (nb2, L)

        # outer scan: nb2 sequential steps (vs nb for level 1)
        def blk2(carry, inp):
            s, c = carry
            U_i, V_i, cumE_i, sumE_i = inp
            s_prev_i = U_i + Ps @ s  # (Q·N, L): states entering each block
            c_prev_i = c[None, :] + cumE_i + Hc @ s
            s_next = ASBQ @ s + V_i
            c_next = c + sumE_i + sum_h @ s
            return (s_next, c_next), (s_prev_i, c_prev_i)

        (s_fin, c_fin), (s_prev2, c_prev2) = jax.lax.scan(
            blk2, (s0, c0), (U, V, cumE, sumE)
        )
        s_prev = s_prev2.reshape(nb, N, L)
        c_prev = c_prev2.reshape(nb, L)
        s_fin = Tm @ s_fin  # back to the TDF2 basis for the carried state
        Hout = jnp.asarray(H2m_np, rdtype)
    else:
        sP = jnp.einsum("ni,bil->bnl", Bm, xb)

        def blk(carry, inp):
            s, c = carry
            sP_b, cP_b = inp
            c_next = c + cP_b + h1 @ s
            s_next = ASB @ s + sP_b
            return (s_next, c_next), (s, c)

        (s_fin, c_fin), (s_prev, c_prev) = jax.lax.scan(blk, (s0, c0), (sP, cP))
        Hout = H2
    z = zP + jnp.einsum("jn,bnl->bjl", Hout, s_prev) + c_prev[:, None, :]
    z = z.reshape(nb * SB, L)[:T].reshape((T,) + batch_shape)
    z = jnp.moveaxis(z, 0, axis)
    if return_state:
        state = jnp.concatenate([s_fin.T, c_fin[:, None]], axis=1)
        return z, state.reshape(batch_shape + (N + 1,))
    return z
