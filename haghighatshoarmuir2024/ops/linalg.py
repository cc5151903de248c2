"""Batched linear-algebra primitives for beamforming design.

The reference does one SVD / generalized eigenproblem per DoA in a Python loop
(micloc/beamformer.py:157-190, micloc/snn_beamformer.py:181-203).  Here every
routine is written for a single matrix and is ``vmap``-ed over the DoA grid by
the callers, so the whole design lowers to batched XLA eigendecompositions.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

# eigvec products at full float32, not TF32
_HIGHEST = jax.lax.Precision.HIGHEST


def top_eigvec_psd(C):
    """Dominant eigenvector of a PSD (Hermitian) matrix.

    Equals ``U[:, 0]`` of ``np.linalg.svd(C)`` for PSD C up to a unit phase
    (micloc/beamformer.py:160-161).  Uses ``eigh`` (batched-friendly).
    """
    w, v = jnp.linalg.eigh(C)
    return v[..., :, -1]


def svd_singvals_psd(C):
    """Singular values of a PSD matrix in descending order (== eigh reversed)."""
    w = jnp.linalg.eigvalsh(C)
    return w[..., ::-1]


def dc_removed_sing_vec(C, iters: int = 80):
    """Dominant-eigenvalue direction of PSD ``C`` constrained orthogonal to the
    all-ones vector.

    Reimplements ``SNNBeamformer._find_dc_removed_sing_vec``
    (micloc/snn_beamformer.py:372-422): with C = U diag(D) U^T and
    theta = U^T 1, bisection finds the root u* of the secular equation
    sum_i theta_i^2 / (D_i - u) = 0 on (D[1], D[0]); the constrained vector is
    U (theta / (D - u*)), normalized.  The reference bisects until a relative
    precision of 1e-8; a fixed ``iters`` bisections (vmappable, jittable)
    converges far below float64 resolution.

    Needed because unipolar spikes + positive neuron kernels give the
    covariance a dominant DC component.
    """
    w, U = jnp.linalg.eigh(C)
    # descending order to mirror np.linalg.svd's D
    D = w[..., ::-1]
    U = U[..., :, ::-1]
    ones = jnp.ones(C.shape[-1], dtype=C.dtype)
    theta = jnp.einsum("...ij,...i->...j", U, ones, precision=_HIGHEST)

    u_min = D[..., 1]
    u_max = D[..., 0]

    def body(_, carry):
        u_min, u_max = carry
        u_mid = (u_min + u_max) / 2
        val = jnp.sum(theta**2 / (D - u_mid[..., None]), axis=-1)
        neg = val < 0.0
        return jnp.where(neg, u_mid, u_min), jnp.where(neg, u_max, u_mid)

    u_min, u_max = jax.lax.fori_loop(0, iters, body, (u_min, u_max))
    root = (u_min + u_max) / 2.0
    # Degenerate guard: with EXACTLY tied top eigenvalues (D0 == D1 — real
    # for float32-exact covariances of structured spike trains; the earlier
    # bf16 covariance perturbed such ties apart) the bracket is empty, the
    # root lands on the eigenvalue and theta/(D - root) is 0/0 -> NaN, which
    # silently zeroed whole unipolar designs.  Clamp the denominator at a
    # scale-relative epsilon: the weight then concentrates on the tied
    # leading directions, which is the correct constrained maximizer there.
    denom = D - root[..., None]
    tiny = 1e-7 * jnp.maximum(jnp.abs(D[..., :1]), 1e-30)
    denom = jnp.where(
        jnp.abs(denom) < tiny, jnp.where(denom < 0, -tiny, tiny), denom
    )
    vec = jnp.einsum("...ij,...j->...i", U, theta / denom, precision=_HIGHEST)
    return vec / jnp.linalg.norm(vec, axis=-1, keepdims=True)


def generalized_top_eigvec(C, B, eps: float = 0.0):
    """Top generalized eigenvector of ``C v = lambda B v`` via Cholesky
    whitening — the interference-removal design path
    (micloc/beamformer.py:165-190 uses ``scipy.linalg.eigh(C, B)`` and takes
    the last column).

    B must be PD (the reference adds diagonal loading to ensure this).
    Returns the unit-norm eigenvector of the largest eigenvalue.
    """
    n = C.shape[-1]
    if eps:
        B = B + eps * jnp.eye(n, dtype=B.dtype)
    L = jnp.linalg.cholesky(B)
    # M = L^-1 C L^-H
    Linv_C = jax.scipy.linalg.solve_triangular(L, C, lower=True)
    M = jax.scipy.linalg.solve_triangular(
        L, Linv_C.conj().swapaxes(-1, -2), lower=True
    ).conj().swapaxes(-1, -2)
    M = (M + M.conj().swapaxes(-1, -2)) / 2
    _, V = jnp.linalg.eigh(M)
    u = V[..., :, -1]
    # back-transform: v = L^-H u
    v = jax.scipy.linalg.solve_triangular(
        L.conj().swapaxes(-1, -2), u[..., None], lower=False
    )[..., 0]
    return v / jnp.linalg.norm(v, axis=-1, keepdims=True)


def fold_complex_cov(C):
    """Fold a real 2M x 2M covariance of the stacked [real || imag] signal into
    the rotation-invariant M x M complex Hermitian form used for bipolar SNN
    beamforming (micloc/snn_beamformer.py:188-199):

        C_diag = (C[:M,:M] + C[M:,M:]) / 2
        C_off  = (C[:M,M:] + C[M:,:M].T) / 2
        C_comp = C_diag + 1j * C_off
    """
    m = C.shape[-1] // 2
    C_diag = (C[..., :m, :m] + C[..., m:, m:]) / 2
    C_off = (C[..., :m, m:] + C[..., m:, :m].swapaxes(-1, -2)) / 2
    return C_diag + 1j * C_off


def unfold_complex_vec(u):
    """Complex M-vector -> real 2M beamforming vector [Re(u) || Im(u)]
    (micloc/snn_beamformer.py:203)."""
    return jnp.concatenate([jnp.real(u), jnp.imag(u)], axis=-1)
