"""Inputs and comparisons shared by the complex test files of the port
(``test_torch_complex_*.py``): complex64 and complex128 at n ∈ {1, 2, 7,
33, 130}, made from a numpy seed; faer's 8·n·eps rule of the dtype
(``faer_tpu_torch/utils/approx.py``)."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import torch

from faer_tpu_torch.utils.approx import assert_approx_eq

DTYPES = {"c64": (torch.complex64, np.complex64), "c128": (torch.complex128, np.complex128)}
SIZES = (1, 2, 7, 33, 130)


def eps(npdt) -> float:
    return float(np.finfo(npdt).eps)


def inputs(n, npdt, seed=0, m=None):
    """(g gᴴ/n + I, (g + gᴴ)/2, an (m or n, 3) right-hand side, g) with g
    an (m or n, n) complex Gaussian."""
    rng = np.random.default_rng(1000 * n + seed)
    m = m or n
    g = rng.standard_normal((m, n)) + 1j * rng.standard_normal((m, n))
    b = rng.standard_normal((m, 3)) + 1j * rng.standard_normal((m, 3))
    k = min(m, n)
    sq = g[:k, :k]
    return ((sq @ sq.conj().T / k + np.eye(k)).astype(npdt),
            ((sq + sq.conj().T) / 2).astype(npdt), b.astype(npdt), g.astype(npdt))


def close(got, want, n, npdt, msg=""):
    """Entrywise within 8·n·eps, absolutely against the largest entry."""
    got, want = np.asarray(got), np.asarray(want)
    tol = 8 * n * eps(npdt) * max(np.abs(want).max(initial=0.0), 1e-30)
    assert_approx_eq(got, want, abs_tol=tol, scale=8 * n, msg=msg)


def backward(a, x, b, n, npdt):
    """‖A x − b‖ / (‖A‖ ‖x‖) in complex128 within 8·n·eps."""
    a, x = np.asarray(a, np.complex128), np.asarray(x, np.complex128)
    r = np.linalg.norm(a @ x - b) / (np.linalg.norm(a) * max(np.linalg.norm(x), 1e-300))
    assert r <= 8 * n * eps(npdt), r


def lstsq_backward(a, x, b, n, npdt):
    """The least-squares optimality ‖Aᴴ r‖ / (‖A‖ ‖r‖) within 8·n·eps."""
    a, x = np.asarray(a, np.complex128), np.asarray(x, np.complex128)
    r = b - a @ x
    q = np.linalg.norm(a.conj().T @ r) / (np.linalg.norm(a) * max(np.linalg.norm(r), 1e-300))
    assert q <= 8 * n * eps(npdt), q


def pair(x):
    """A complex array as the JAX package's (re, im) pair."""
    return jnp.asarray(x.real), jnp.asarray(x.imag)


def from_pair(re, im):
    return np.asarray(re) + 1j * np.asarray(im)


def phase_aligned(v, ref):
    """``v``'s columns each times the unit phase that best aligns it with
    ``ref``'s (eigen- and singular vectors are unique up to one)."""
    v, ref = np.asarray(v, np.complex128), np.asarray(ref, np.complex128)
    dots = np.sum(v.conj() * ref, axis=0)
    ph = np.where(np.abs(dots) == 0, 1.0, dots / np.where(np.abs(dots) == 0, 1.0, np.abs(dots)))
    return v * ph[None, :]


def vectors_close(v, ref, values, n, npdt, phases=None):
    """Each column of ``v`` times a unit phase (``phases``, else the one
    that best aligns it) equals ``ref``'s within 8·n·eps·max(1, spread/gap)
    of the column's largest entry: the first-order bound of a vector
    whose value (of ``values``, the oracle's) is ``gap`` from the nearest
    other one (Davis–Kahan)."""
    v, ref = np.asarray(v, np.complex128), np.asarray(ref, np.complex128)
    w = np.asarray(values, np.float64)
    spread = max(np.abs(w).max(), 1e-300)
    gap = np.array([np.min(np.abs(np.delete(w, i) - w[i]), initial=np.inf)
                    for i in range(len(w))])
    cond = np.maximum(1.0, spread / np.maximum(gap, 1e-300))
    va = v * phases[None, :] if phases is not None else phase_aligned(v, ref)
    err = np.abs(va - ref).max(axis=0, initial=0.0)
    bound = 8 * n * eps(npdt) * cond * np.abs(ref).max(axis=0, initial=0.0)
    assert np.all(err <= bound), (err / bound).max()


def hess_input(n, npdt, seed=0, scale=1.0):
    """A complex Gaussian upper-Hessenberg matrix times ``scale``."""
    rng = np.random.default_rng(7000 + 10 * n + seed)
    g = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    return (np.triu(g, -1) * scale).astype(npdt)


def schur_backward(a, t, q):
    """The Schur step's A = Q T Qᴴ in complex128: ‖A − QTQᴴ‖_F/‖A‖_F,
    max|QᴴQ − I| and the backward error η = ‖A − QTQᴴ‖₂ + ‖A‖₂‖QᴴQ − I‖₂ of
    T's eigenvalues."""
    a, t, q = (np.asarray(x, np.complex128) for x in (a, t, q))
    e = a - q @ t @ q.conj().T
    f = q.conj().T @ q - np.eye(a.shape[0])
    an = np.linalg.norm(a)
    return (np.linalg.norm(e) / an if an else np.linalg.norm(e), np.abs(f).max(),
            np.linalg.norm(e, 2) + np.linalg.norm(a, 2) * np.linalg.norm(f, 2))


def eig_ratio(w, a, eta, other=None):
    """How far the eigenvalues ``w`` lie from f64 ``scipy.linalg.eig`` of
    ``a`` (or from ``other``, another computation's eigenvalues of ``a``)
    against each reference eigenvalue's bound 2·κ_i·η (κ_i =
    ‖x_i‖‖y_i‖/|y_iᴴx_i| from scipy's left and right vectors, η a backward
    error, doubled for the reference's own error of the same kind; η is
    taken at least n·eps_f64·‖A‖₂, LAPACK's own backward error, where a
    complex128 step at a small n errs less than the reference does): the
    largest ratio, each eigenvalue matched to the nearest of the other set
    in both directions (a different rounding can order a Schur diagonal
    differently)."""
    import scipy.linalg

    a = np.asarray(a, np.complex128)
    eta = max(eta, a.shape[0] * float(np.finfo(np.float64).eps) * np.linalg.norm(a, 2))
    lam, yl, xr = scipy.linalg.eig(a, left=True, right=True)
    kappa = (np.linalg.norm(yl, axis=0) * np.linalg.norm(xr, axis=0)
             / np.abs(np.sum(yl.conj() * xr, axis=0)))
    ref = lam if other is None else np.asarray(other, np.complex128)
    if other is not None:  # each of other's eigenvalues takes κ of scipy's nearest
        kappa = kappa[np.abs(ref[:, None] - lam[None, :]).argmin(axis=1)]
    w = np.asarray(w, np.complex128)
    dist = np.abs(w[:, None] - ref[None, :])
    tol = np.maximum(2 * kappa * eta, np.finfo(np.float64).tiny)
    near_ref = dist.argmin(axis=1)
    return max((dist.min(axis=1) / tol[near_ref]).max(), (dist.min(axis=0) / tol).max())


def pencil_input(n, npdt, seed=0, scale=1.0, rank=None):
    """A complex Gaussian pencil (A, B) times ``scale``; B of rank ``rank``
    (a product of Gaussian n × rank and rank × n factors) when given."""
    rng = np.random.default_rng(9000 + 10 * n + seed)

    def cg(*shape):
        return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)

    a, b = cg(n, n), cg(n, n)
    if rank is not None:
        b = cg(n, rank) @ cg(rank, n)
    return (a * scale).astype(npdt), (b * scale).astype(npdt)


def qz_backward(a, b, s, t, q, z):
    """The QZ step's A = Q S Zᴴ, B = Q T Zᴴ in complex128:
    ‖A − QSZᴴ‖_F/‖A‖_F, ‖B − QTZᴴ‖_F/‖B‖_F, max|QᴴQ − I|, max|ZᴴZ − I| and
    the backward error η = ‖(A − QSZᴴ, B − QTZᴴ)‖₂ + ‖(A, B)‖₂·max(‖QᴴQ −
    I‖₂, ‖ZᴴZ − I‖₂) of (S, T)'s eigenvalues."""
    a, b, s, t, q, z = (np.asarray(x, np.complex128) for x in (a, b, s, t, q, z))
    n = a.shape[0]
    ea, eb = a - q @ s @ z.conj().T, b - q @ t @ z.conj().T
    fq, fz = q.conj().T @ q - np.eye(n), z.conj().T @ z - np.eye(n)
    ab = np.hypot(np.linalg.norm(a, 2), np.linalg.norm(b, 2))
    eta = np.hypot(np.linalg.norm(ea, 2), np.linalg.norm(eb, 2)) \
        + ab * max(np.linalg.norm(fq, 2), np.linalg.norm(fz, 2))
    return (np.linalg.norm(ea) / max(np.linalg.norm(a), 1e-300),
            np.linalg.norm(eb) / max(np.linalg.norm(b), 1e-300),
            np.abs(fq).max(), np.abs(fz).max(), eta)


def chordal_ratio(alpha, beta, a, b, eta, other=None):
    """How far the (α, β) pairs lie from f64 ``scipy.linalg.eig`` of the
    pencil (a, b) (or from ``other``, another computation's (α, β)) in the
    chordal metric |αβ̂ − α̂β|/(‖(α, β)‖‖(α̂, β̂)‖), against each reference
    eigenvalue's bound 2·κ_i·η (κ_i = ‖x_i‖‖y_i‖/‖(y_iᴴAx_i, y_iᴴBx_i)‖
    from scipy's left and right vectors, η a backward error, doubled for
    the reference's own error; η is taken at least n·eps_f64·‖(A, B)‖₂):
    the largest ratio, each eigenvalue matched to the nearest of the other
    set in both directions."""
    import scipy.linalg

    a, b = np.asarray(a, np.complex128), np.asarray(b, np.complex128)
    n = a.shape[0]
    eta = max(eta, n * float(np.finfo(np.float64).eps)
              * np.hypot(np.linalg.norm(a, 2), np.linalg.norm(b, 2)))
    (ra, rb), yl, xr = scipy.linalg.eig(a, b, left=True, right=True, homogeneous_eigvals=True)
    kappa = (np.linalg.norm(yl, axis=0) * np.linalg.norm(xr, axis=0)
             / np.hypot(np.abs(np.sum(yl.conj() * (a @ xr), axis=0)),
                        np.abs(np.sum(yl.conj() * (b @ xr), axis=0))))
    if other is not None:  # each of other's eigenvalues takes κ of scipy's nearest
        oa, ob = (np.asarray(x, np.complex128) for x in other)
        near = _chordal(oa, ob, ra, rb).argmin(axis=1)
        ra, rb, kappa = oa, ob, kappa[near]
    chord = _chordal(np.asarray(alpha, np.complex128), np.asarray(beta, np.complex128), ra, rb)
    tol = np.maximum(2 * kappa * eta, np.finfo(np.float64).tiny)
    near_ref = chord.argmin(axis=1)
    return max((chord.min(axis=1) / tol[near_ref]).max(), (chord.min(axis=0) / tol).max())


def _chordal(al, be, ra, rb):
    """The chordal distances between the pairs (al, be) (rows) and (ra, rb)
    (columns)."""
    return (np.abs(al[:, None] * rb[None, :] - ra[None, :] * be[:, None])
            / (np.hypot(np.abs(al), np.abs(be))[:, None]
               * np.hypot(np.abs(ra), np.abs(rb))[None, :]))


def pencil_residual(a, b, alpha, beta, v):
    """max_k ‖A v_k β_k − B v_k α_k‖ / ((‖A‖₂|β_k| + ‖B‖₂|α_k|)‖v_k‖) in
    complex128."""
    a, b, al, be, v = (np.asarray(x, np.complex128) for x in (a, b, alpha, beta, v))
    num = np.linalg.norm(a @ v * be[None, :] - b @ v * al[None, :], axis=0)
    den = ((np.linalg.norm(a, 2) * np.abs(be) + np.linalg.norm(b, 2) * np.abs(al))
           * np.linalg.norm(v, axis=0))
    return (num / den).max()
