"""Eigendecompositions (counterpart of ``faer_tpu/linalg/evd.py``).

* Self-adjoint — faer ``self_adjoint_evd`` (``evd/mod.rs:270``):
  tridiagonalize (``tridiag_in_place``), solve the tridiagonal
  (``tridiag_evd``: divide & conquer for n ≥ 512, else the QR iteration,
  both through the ``tridiag_sweep`` kernel), then back-transform with the
  reflectors (``tridiag_apply_q``). Eigenvalues ascending.
* General real — faer ``evd_real`` (``evd/mod.rs:1213``): Hessenberg
  reduction (``hessenberg_blocked``, faer ``hessenberg.rs:549``), the real
  Schur form (:func:`_real_schur_dispatch`: multishift QR with aggressive
  early deflation from n = 128, the lahqr-class double-shift iteration
  below it, one ``real_schur`` kernel launch), the eigenvalues of its
  1×1 and 2×2 blocks and the quasi-triangular eigenvectors
  (``eigvec.py``), back-transformed by Q. ``evd_pair`` and
  ``eigenvalues_pair`` return (re, im) pairs as the JAX package does;
  ``evd`` and ``eigenvalues`` combine them into native complex tensors
  (``torch.complex``), on the input's device.
* General complex — faer ``evd_cplx`` (``evd/mod.rs:1180``): the unitary
  Hessenberg reduction (the same ``hessenberg_blocked``, conjugating), the
  complex Schur form (:func:`_complex_schur_dispatch`: multishift QR with
  AED from n = 128, each AED window one ``complex_schur`` kernel launch,
  below it one direct launch; faer's dispatch, ``complex_schur.rs:631``,
  and the JAX package's pair route's, ``evd_cpair._schur_auto``), w =
  diag(T), the triangular eigenvectors (``eigvec.triangular_eigenvectors``)
  and V = Q·X, all in the input's dtype.

The self-adjoint EVD takes float32, float64, complex64 and complex128:
Hermitian input reduces to a real tridiagonal (real d, e), whose QR
iteration is the same one batched launch as for the real dtypes, and the
back-transform is complex (``A = V diag(w) Vᴴ``, w real). The general EVD
takes the same four dtypes.
"""
from __future__ import annotations

import torch

from faer_tpu_torch.core import dtypes
from faer_tpu_torch.core.config import check_f32_policy
from faer_tpu_torch.core.errors import ShapeError
from faer_tpu_torch.core.flags import Side
from faer_tpu_torch.linalg.complex_schur import complex_schur  # noqa: F401 (evd.complex_schur)
from faer_tpu_torch.linalg.tridiag import tridiag_apply_q, tridiag_in_place
from faer_tpu_torch.linalg.tridiag_evd import tridiag_evd
from faer_tpu_torch.ops.householder import (
    apply_block_on_left,
    apply_block_on_right,
    make_householder,
)
from faer_tpu_torch.ops.matmul import matmul


def _full_from_lower(a, name: str):
    if a.dim() != 2 or a.shape[0] != a.shape[1]:
        raise ShapeError(f"{name}: needs a square matrix, got {tuple(a.shape)}")
    dtypes.require_field(a, name)
    if a.is_cuda:
        check_f32_policy()
    return torch.tril(a) + torch.tril(a, -1).mH


def self_adjoint_evd(a):
    """Full self-adjoint EVD of the lower triangle of ``a``.

    Returns ``(w, v, info)`` with ``A = V diag(w) Vᴴ``, w real ascending,
    V of a's dtype.
    """
    full = _full_from_lower(a, "self_adjoint_evd")
    d, e, hh, taus = tridiag_in_place(full)
    w, z, info = tridiag_evd(d, e, want_vectors=True)
    return w, tridiag_apply_q(hh, taus, z), info


def self_adjoint_eigenvalues(a, side: Side = Side.LOWER):
    """Eigenvalues (ascending) of the self-adjoint matrix stored in the
    ``side`` triangle of ``a``."""
    full = _full_from_lower(a if side is Side.LOWER else a.mH,
                            "self_adjoint_eigenvalues")
    d, e, _, _ = tridiag_in_place(full)
    w, _, _ = tridiag_evd(d, e, want_vectors=False)
    return w


def self_adjoint_pseudoinverse(a, tol=None):
    """Pseudo-inverse via the self-adjoint EVD (faer ``evd/pseudoinverse.rs``):
    eigenvalues at most ``tol`` in magnitude (default max|w|·n·eps) are
    dropped."""
    w, v, _ = self_adjoint_evd(a)
    aw = w.abs()
    if tol is None:
        tol = aw.max() * a.shape[0] * dtypes.eps(a.dtype)
    winv = torch.where(aw > tol, 1.0 / torch.where(w == 0, torch.ones_like(w), w),
                       torch.zeros_like(w))
    return matmul(None, v * winv[None, :], v.mH)


# ---------------------------------------------------------------------------
# Hessenberg reduction
# ---------------------------------------------------------------------------

def _square(a, name: str, *, real: bool = False):
    if a.dim() != 2 or a.shape[0] != a.shape[1]:
        raise ShapeError(f"{name}: needs a square matrix, got {tuple(a.shape)}")
    dtypes.require_field(a, name)
    if real and a.is_complex():
        raise TypeError(f"{name}: real input (the (re, im) pair form of the real EVD); "
                        "complex input takes evd / eigenvalues")
    if a.is_cuda:
        check_f32_policy()


def hessenberg_in_place(a):
    """Unitary reduction to upper Hessenberg: ``(h, q)`` with A = Q H Qᴴ
    (faer ``hessenberg_in_place``, ``hessenberg.rs:549``), one reflector
    H = I − τ v vᴴ a column, A ← Hᴴ A H applied to the rows and columns it
    changes and Q ← Q H (the JAX package applies it, masked, to the whole
    matrix). Real input conjugates nothing: ``conj`` of a real tensor is
    the tensor itself, so its operations are those of the real reduction.
    New tensors."""
    n = a.shape[0]
    q = torch.eye(n, dtype=a.dtype, device=a.device)
    h = a.clone()
    if n <= 2:
        return h, q
    for j in range(n - 2):
        v, tau, _ = make_householder(h[j + 1:, j])
        vc = v.conj()
        # A ← Hᴴ A H, Q ← Q H, acting on rows/columns j+1..
        w = matmul(None, vc[None, :], h[j + 1:, :])[0]
        h[j + 1:, :] -= tau.conj() * v[:, None] * w[None, :]
        u = matmul(None, h[:, j + 1:], v[:, None])[:, 0]
        h[:, j + 1:] -= tau * u[:, None] * vc[None, :]
        uq = matmul(None, q[:, j + 1:], v[:, None])[:, 0]
        q[:, j + 1:] -= tau * uq[:, None] * vc[None, :]
    return torch.triu(h, -1), q


def _hess_panel(t, bw: int):
    """lahr2-style Hessenberg panel on the trailing block ``t`` (m × m):
    ``bw`` reflectors with DEFERRED two-sided updates. Keeps ``P = Vᴴ A0``
    (two matvecs a step are the only O(m²) work) and the compact-WY ``T``,
    so that the virtually updated matrix is
    ``A = A0 − V (TᴴP) − (RT) Vᴴ + V (Tᴴ (PV) T) Vᴴ`` with ``R = A0 V``
    (the JAX package's ``:124-190``; for real input ``ᴴ`` is ``ᵀ``).
    Returns (V, T, P, R, PV, e_p), e_p the subdiagonal betas; the caller
    forms the trailing update and the Hessenberg columns."""
    m = t.shape[0]
    z = t.new_zeros
    v_p, t_p, p_p = z((m, bw)), z((bw, bw)), z((bw, m))
    r_p, pv, e_p = z((m, bw)), z((bw, bw)), z(bw)
    for i in range(bw):
        # virtual column i
        tv = matmul(None, t_p, v_p[i, :, None].conj())
        c = t[:, i] - matmul(None, v_p, matmul(None, t_p.mH, p_p[:, i, None]))[:, 0]
        c = c - matmul(None, r_p, tv)[:, 0]
        c = c + matmul(None, v_p, matmul(None, t_p.mH, matmul(None, pv, tv)))[:, 0]
        # reflector pivoting at row i + 1
        vt, tau, beta = make_householder(c[i + 1:])
        v = torch.cat([t.new_zeros(i + 1), vt])
        # grow T: T ← [[T, −τ T (Vᴴ v)], [0, τ]]
        t_p[:, i] = (-tau) * matmul(None, t_p, matmul(None, v_p.mH, v[:, None]))[:, 0]
        t_p[i, i] = tau
        # grow P, R and PV: two matvecs against A0
        p_new = matmul(None, v.conj()[None, :], t)[0]
        p_p[i] = p_new
        r_p[:, i] = matmul(None, t, v[:, None])[:, 0]
        pv[i] = matmul(None, p_new[None, :], v_p)[0]
        pv[:, i] = matmul(None, p_p, v[:, None])[:, 0]
        e_p[i] = beta
        v_p[:, i] = v
    return v_p, t_p, p_p, r_p, pv, e_p


def hessenberg_blocked(a, *, block: int = 96):
    """Blocked Hessenberg reduction, the contract of
    :func:`hessenberg_in_place` (faer's blocked ``hessenberg.rs:549``):
    panels of ``block`` defer their two-sided updates (:func:`_hess_panel`);
    the trailing blocks and the accumulation of Q are compact-WY products.
    Sizes up to max(2·block, 192) take :func:`hessenberg_in_place`."""
    n = a.shape[0]
    if n <= max(2 * block, 192):
        return hessenberg_in_place(a)
    panels = []
    h = a.clone()
    j0 = 0
    while n - j0 > 2 * block:
        bw = block
        m = n - j0
        t = h[j0:, j0:]
        v_p, t_p, p_p, r_p, pv, e_p = _hess_panel(t, bw)
        # A1 = (I − V T Vᴴ)ᴴ A0 (I − V T Vᴴ) on the trailing block
        w_full = matmul(None, t_p.mH, p_p)
        y_full = matmul(None, r_p, t_p)
        cross = matmul(None, t_p.mH, matmul(None, pv, t_p))
        t_new = t - matmul(None, v_p, w_full) - matmul(
            None, y_full - matmul(None, v_p, cross), v_p.mH)
        # the strip above the trailing block: A[:j0, j0:] · H
        h[:j0, j0:] = apply_block_on_right(v_p, t_p, h[:j0, j0:], adjoint=False)
        # the panel's Hessenberg columns exactly: the virtual columns' heads,
        # beta on the subdiagonal, zeros below
        rows = torch.arange(m, device=a.device)[:, None]
        cols = torch.arange(bw, device=a.device)[None, :]
        t_new[:, :bw] = (torch.where(rows <= cols, t_new[:, :bw], 0.0)
                         + torch.where(rows == cols + 1, e_p[None, :], 0.0))
        h[j0:, j0:] = t_new
        panels.append((j0, v_p, t_p))
        j0 += bw
    h_t, q_t = hessenberg_in_place(h[j0:, j0:])
    h[j0:, j0:] = h_t
    # the tail's similarity also right-updates the strip above it
    h[:j0, j0:] = matmul(None, h[:j0, j0:], q_t)
    # Q = (panel blocks) · Q_tail, the blocks applied by compact-WY products
    q = torch.zeros_like(a)
    q[j0:, j0:] = q_t
    q[:j0, :j0] = torch.eye(j0, dtype=a.dtype, device=a.device)
    for pj0, v_p, t_p in reversed(panels):
        q[pj0:] = apply_block_on_left(v_p, t_p, q[pj0:], adjoint=False)
    return h, q


# ---------------------------------------------------------------------------
# the general real EVD
# ---------------------------------------------------------------------------

#: below this size the lahqr-class double-shift iteration wins (faer routes
#: small blocks to ``lahqr`` the same way, ``real_schur.rs:2353``)
_MULTISHIFT_MIN_N = 128


def _real_schur_dispatch(h, q, *, max_sweeps_factor: int):
    """Hessenberg → real Schur: multishift QR + AED from
    ``_MULTISHIFT_MIN_N`` on (O(n/ns) sweeps, GEMM-bound far-field
    updates), the lahqr-class double-shift iteration below it."""
    if h.shape[0] >= _MULTISHIFT_MIN_N:
        from faer_tpu_torch.linalg.schur_multishift import multishift_real_schur

        return multishift_real_schur(h, q)
    from faer_tpu_torch.linalg.real_schur import real_schur

    return real_schur(h, q, max_sweeps_factor=max_sweeps_factor)


def evd_pair(a, *, max_sweeps_factor: int = 30):
    """General REAL eigendecomposition as (re, im) pairs: ``((wr, wi),
    (vr, vi), info)`` with A (vr + i·vi)_k = (wr + i·wi)_k (vr + i·vi)_k;
    conjugate eigenpairs are adjacent, each eigenvector of unit 2-norm.
    faer ``evd_real`` (``evd/mod.rs:1213``)."""
    from faer_tpu_torch.linalg.eigvec import quasi_triangular_eigenvectors_pair
    from faer_tpu_torch.linalg.real_schur import schur_eigenvalues_pair

    _square(a, "evd_pair", real=True)
    h, q = hessenberg_blocked(a)
    t, qs, info = _real_schur_dispatch(h, q, max_sweeps_factor=max_sweeps_factor)
    wr, wi = schur_eigenvalues_pair(t)
    xr, xi = quasi_triangular_eigenvectors_pair(t, wr, wi)
    return (wr, wi), (matmul(None, qs, xr), matmul(None, qs, xi)), info


def eigenvalues_pair(a, *, max_sweeps_factor: int = 30):
    """Eigenvalues of a real matrix as ``(re, im)``: conjugate pairs
    adjacent, in the order of the Schur form's diagonal."""
    from faer_tpu_torch.linalg.real_schur import schur_eigenvalues_pair

    _square(a, "eigenvalues_pair", real=True)
    h, q = hessenberg_blocked(a)
    t, _, _ = _real_schur_dispatch(h, q, max_sweeps_factor=max_sweeps_factor)
    return schur_eigenvalues_pair(t)


def _complex_schur_dispatch(h, q, *, max_sweeps_factor: int):
    """Complex Hessenberg → complex Schur: multishift QR + AED from
    ``_MULTISHIFT_MIN_N`` on, every AED window one ``complex_schur``
    launch; below it one direct launch of the single-shift iteration."""
    if h.shape[0] >= _MULTISHIFT_MIN_N:
        from faer_tpu_torch.linalg.schur_multishift import multishift_complex_schur

        return multishift_complex_schur(h, q)
    from faer_tpu_torch.linalg.complex_schur import complex_schur

    return complex_schur(h, q, max_sweeps_factor=max_sweeps_factor)


def _evd_complex(a, *, max_sweeps_factor: int, vectors: bool):
    """The complex EVD (module docstring): ``(w, v, info)``, v None without
    ``vectors``."""
    from faer_tpu_torch.linalg.eigvec import triangular_eigenvectors

    h, q = hessenberg_blocked(a)
    t, qs, info = _complex_schur_dispatch(h, q, max_sweeps_factor=max_sweeps_factor)
    w = t.diagonal().clone()
    if not vectors:
        return w, None, info
    return w, matmul(None, qs, triangular_eigenvectors(t)), info


def _combine_pair(re, im):
    """re + i·im as a native complex tensor on their device."""
    return torch.complex(re, im)


def evd(a, *, max_sweeps_factor: int = 30):
    """General eigendecomposition: ``(w, v, info)`` with A v_k = w_k v_k,
    each v_k of unit 2-norm, w and v complex (complex64 from float32 and
    complex64, complex128 from float64 and complex128). Real input: faer
    ``evd_real`` (``evd/mod.rs:1213``), conjugate pairs adjacent; complex
    input: ``evd_cplx`` (``:1180``), the complex Schur form's diagonal
    order."""
    _square(a, "evd")
    if a.is_complex():
        return _evd_complex(a, max_sweeps_factor=max_sweeps_factor, vectors=True)
    (wr, wi), (vr, vi), info = evd_pair(a, max_sweeps_factor=max_sweeps_factor)
    return _combine_pair(wr, wi), _combine_pair(vr, vi), info


def eigenvalues(a, *, max_sweeps_factor: int = 30):
    """Eigenvalues as a complex tensor: of a real matrix with conjugate
    pairs adjacent, of a complex one in the Schur form's diagonal order."""
    _square(a, "eigenvalues")
    if a.is_complex():
        return _evd_complex(a, max_sweeps_factor=max_sweeps_factor, vectors=False)[0]
    return _combine_pair(*eigenvalues_pair(a, max_sweeps_factor=max_sweeps_factor))
