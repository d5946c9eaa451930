"""Symmetric → tridiagonal Householder reduction (counterpart of
``faer_tpu/linalg/tridiag.py``).

faer ``tridiag_in_place`` (``evd/tridiag.rs:274``), LAPACK ``sytrd``
semantics: returns ``(d, e, hh, taus)``, the diagonal d (n,), the
subdiagonal e (n−1,), the reflector tails ``hh`` (n × n, v_j in column j,
rows j+2:, with the implicit 1 at row j+1) and ``taus`` (n−1,).

The default is the JAX package's panelled (LAPACK ``latrd``) reduction: per
panel, ``block`` Householder steps of one trailing matvec and O(m·b)
corrections each, then the rank-2b trailing update as two GEMMs. The
unblocked form is the small-n base case. Both are n host-issued steps, as in
the reference. These functions build their own reflectors (the larfg signs
of ``ops/householder.py``, over a column slice). Where the JAX package masks
full-length vectors, the port works on the slices the masks select: the
masked entries are exact zeros, so the function is the same.

Complex Hermitian input (LAPACK ``hetrd``) gives a real d and a real e
(the real-β reflectors), complex ``hh`` and ``taus``: ``Qᴴ A Q`` is the
real tridiagonal, ``Q = H_0 ⋯ H_{n−2}`` with ``H = I − τ v vᴴ``.
"""
from __future__ import annotations

import torch

from faer_tpu_torch.core import dtypes
from faer_tpu_torch.ops.matmul import matmul


def _householder_step(c):
    """Reflector from column ``c`` (rows ≥ i of column i) pivoting at its
    row 1 (row i+1): returns ``(v, tau, beta)``, v of c's length with its
    implicit 1 at row 1 and 0 at row 0, β real (of c's real field)."""
    one = c.new_ones(())
    rone = one.real
    alpha = c[1]
    tail = c[2:]
    tail_sq = torch.vdot(tail, tail).real
    norm = torch.sqrt((alpha * alpha.conj()).real + tail_sq)
    a_re = alpha.real
    beta_r = -torch.where(a_re >= 0, rone, -rone) * norm
    is_id = tail_sq == 0
    if c.is_complex():
        is_id = is_id & (alpha.imag == 0)
    beta = beta_r.to(c.dtype)
    safe_s = torch.where(is_id, one, alpha - beta)
    safe_b = torch.where(is_id, one, beta)
    tau = torch.where(is_id, 0.0 * one, (beta - alpha) / safe_b)
    beta_out = torch.where(is_id, a_re, beta_r)
    v = c.new_zeros(c.shape[0])
    v[1] = 1.0
    v[2:] = torch.where(is_id, 0.0 * one, tail / safe_s)
    return v, tau, beta_out


def tridiag_in_place_unblocked(a):
    """Reduce symmetric (Hermitian) ``a`` (full storage) to tridiagonal form:
    ``(d, e, hh, taus)``. Step j reflects column j below row j+1 and applies
    the two-sided update to the trailing block, the only part read again."""
    n = a.shape[0]
    rdt = dtypes.real_dtype_of(a.dtype)
    if n == 1:
        return (torch.diagonal(a).real.clone(), a.new_zeros(0, dtype=rdt),
                a.new_zeros((1, 1)), a.new_zeros(0))
    a = a.clone(memory_format=torch.contiguous_format)
    hh = a.new_zeros((n, n))
    taus = a.new_zeros(n - 1)
    e = a.new_zeros(n - 1, dtype=rdt)
    for j in range(n - 1):
        v, tau, beta = _householder_step(a[j:, j])
        v1 = v[1:]
        t = a[j + 1:, j + 1:]
        # A ← A − v wᴴ − w vᴴ with u = A v, w = τ u − (τ̄τ (vᴴu)/2) v
        u = torch.mv(t, v1)
        w = tau * u - (tau.conj() * tau * torch.vdot(v1, u) / 2) * v1
        t.addr_(v1, w.conj(), alpha=-1.0)
        t.addr_(w, v1.conj(), alpha=-1.0)
        hh[j + 2:, j] = v[2:]
        taus[j] = tau
        e[j] = beta
    return torch.diagonal(a).real.clone(), e, hh, taus


def _tridiag_panel(t, bw: int):
    """latrd panel on the trailing block ``t`` (m × m): ``bw`` Householder
    steps with the trailing update deferred. Returns ``(V, W, hh_p, taus_p,
    e_p, d_p)``; the caller applies ``t ← t − V Wᵀ − W Vᵀ`` to the rest."""
    m = t.shape[0]
    rdt = dtypes.real_dtype_of(t.dtype)
    v_p = t.new_zeros((m, bw))
    w_p = t.new_zeros((m, bw))
    hh_p = t.new_zeros((m, bw))
    taus_p = t.new_zeros(bw)
    e_p, d_p = t.new_zeros(bw, dtype=rdt), t.new_zeros(bw, dtype=rdt)
    for i in range(bw):
        r0 = i + 1
        # virtual update of column i, rows ≥ i: c = (T − V Wᴴ − W Vᴴ) e_i
        c = t[i:, i] - torch.mv(v_p[i:], w_p[i].conj()) - torch.mv(w_p[i:], v_p[i].conj())
        d_p[i] = c[0].real
        v, tau, beta = _householder_step(c)
        vv = v[1:]  # rows ≥ i+1, where v is supported
        vp, wp = v_p[r0:], w_p[r0:]
        # u = (T − V Wᴴ − W Vᴴ) v: one trailing matvec and four thin ones
        u = torch.mv(t[r0:, r0:], vv) - torch.mv(vp, torch.mv(wp.mH, vv)) \
            - torch.mv(wp, torch.mv(vp.mH, vv))
        w = tau * u - (tau.conj() * tau * torch.vdot(vv, u) / 2) * vv
        v_p[r0:, i] = vv
        w_p[r0:, i] = w
        hh_p[i + 2:, i] = vv[1:]
        taus_p[i] = tau
        e_p[i] = beta
    return v_p, w_p, hh_p, taus_p, e_p, d_p


def tridiag_in_place(a, *, block: int = 128):
    """Blocked symmetric → tridiagonal reduction, the contract of
    :func:`tridiag_in_place_unblocked` (LAPACK ``sytrd``; faer
    ``tridiag.rs:274``). Panels of ``block`` columns while more than
    ``2·block`` remain, then the unblocked form on the rest."""
    n = a.shape[0]
    if n <= max(2 * block, 256):
        return tridiag_in_place_unblocked(a)
    hh = a.new_zeros((n, n))
    rdt = dtypes.real_dtype_of(a.dtype)
    taus, e, d = a.new_zeros(n - 1), a.new_zeros(n - 1, dtype=rdt), a.new_zeros(n, dtype=rdt)
    t = a
    j0 = 0
    while n - j0 > 2 * block:
        bw = block
        v_p, w_p, hh_p, taus_p, e_p, d_p = _tridiag_panel(t, bw)
        hh[j0:, j0:j0 + bw] = hh_p
        taus[j0:j0 + bw] = taus_p
        e[j0:j0 + bw] = e_p
        d[j0:j0 + bw] = d_p
        # trailing two-sided rank-2b update as two GEMMs
        v2, w2 = v_p[bw:], w_p[bw:]
        t = t[bw:, bw:] - matmul(None, v2, w2.mH) - matmul(None, w2, v2.mH)
        j0 += bw
    d_t, e_t, hh_t, taus_t = tridiag_in_place_unblocked(t)
    hh[j0:, j0:] = hh_t
    taus[j0:] = taus_t
    e[j0:] = e_t
    d[j0:] = d_t
    return d, e, hh, taus


def tridiag_apply_q(hh, taus, b):
    """``Q b`` with ``Q = H_0 H_1 ⋯ H_{n−2}`` the tridiagonalizing
    orthogonal (unitary) matrix; v_j lives in hh[:, j] with its implicit 1
    at row j+1. Returns a new tensor of hh's dtype (a real b, the
    tridiagonal's eigenvectors, is promoted)."""
    n = hh.shape[0]
    b = b.to(hh.dtype)
    if n <= 1:
        return b.clone()
    # reflector j as row j of vt, its 1 written in: contiguous rows to read
    vt = hh.T.clone()
    j = torch.arange(n - 1, device=hh.device)
    vt[j, j + 1] = 1.0
    b = b.clone()
    for j in range(n - 2, -1, -1):  # reverse order for Q·b
        v = vt[j, j + 1:]
        bs = b[j + 1:]
        bs.addr_(taus[j] * v, torch.mv(bs.mT, v.conj()), alpha=-1.0)
    return b
