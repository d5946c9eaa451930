"""Householder bidiagonalization, m ≥ n: A = Q_l B Q_rᴴ with B upper
bidiagonal (counterpart of ``faer_tpu/linalg/bidiag.py``).

faer ``bidiag_in_place`` (``svd/bidiag.rs:47``), LAPACK ``gebrd``
semantics. The default is the JAX package's panelled (LAPACK ``labrd``)
reduction: per panel, ``block`` left-and-right reflector steps with the
updates deferred (``A = A0 − VL Yᵀ − X VRᵀ``), then the rank-2b trailing
update as two GEMMs; the unblocked form is the small-n base case. Both are
n host-issued steps, as in the reference. The reflectors are built here
(larfg signs over a slice); where the JAX package masks full-length vectors,
the port works on the slices the masks select, whose other entries are exact
zeros or never read again, so the function is the same.

Complex input (LAPACK ``zgebrd``) gives a real d and a real e: every
reflector has a real β, the right ones built from the conjugated row, and
the last right reflector of a square block is a pure phase.
"""
from __future__ import annotations

import torch

from faer_tpu_torch.core import dtypes
from faer_tpu_torch.ops.matmul import matmul


def _reflector_from_masked(x):
    """Reflector zeroing ``x[1:]`` against ``x[0]``: ``(v, tau, beta)`` with
    v[0] = 1, of x's length (the reference's support rows ≥ ``at`` are
    ``x = colvec[at:]``), β real (of x's real field)."""
    one = x.new_ones(())
    rone = one.real
    alpha = x[0]
    tail = x[1:]
    tail_sq = torch.vdot(tail, tail).real
    norm = torch.sqrt((alpha * alpha.conj()).real + tail_sq)
    a_re = alpha.real
    beta_r = -torch.where(a_re >= 0, rone, -rone) * norm
    is_id = tail_sq == 0
    if x.is_complex():
        is_id = is_id & (alpha.imag == 0)
    beta = beta_r.to(x.dtype)
    safe_s = torch.where(is_id, one, alpha - beta)
    safe_b = torch.where(is_id, one, beta)
    tau = torch.where(is_id, 0.0 * one, (beta - alpha) / safe_b)
    beta_out = torch.where(is_id, a_re, beta_r)
    v = torch.empty_like(x)
    v[0] = 1.0
    v[1:] = torch.where(is_id, 0.0 * one, tail / safe_s)
    return v, tau, beta_out


def bidiag_in_place_unblocked(a):
    """Bidiagonalize ``a`` (m ≥ n): ``(d, e, vl, taul, vr, taur)``, d (n,),
    e (n−1,), left reflectors vl (m × n, v_j in column j, support rows ≥ j),
    right reflectors vr (n × max(n−1, 1), support rows ≥ j+1).
    ``A = Q_l B Q_rᴴ`` with ``Q_l = H^l_0 ⋯ H^l_{n−1}`` and
    ``Q_r = H^r_0 ⋯ H^r_{n−2}``; d and e real."""
    m, n = a.shape
    rdt = dtypes.real_dtype_of(a.dtype)
    a = a.clone(memory_format=torch.contiguous_format)
    vl = a.new_zeros((m, n))
    taul, d = a.new_zeros(n), a.new_zeros(n, dtype=rdt)
    vr = a.new_zeros((n, max(n - 1, 1)))
    taur, e = a.new_zeros(max(n - 1, 1)), a.new_zeros(max(n - 1, 1), dtype=rdt)
    for j in range(n):
        # left reflector on column j: A ← Hᴴ A on the trailing block
        v, tau, beta = _reflector_from_masked(a[j:, j])
        blk = a[j:, j:]
        blk.addr_(tau.conj() * v, torch.mv(blk.mT, v.conj()), alpha=-1.0)
        vl[j:, j] = v
        taul[j] = tau
        d[j] = beta
        if j < n - 1:
            # right reflector on row j, right of the superdiagonal, from the
            # row's conjugate: A ← A H
            vr_j, taur_j, ebeta = _reflector_from_masked(a[j, j + 1:].conj())
            blk = a[j + 1:, j + 1:]
            blk.addr_(taur_j * torch.mv(blk, vr_j), vr_j.conj(), alpha=-1.0)
            vr[j + 1:, j] = vr_j
            taur[j] = taur_j
            e[j] = ebeta
    return d, e[:max(n - 1, 0)], vl, taul, vr, taur


def _bidiag_panel(a0, bw: int):
    """labrd panel on the trailing block ``a0`` (mp × np): ``bw`` left and
    right reflector steps with deferred updates ``A = A0 − VL Yᴴ − X VRᴴ``.
    Returns ``(VL, Y, X, VR, taul_p, taur_p, d_p, e_p)``."""
    mp, np_ = a0.shape
    rdt = dtypes.real_dtype_of(a0.dtype)
    vl_p, x_p = a0.new_zeros((mp, bw)), a0.new_zeros((mp, bw))
    y_p, vr_p = a0.new_zeros((np_, bw)), a0.new_zeros((np_, bw))
    taul_p, taur_p = a0.new_zeros(bw), a0.new_zeros(bw)
    d_p, e_p = a0.new_zeros(bw, dtype=rdt), a0.new_zeros(bw, dtype=rdt)
    mv = torch.mv
    for i in range(bw):
        # virtual column i, rows ≥ i: c = (A0 − VL Yᴴ − X VRᴴ) e_i
        c = a0[i:, i] - mv(vl_p[i:], y_p[i].conj()) - mv(x_p[i:], vr_p[i].conj())
        v, taul, beta_d = _reflector_from_masked(c)
        # Y[:, i] = wᴴ with w = τ̄ vᴴ A_virt, columns ≥ i: τ A_virtᴴ v
        vlv, xv_ = mv(vl_p[i:].mH, v), mv(x_p[i:].mH, v)
        wrow = mv(a0[i:, i:].mH, v) - mv(y_p[i:], vlv) - mv(vr_p[i:], xv_)
        vl_p[i:, i] = v
        y_p[i:, i] = taul * wrow
        taul_p[i] = taul
        d_p[i] = beta_d
        # virtual row i, columns ≥ i+1, now with the left reflector applied,
        # conjugated: the right reflector is built from it
        r0 = i + 1
        r = a0[i, r0:].conj() - mv(y_p[r0:], vl_p[i].conj()) - mv(vr_p[r0:], x_p[i].conj())
        u, taur, beta_e = _reflector_from_masked(r)
        # x = τr · A_virt u, rows ≥ i+1
        xv = mv(a0[r0:, r0:], u) - mv(vl_p[r0:], mv(y_p[r0:].mH, u)) \
            - mv(x_p[r0:], mv(vr_p[r0:].mH, u))
        vr_p[r0:, i] = u
        x_p[r0:, i] = taur * xv
        taur_p[i] = taur
        e_p[i] = beta_e
    return vl_p, y_p, x_p, vr_p, taul_p, taur_p, d_p, e_p


def bidiag_in_place(a, *, block: int = 128):
    """Blocked bidiagonalization, the contract of
    :func:`bidiag_in_place_unblocked` (LAPACK ``gebrd``; faer
    ``bidiag.rs:47``). Panels of ``block`` columns while more than
    ``2·block`` remain, then the unblocked form on the rest."""
    m, n = a.shape
    if n <= max(2 * block, 256):
        return bidiag_in_place_unblocked(a)
    rdt = dtypes.real_dtype_of(a.dtype)
    vl = a.new_zeros((m, n))
    vr = a.new_zeros((n, n - 1))
    taul, d = a.new_zeros(n), a.new_zeros(n, dtype=rdt)
    taur, e = a.new_zeros(n - 1), a.new_zeros(n - 1, dtype=rdt)
    t = a
    j0 = 0
    while n - j0 > 2 * block:
        bw = block
        vl_p, y_p, x_p, vr_p, taul_p, taur_p, d_p, e_p = _bidiag_panel(t, bw)
        vl[j0:, j0:j0 + bw] = vl_p
        vr[j0:, j0:j0 + bw] = vr_p
        taul[j0:j0 + bw] = taul_p
        taur[j0:j0 + bw] = taur_p
        d[j0:j0 + bw] = d_p
        e[j0:j0 + bw] = e_p
        # trailing rank-2b update as two GEMMs
        t = t[bw:, bw:] - matmul(None, vl_p[bw:], y_p[bw:].mH) \
            - matmul(None, x_p[bw:], vr_p[bw:].mH)
        j0 += bw
    d_t, e_t, vl_t, taul_t, vr_t, taur_t = bidiag_in_place_unblocked(t)
    vl[j0:, j0:] = vl_t
    taul[j0:] = taul_t
    d[j0:] = d_t
    if n - j0 > 1:
        vr[j0:, j0:] = vr_t
        taur[j0:] = taur_t
        e[j0:] = e_t
    return d, e, vl, taul, vr, taur


def _apply_reflectors(vs, taus, b, first: int, order):
    """``b ← H_j b`` for j in ``order``, H_j = I − τ_j v_j v_jᴴ with v_j in
    column j of ``vs`` supported on rows ≥ j + ``first``. Returns a new
    tensor of vs's dtype (a real b, the bidiagonal's vectors, is
    promoted)."""
    vt = vs.T.contiguous()  # reflector j as row j: contiguous reads
    b = b.to(vs.dtype).clone()
    for j in order:
        v = vt[j, j + first:]
        bs = b[j + first:]
        bs.addr_(taus[j] * v, torch.mv(bs.mT, v.conj()), alpha=-1.0)
    return b


def bidiag_apply_ql(vl, taul, b):
    """``Q_l b`` with ``Q_l = H_0 ⋯ H_{n−1}``, b (m × k)."""
    n = vl.shape[1]
    return _apply_reflectors(vl, taul, b, 0, range(n - 1, -1, -1))


def bidiag_apply_qr_mat(vr, taur, b):
    """``Q_r b`` with ``Q_r = H^r_0 ⋯ H^r_{n−2}``, b (n × k)."""
    n = vr.shape[0]
    if n <= 1:
        return b.to(vr.dtype).clone()
    return _apply_reflectors(vr, taur, b, 1, range(n - 2, -1, -1))
