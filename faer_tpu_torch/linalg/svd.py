"""Singular value decomposition (counterpart of ``faer_tpu/linalg/svd.py``).

faer ``svd`` (``svd/mod.rs:530``): work on Aᵀ when m < n; QR-preprocess
(the port's ``qr_in_place`` / ``qr_compute_q``, through the ``qr_panel``
kernel) when m/n exceeds ``SvdParams.qr_ratio_threshold`` (11/6); then
``bidiag_in_place`` → ``bidiag_svd`` (divide & conquer for n ≥ 512, else
the QR iteration, both through the ``bidiag_sweep`` kernel) → the
Householder back-transforms. ``pseudoinverse_from_svd`` is faer's
``svd/mod.rs:689``. float32 only.
"""
from __future__ import annotations

import torch

from faer_tpu_torch.core import dtypes
from faer_tpu_torch.core.config import check_f32_policy
from faer_tpu_torch.core.errors import ShapeError
from faer_tpu_torch.core.params import SvdParams
from faer_tpu_torch.linalg.bidiag import (
    bidiag_apply_ql,
    bidiag_apply_qr_mat,
    bidiag_in_place,
)
from faer_tpu_torch.linalg.bidiag_svd import bidiag_svd
from faer_tpu_torch.linalg.qr import qr_compute_q, qr_in_place
from faer_tpu_torch.ops.matmul import matmul


def _svd_tall(a, params: SvdParams, want_u: bool, want_v: bool):
    """SVD of a (m ≥ n): ``(u_thin m×n, s, v n×n, info)``."""
    m, n = a.shape
    if n == 0:
        return a.new_zeros((m, 0)), a.new_zeros(0), a.new_zeros((0, 0)), None
    q_pre = None
    if m / max(n, 1) > params.qr_ratio_threshold:
        packed, ts, block = qr_in_place(a)
        q_pre = qr_compute_q(packed, ts, block, thin=True) if want_u else None
        a = torch.triu(packed[:n])
        m = n
    d, e, vl, taul, vr, taur = bidiag_in_place(a)
    s, ub, vb, info = bidiag_svd(d, e, want_u=want_u, want_v=want_v,
                                 max_sweeps_factor=params.max_iters_per_value)
    u = v = None
    if want_u:
        ub_full = a.new_zeros((m, n))
        ub_full[:n] = ub
        u = bidiag_apply_ql(vl, taul, ub_full)
        if q_pre is not None:
            u = matmul(None, q_pre, u)
    if want_v:
        v = bidiag_apply_qr_mat(vr, taur, vb)
    return u, s, v, info


def svd(a, *, thin: bool = True, params: SvdParams | None = None,
        want_u: bool = True, want_v: bool = True):
    """``A = U diag(s) Vᵀ``: returns ``(u, s, v, info)``, s descending.

    ``thin=True`` gives U (m × k) and V (n × k), k = min(m, n); otherwise
    U and V are completed to square orthogonal matrices (faer
    ``svd/mod.rs:466`` full-vector mode).
    """
    if a.dim() != 2:
        raise ShapeError(f"svd: needs a matrix, got {tuple(a.shape)}")
    dtypes.require_f32(a, "svd")
    if a.is_cuda:
        check_f32_policy()
    params = params or SvdParams.auto(a.dtype, a.shape)
    m, n = a.shape
    if m >= n:
        u, s, v, info = _svd_tall(a, params, want_u, want_v)
    else:
        v, s, u, info = _svd_tall(a.T, params, want_v, want_u)
    if not thin:
        if want_u and u.shape[1] < m:
            u = _complete_orthonormal(u)
        if want_v and v.shape[1] < n:
            v = _complete_orthonormal(v)
    return u, s, v, info


def _complete_orthonormal(q_thin):
    """Extend an m × k orthonormal set to an m × m orthogonal basis: keep
    ``q_thin`` (exact singular vectors) and append the last m − k columns of
    the full Q of its QR."""
    k = q_thin.shape[1]
    packed, ts, block = qr_in_place(q_thin)
    full = qr_compute_q(packed, ts, block, thin=False)
    return torch.cat([q_thin, full[:, k:]], dim=1)


def singular_values(a, params: SvdParams | None = None):
    """Singular values only, descending (faer ``Mat::singular_values``)."""
    return svd(a, want_u=False, want_v=False, params=params)[1]


def pseudoinverse_from_svd(u, s, v, tol=None):
    """Moore–Penrose pseudoinverse ``V diag(1/s) Uᵀ`` over the singular
    values above ``tol`` (default max(s)·max(m, n)·eps) (faer
    ``svd/mod.rs:689``)."""
    if tol is None:
        tol = s.max() * max(u.shape[0], v.shape[0]) * dtypes.eps(u.dtype)
    sinv = torch.where(s > tol, 1.0 / torch.where(s == 0, torch.ones_like(s), s),
                       torch.zeros_like(s))
    return matmul(None, v * sinv[None, :], u.T)


def pseudoinverse(a, tol=None):
    """Moore–Penrose pseudoinverse of ``a`` through its thin SVD."""
    u, s, v, _ = svd(a, thin=True)
    return pseudoinverse_from_svd(u, s, v, tol=tol)
