"""Self-adjoint eigendecomposition (counterpart of the self-adjoint part of
``faer_tpu/linalg/evd.py``).

faer ``self_adjoint_evd`` (``evd/mod.rs:270``): tridiagonalize
(``tridiag_in_place``), solve the tridiagonal (``tridiag_evd``: divide &
conquer for n ≥ 512, else the QR iteration, both through the
``tridiag_sweep`` kernel), then back-transform with the reflectors
(``tridiag_apply_q``). Eigenvalues ascending. The Hessenberg, Schur and
general-EVD code of the JAX module waits for ROADMAP §1 item 9. float32
only.
"""
from __future__ import annotations

import torch

from faer_tpu_torch.core import dtypes
from faer_tpu_torch.core.config import check_f32_policy
from faer_tpu_torch.core.errors import ShapeError
from faer_tpu_torch.core.flags import Side
from faer_tpu_torch.linalg.tridiag import tridiag_apply_q, tridiag_in_place
from faer_tpu_torch.linalg.tridiag_evd import tridiag_evd
from faer_tpu_torch.ops.matmul import matmul


def _full_from_lower(a, name: str):
    if a.dim() != 2 or a.shape[0] != a.shape[1]:
        raise ShapeError(f"{name}: needs a square matrix, got {tuple(a.shape)}")
    dtypes.require_f32(a, name)
    if a.is_cuda:
        check_f32_policy()
    return torch.tril(a) + torch.tril(a, -1).T


def self_adjoint_evd(a):
    """Full self-adjoint EVD of the lower triangle of ``a``.

    Returns ``(w, v, info)`` with ``A = V diag(w) Vᵀ``, w ascending.
    """
    full = _full_from_lower(a, "self_adjoint_evd")
    d, e, hh, taus = tridiag_in_place(full)
    w, z, info = tridiag_evd(d, e, want_vectors=True)
    return w, tridiag_apply_q(hh, taus, z), info


def self_adjoint_eigenvalues(a, side: Side = Side.LOWER):
    """Eigenvalues (ascending) of the self-adjoint matrix stored in the
    ``side`` triangle of ``a``."""
    full = _full_from_lower(a if side is Side.LOWER else a.T,
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
    return matmul(None, v * winv[None, :], v.T)
