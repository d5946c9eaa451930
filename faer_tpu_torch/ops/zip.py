"""Coefficient-wise helpers (counterpart of ``faer_tpu/ops/zip.py``).

faer's ``zip!`` framework (``linalg/zip.rs``: ``for_each`` ``:2255`` and
the triangular variants ``:2274-2311``). Lock-step elementwise iteration
is PyTorch broadcasting, so the module supplies what broadcasting lacks:
the triangle-restricted maps, an index-aware map, triangle copies, the
self-adjoint mirror and the Kronecker product. Every function takes real
and complex tensors and returns a new tensor.
"""
from __future__ import annotations

import torch


def cwise(f, *mats):
    """Elementwise map over matrices in lock step (faer ``zip!().for_each``)."""
    return f(*mats)


def _tri_mask(shape, device, lower: bool, strict: bool):
    m, n = shape[-2:]
    ones = torch.ones((m, n), dtype=torch.bool, device=device)
    return torch.tril(ones, -1 if strict else 0) if lower else torch.triu(ones, 1 if strict else 0)


def cwise_triangular_lower(f, dst, *mats, strict: bool = False):
    """``f(dst, *mats)`` on the (strict) lower triangle, ``dst`` elsewhere."""
    return torch.where(_tri_mask(dst.shape, dst.device, True, strict), f(dst, *mats), dst)


def cwise_triangular_upper(f, dst, *mats, strict: bool = False):
    """``f(dst, *mats)`` on the (strict) upper triangle, ``dst`` elsewhere."""
    return torch.where(_tri_mask(dst.shape, dst.device, False, strict), f(dst, *mats), dst)


def cwise_with_index(f, mat):
    """``f(i, j, a_ij)`` elementwise (faer ``for_each_with_index``), i and j
    broadcast index tensors."""
    m, n = mat.shape[-2:]
    ii = torch.arange(m, device=mat.device)[:, None]
    jj = torch.arange(n, device=mat.device)[None, :]
    return f(ii, jj, mat)


def copy_triangle(dst, src, *, lower: bool, strict: bool = False):
    """``src`` on one (strict) triangle, ``dst`` elsewhere."""
    return torch.where(_tri_mask(dst.shape, dst.device, lower, strict), src, dst)


def make_self_adjoint(a, *, from_lower: bool = True):
    """The exactly self-adjoint matrix of one triangle of ``a``, the other
    mirrored and conjugated."""
    if from_lower:
        return torch.tril(a) + torch.tril(a, -1).mH
    return torch.triu(a) + torch.triu(a, 1).mH


def kron(a, b):
    """Kronecker product (faer ``kron.rs:37``)."""
    return torch.kron(a, b)
