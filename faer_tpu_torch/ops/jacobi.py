"""Givens / Jacobi 2×2 rotations (counterpart of ``faer_tpu/ops/jacobi.py``).

faer ``JacobiRotation`` (``linalg/jacobi.rs:7``), ``make_givens``
(``:16``) and ``apply_on_the_{left,right}_in_place`` (``:257,270``).
Convention, as in the JAX package: ``G = [[c, s], [−s̄, c]]`` with c real,
c² + |s|² = 1 and ``Gᴴ [a, b]ᵀ = [r, 0]ᵀ``. Every function takes real and
complex tensors (any matching shapes broadcast).

The norm is ``torch.hypot`` of the moduli, where the reference squares them
(``jacobi.py:29``): PyTorch keeps float32 subnormals, so squares of
entries below ≈ 1e-19 lose bits (F1 in ROADMAP §3). The Schur and QZ
modules keep their own rotations, which their kernels match to the bit.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class JacobiRotation(NamedTuple):
    c: torch.Tensor  # real
    s: torch.Tensor  # of the data's dtype


def _tensors(a, b):
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    dtype = torch.promote_types(a.dtype, b.dtype)
    return a.to(dtype), b.to(dtype)


def make_givens(a, b):
    """The rotation zeroing ``b`` against ``a``: ``(rot, r)`` with
    ``Gᴴ [a, b]ᵀ = [r, 0]ᵀ``; b = 0 gives c = 1, s = 0, r = a."""
    a, b = _tensors(a, b)
    abs_a, abs_b = a.abs(), b.abs()
    norm = torch.hypot(abs_a, abs_b)
    b_zero = abs_b == 0
    one = torch.ones_like(norm)
    safe_norm = torch.where(norm == 0, one, norm)
    c = torch.where(b_zero, one, abs_a / safe_norm)
    sign_a = torch.where(abs_a == 0, torch.ones_like(a),
                         a / torch.where(abs_a == 0, one, abs_a).to(a.dtype))
    s = torch.where(b_zero, torch.zeros_like(a), -sign_a * b.conj() / safe_norm.to(a.dtype))
    r = torch.where(b_zero, a, sign_a * norm.to(a.dtype))
    return JacobiRotation(c=c, s=s), r


def apply_on_the_left(rot: JacobiRotation, x_row, y_row):
    """Rows ``(x, y) ← Gᴴ [x; y] = (c x − s y, s̄ x + c y)``."""
    c = rot.c.to(x_row.dtype)
    return c * x_row - rot.s * y_row, rot.s.conj() * x_row + c * y_row


def apply_on_the_right(rot: JacobiRotation, x_col, y_col):
    """Columns ``(x, y) ← [x, y] G = (c x − s̄ y, s x + c y)``."""
    c = rot.c.to(x_col.dtype)
    return c * x_col - rot.s.conj() * y_col, rot.s * x_col + c * y_col


def make_jacobi_symmetric(app, apq, aqq):
    """The 2×2 symmetric Jacobi rotation diagonalizing [[app, apq], [apq,
    aqq]]: ``(c, s)`` with ``Jᵀ A J`` diagonal, ``J = [[c, s], [−s, c]]``
    (real symmetric only, as in the reference)."""
    app, apq, aqq = (torch.as_tensor(x) for x in (app, apq, aqq))
    tau = (aqq - app) / (2.0 * torch.where(apq == 0, torch.ones_like(apq), apq))
    t = torch.sign(tau) / (tau.abs() + torch.sqrt(1.0 + tau * tau))
    t = torch.where(tau == 0, torch.ones_like(t), t)
    t = torch.where(apq == 0, torch.zeros_like(t), t)
    c = 1.0 / torch.sqrt(1.0 + t * t)
    return c, t * c
