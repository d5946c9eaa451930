"""Blocked dense triangular solve (counterpart of
``faer_tpu/ops/triangular_solve.py``).

faer ``solve_*_triangular_in_place_with_conj`` (``triangular_solve.rs:220-402``).
Blocked substitution over 128-row blocks: each diagonal block is inverted by
the ``trtri`` kernel and applied as a product, and the blocks below (or
above) get one product each. The diagonal-block applications pin full
FP32 (``_mm_hi``, as at ``faer_tpu/ops/triangular_solve.py:25-27``); the
updates of the blocks below or above go through the front door's dispatch.
The port is real f32 only, so the adjoint variants are the transpose
variants.
"""
from __future__ import annotations

import torch

from faer_tpu_torch.ops.matmul import matmul
from faer_tpu_torch.ops.triangular import (
    _mm_hi,
    invert_lower_triangular,
    invert_upper_triangular,
)

_BLOCK = 128


def solve_lower_triangular(l, b, *, unit: bool = False):
    """X = L⁻¹ B with L lower triangular."""
    n = l.shape[0]
    if n <= _BLOCK:
        return _mm_hi(invert_lower_triangular(l, unit=unit), b)
    # a fresh copy of the right-hand side, updated in place block by block
    x = b.clone(memory_format=torch.contiguous_format)
    for i0 in range(0, n, _BLOCK):
        i1 = min(i0 + _BLOCK, n)
        linv = invert_lower_triangular(l[i0:i1, i0:i1], unit=unit)
        x[i0:i1] = _mm_hi(linv, x[i0:i1])
        if i1 < n:
            x[i1:] -= matmul(None, l[i1:, i0:i1], x[i0:i1])
    return x


def solve_upper_triangular(u, b, *, unit: bool = False):
    """X = U⁻¹ B with U upper triangular."""
    n = u.shape[0]
    if n <= _BLOCK:
        return _mm_hi(invert_upper_triangular(u, unit=unit), b)
    x = b.clone(memory_format=torch.contiguous_format)  # updated in place
    for i0 in reversed(range(0, n, _BLOCK)):
        i1 = min(i0 + _BLOCK, n)
        uinv = invert_upper_triangular(u[i0:i1, i0:i1], unit=unit)
        x[i0:i1] = _mm_hi(uinv, x[i0:i1])
        if i0 > 0:
            x[:i0] -= matmul(None, u[:i0, i0:i1], x[i0:i1])
    return x


def solve_unit_lower_triangular(l, b):
    """faer ``solve_unit_lower_triangular_in_place`` (``triangular_solve.rs:220``)."""
    return solve_lower_triangular(l, b, unit=True)


def solve_unit_upper_triangular(u, b):
    return solve_upper_triangular(u, b, unit=True)


def solve_lower_triangular_transpose(l, b, *, unit: bool = False):
    """X = L⁻ᵀ B: an upper solve on Lᵀ."""
    return solve_upper_triangular(l.mT, b, unit=unit)


def solve_upper_triangular_transpose(u, b, *, unit: bool = False):
    return solve_lower_triangular(u.mT, b, unit=unit)


def solve_lower_triangular_adjoint(l, b, *, unit: bool = False):
    """X = L⁻ᴴ B, which is L⁻ᵀ B for the real dtypes of the port."""
    return solve_lower_triangular_transpose(l, b, unit=unit)


def solve_upper_triangular_adjoint(u, b, *, unit: bool = False):
    return solve_upper_triangular_transpose(u, b, unit=unit)
