"""Blocked dense triangular solve (counterpart of
``faer_tpu/ops/triangular_solve.py``).

faer ``solve_*_triangular_in_place_with_conj`` (``triangular_solve.rs:220-402``).
Blocked substitution over 128-row blocks: every diagonal block is inverted
before the loop (the inverses do not depend on the right-hand side; in the
JAX package they are independent ops of one traced graph), by one batched
``trtri`` launch in float32, or by the non-kernel inverse batched over
the blocks in float64 (``ops.triangular.invert_diagonal_blocks_generic``);
each is applied as a product, and the blocks below (or above) get one
product each. The diagonal-block applications pin full precision (``_mm_hi``, as
at ``faer_tpu/ops/triangular_solve.py:25-27``); the updates of the blocks
below or above go through the front door's dispatch. Complex input takes
the non-kernel inverse (the JAX package keeps complex off its kernels);
the transpose variants transpose, the adjoint variants also conjugate.
"""
from __future__ import annotations

import torch

from faer_tpu_torch.core import dtypes
from faer_tpu_torch.ops.kernels.trtri import MAX_N, trtri_batched
from faer_tpu_torch.ops.matmul import matmul
from faer_tpu_torch.ops.triangular import (
    _mm_hi,
    invert_diagonal_blocks_generic,
    invert_lower_triangular,
    invert_upper_triangular,
)

_BLOCK = MAX_N  # a diagonal block is one slot of the batched inverse


def _diagonal_inverses(t, blocks, unit: bool):
    """The inverses of ``t``'s diagonal blocks: one ``trtri_batched`` launch
    in float32, the batched non-kernel inverse in float64."""
    if dtypes.kernel_route(t.dtype):
        return trtri_batched(t, blocks, unit=unit)
    return invert_diagonal_blocks_generic(t, blocks, unit=unit)


def _diagonal_blocks(n: int) -> list[tuple[int, int]]:
    """(offset, size) of the 128-row diagonal blocks, the last one ragged."""
    return [(i0, min(_BLOCK, n - i0)) for i0 in range(0, n, _BLOCK)]


def solve_lower_triangular(l, b, *, unit: bool = False):
    """X = L⁻¹ B with L lower triangular."""
    n = l.shape[0]
    if n <= _BLOCK:
        return _mm_hi(invert_lower_triangular(l, unit=unit), b)
    # a fresh copy of the right-hand side, updated in place block by block
    x = b.clone(memory_format=torch.contiguous_format)
    blocks = _diagonal_blocks(n)
    inv = _diagonal_inverses(l, blocks, unit)
    for k, (i0, size) in enumerate(blocks):
        i1 = i0 + size
        x[i0:i1] = _mm_hi(inv[k, :size, :size], x[i0:i1])
        if i1 < n:
            x[i1:] -= matmul(None, l[i1:, i0:i1], x[i0:i1])
    return x


def solve_upper_triangular(u, b, *, unit: bool = False):
    """X = U⁻¹ B with U upper triangular."""
    n = u.shape[0]
    if n <= _BLOCK:
        return _mm_hi(invert_upper_triangular(u, unit=unit), b)
    x = b.clone(memory_format=torch.contiguous_format)  # updated in place
    blocks = _diagonal_blocks(n)
    inv = _diagonal_inverses(u.mT, blocks, unit)  # the lower triangle of Uᵀ
    for k, (i0, size) in reversed(list(enumerate(blocks))):
        i1 = i0 + size
        x[i0:i1] = _mm_hi(inv[k, :size, :size].mT, x[i0:i1])
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
    """X = L⁻ᴴ B: an upper solve on Lᴴ (L⁻ᵀ B for a real L)."""
    return solve_upper_triangular(l.mH, b, unit=unit)


def solve_upper_triangular_adjoint(u, b, *, unit: bool = False):
    return solve_lower_triangular(u.mH, b, unit=unit)


# right-side variants: X op(T) = B  ⇔  op(T)ᵀ Xᵀ = Bᵀ
def solve_lower_triangular_on_right(l, b, *, unit: bool = False):
    """X = B L⁻¹ (``faer_tpu/ops/triangular_solve.py:110-112``)."""
    return solve_upper_triangular(l.mT, b.mT, unit=unit).mT


def solve_upper_triangular_on_right(u, b, *, unit: bool = False):
    """X = B U⁻¹ (``faer_tpu/ops/triangular_solve.py:115-117``)."""
    return solve_lower_triangular(u.mT, b.mT, unit=unit).mT
