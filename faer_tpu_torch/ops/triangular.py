"""Triangular inverse and structured products (counterpart of
``faer_tpu/ops/triangular.py``).

faer ``invert_lower_triangular`` (``triangular_inverse.rs:124``). The dtype
picks the route, as the JAX package's ``panel_kernels_enabled`` does:

* float32: blocks of side ≤ 128 go to the ``trtri`` kernel
  (``ops/kernels/trtri.py``), as at ``faer_tpu/ops/triangular.py:156-161``;
  larger ones use the recursive 2×2 combine ``inv([[A, 0], [B, C]]) =
  [[inv(A), 0], [−inv(C)·B·inv(A), inv(C)]]`` of ``:162-172``. The leaves
  of that halving do not depend on each other (in the JAX package they are
  independent ops of one traced graph), so all of them are inverted by one
  batched launch before the combine runs bottom-up.
* float64, complex64 and complex128: the JAX package's non-kernel route,
  the same halving down to leaves of ``base`` (default 32, at most 128)
  inverted by Neumann doubling plus one Newton–Schulz step
  (``_inv_lower_base``, ``:103-133``). It takes leading batch dimensions,
  so that the triangular solves invert all their diagonal blocks at once
  (:func:`invert_diagonal_blocks_generic`).

The combine's products pin ``precision="highest"`` as the JAX package's
``_mm_hi`` does (``:30-34``): an error in an inverse is amplified by its
norm downstream, so they never take the tile GEMM. Structure is enforced
by masks (``structure_mask``, ``apply_structure``, ``triangular_matmul``,
``:37-95``), as in the JAX package.
"""
from __future__ import annotations

import torch

from faer_tpu_torch.core import dtypes
from faer_tpu_torch.core.flags import Accum, BlockStructure, Conj
from faer_tpu_torch.ops.kernels.trtri import MAX_N, trtri, trtri_batched
from faer_tpu_torch.ops.matmul import matmul

_BASE = 32  # the float64 route's default leaf (``faer_tpu/ops/triangular.py:100``)


def _mm_hi(a, b):
    """A·B in full FP32 (float64 for float64) whatever the tile GEMM switch says."""
    return matmul(None, a, b, precision="highest")


def structure_mask(n_rows: int, n_cols: int, structure: BlockStructure, dtype,
                   device=None):
    """Multiplicative mask of ``structure`` (``None`` for a rectangle); a
    unit diagonal is masked out here and added by ``apply_structure``."""
    if structure is BlockStructure.RECTANGULAR:
        return None
    k = -1 if structure.is_strict or structure.is_unit else 0
    ones = torch.ones((n_rows, n_cols), dtype=dtypes.real_dtype_of(dtype),
                      device=device)
    m = torch.tril(ones, k) if structure.is_lower else torch.triu(ones, -k)
    return m.to(dtype)


def apply_structure(x, structure: BlockStructure):
    """Zero the structurally absent triangle; set a unit diagonal to 1."""
    if structure is BlockStructure.RECTANGULAR:
        return x
    y = x * structure_mask(x.shape[-2], x.shape[-1], structure, x.dtype, x.device)
    if structure.is_unit:
        y = y + torch.eye(x.shape[-2], x.shape[-1], dtype=x.dtype, device=x.device)
    return y


def triangular_matmul(acc, lhs, rhs, *,
                      dst_structure: BlockStructure = BlockStructure.RECTANGULAR,
                      lhs_structure: BlockStructure = BlockStructure.RECTANGULAR,
                      rhs_structure: BlockStructure = BlockStructure.RECTANGULAR,
                      alpha=1.0, accum: Accum = Accum.REPLACE,
                      conj_lhs: Conj = Conj.NO, conj_rhs: Conj = Conj.NO):
    """faer ``triangular::matmul`` (``triangular.rs:1193``), mask-based: the
    operands' absent triangles are zeroed, the full product taken, and the
    destination's absent triangle zeroed."""
    a = apply_structure(lhs, lhs_structure)
    b = apply_structure(rhs, rhs_structure)
    prod = matmul(None, a, b, alpha=alpha, conj_lhs=conj_lhs, conj_rhs=conj_rhs)
    if dst_structure is not BlockStructure.RECTANGULAR:
        if dst_structure.is_strict or dst_structure.is_unit:
            kept = dst_structure
        elif dst_structure.is_lower:
            kept = BlockStructure.TRIANGULAR_LOWER
        else:
            kept = BlockStructure.TRIANGULAR_UPPER
        prod = prod * structure_mask(prod.shape[-2], prod.shape[-1], kept,
                                     prod.dtype, prod.device)
    if accum is Accum.ADD:
        prod = acc + prod
    return prod


def leaf_plan(n: int, off: int = 0) -> list[tuple[int, int]]:
    """The (offset, size) leaves of the halving ``h = (n + 1) // 2`` down to
    side ≤ 128, in order: 301 → (0, 76), (76, 75), (151, 75), (226, 75)."""
    if n <= MAX_N:
        return [(off, n)]
    h = (n + 1) // 2
    return leaf_plan(h, off) + leaf_plan(n - h, off + h)


def _inv_lower_base(t, unit: bool):
    """Matmul-only inverse of small lower triangles (..., n, n): with
    ``T = diag(d)(I + M)``, M strictly lower and nilpotent, inv(I + M) is
    the finite Neumann sum, formed in ⌈log2 n⌉ doubling steps, then one
    Newton–Schulz step X ← X(2I − T X) (``faer_tpu/ops/triangular.py:
    103-133``)."""
    n = t.shape[-1]
    eye = torch.eye(n, dtype=t.dtype, device=t.device)
    if unit:
        m = torch.tril(t, -1)
        dinv = None
    else:
        d = torch.diagonal(t, dim1=-2, dim2=-1)
        m = torch.tril(t / d[..., :, None], -1)
        dinv = 1.0 / d
    p = -m
    s = eye + p
    span = 2
    while span < n:
        p = _mm_hi(p, p)
        s = s + _mm_hi(p, s)
        span *= 2
    if dinv is not None:
        s = s * dinv[..., None, :]
    tt = torch.tril(t, -1) + eye if unit else torch.tril(t)
    s = s + _mm_hi(s, eye - _mm_hi(tt, s))
    return torch.tril(s)


def _invert_lower_generic(t, unit: bool, base: int):
    """The non-kernel route on (..., n, n): halving down to ``base``."""
    n = t.shape[-1]
    if n <= base:
        return _inv_lower_base(t, unit)
    h = (n + 1) // 2
    ai = _invert_lower_generic(t[..., :h, :h], unit, base)
    ci = _invert_lower_generic(t[..., h:, h:], unit, base)
    out = t.new_zeros(t.shape)
    # in place into the fresh output where the JAX package concatenates
    out[..., :h, :h] = ai
    out[..., h:, :h] = -_mm_hi(_mm_hi(ci, t[..., h:, :h]), ai)
    out[..., h:, h:] = ci
    return out


def invert_lower_triangular(t, *, unit: bool = False, base: int | None = None):
    """inv(L) for the lower triangle of ``t`` (unit diagonal if ``unit``).

    ``base`` is the float64 route's leaf side (default 32, capped at 128,
    as in the JAX package); the float32 route's leaves are the kernel's.
    """
    if not dtypes.kernel_route(t.dtype):
        return _invert_lower_generic(t, unit, min(base or _BASE, MAX_N))
    n = t.shape[0]
    if n <= MAX_N:
        return trtri(t, unit=unit)
    inv = trtri_batched(t, leaf_plan(n), unit=unit)
    leaves = iter(range(inv.shape[0]))

    def combine(off: int, size: int):
        if size <= MAX_N:
            return inv[next(leaves), :size, :size]
        h = (size + 1) // 2
        ai = combine(off, h)
        ci = combine(off + h, size - h)
        out = t.new_zeros((size, size))
        # in place into the fresh output: saves the concatenations
        out[:h, :h] = ai
        out[h:, :h] = -_mm_hi(_mm_hi(ci, t[off + h:off + size, off:off + h]), ai)
        out[h:, h:] = ci
        return out

    return combine(0, n)


def invert_upper_triangular(t, *, unit: bool = False, base: int | None = None):
    """inv(U) for the upper triangle of ``t`` (``triangular_inverse.rs:160``):
    the lower triangle of the ``.mT`` view, read through its strides."""
    return invert_lower_triangular(t.mT, unit=unit, base=base).mT


def invert_unit_lower_triangular(t):
    return invert_lower_triangular(t, unit=True)


def invert_unit_upper_triangular(t):
    return invert_upper_triangular(t, unit=True)


def invert_diagonal_blocks_generic(t, blocks, *, unit: bool = False):
    """The non-kernel route's inverse of each diagonal block ``t[o:o+s,
    o:o+s]`` (s ≤ 128) of ``blocks``, at the default leaf, as the JAX
    package's solves invert each block (``faer_tpu/ops/triangular_solve.py:
    49-50``), run once over each group of consecutive equal-sized blocks
    stacked into a batch: a (len(blocks), 128, 128) tensor, slot i holding
    block i's inverse in its leading s × s and zeros past it (the layout of
    ``trtri_batched``, which the float32 route launches instead)."""
    out = t.new_zeros((len(blocks), MAX_N, MAX_N))
    i0 = 0
    while i0 < len(blocks):  # each run of equal-sized blocks is one batch
        size = blocks[i0][1]
        i1 = i0
        while i1 < len(blocks) and blocks[i1][1] == size:
            i1 += 1
        stack = torch.stack([t[o:o + size, o:o + size] for o, _ in blocks[i0:i1]])
        out[i0:i1, :size, :size] = _invert_lower_generic(stack, unit, _BASE)
        i0 = i1
    return out
