"""Triangular inverse (counterpart of ``faer_tpu/ops/triangular.py``).

faer ``invert_lower_triangular`` (``triangular_inverse.rs:124``): blocks of
side ≤ 128 go to the ``trtri`` kernel (``ops/kernels/trtri.py``), as at
``faer_tpu/ops/triangular.py:156-161``; larger ones use the recursive 2×2
combine ``inv([[A, 0], [B, C]]) = [[inv(A), 0], [−inv(C)·B·inv(A), inv(C)]]``
of ``:162-172``. The leaves of that halving do not depend on each other (in
the JAX package they are independent ops of one traced graph), so all of
them are inverted by one batched launch before the combine runs bottom-up.
The combine's products pin ``precision="highest"`` as the JAX package's
``_mm_hi`` does (``:30-34``): an error in an inverse is amplified by its
norm downstream, so they never take the tile GEMM.
"""
from __future__ import annotations

from faer_tpu_torch.ops.kernels.trtri import MAX_N, trtri, trtri_batched
from faer_tpu_torch.ops.matmul import matmul


def _mm_hi(a, b):
    """A·B in full FP32 whatever the tile GEMM switch says."""
    return matmul(None, a, b, precision="highest")


def leaf_plan(n: int, off: int = 0) -> list[tuple[int, int]]:
    """The (offset, size) leaves of the halving ``h = (n + 1) // 2`` down to
    side ≤ 128, in order: 301 → (0, 76), (76, 75), (151, 75), (226, 75)."""
    if n <= MAX_N:
        return [(off, n)]
    h = (n + 1) // 2
    return leaf_plan(h, off) + leaf_plan(n - h, off + h)


def invert_lower_triangular(t, *, unit: bool = False):
    """inv(L) for the lower triangle of ``t`` (unit diagonal if ``unit``)."""
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


def invert_upper_triangular(t, *, unit: bool = False):
    """inv(U) for the upper triangle of ``t`` (``triangular_inverse.rs:160``):
    the lower triangle of the ``.mT`` view, read through its strides."""
    return invert_lower_triangular(t.mT, unit=unit).mT
