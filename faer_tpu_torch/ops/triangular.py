"""Triangular inverse (counterpart of ``faer_tpu/ops/triangular.py``).

faer ``invert_lower_triangular`` (``triangular_inverse.rs:124``): blocks of
side ≤ 128 go to the ``trtri`` kernel (``ops/kernels/trtri.py``), as at
``faer_tpu/ops/triangular.py:156-161``; larger ones use the recursive 2×2
combine ``inv([[A, 0], [B, C]]) = [[inv(A), 0], [−inv(C)·B·inv(A), inv(C)]]``
of ``:162-172``. Its products pin ``precision="highest"`` as the JAX
package's ``_mm_hi`` does (``:30-34``): an error in an inverse is amplified
by its norm downstream, so they never take the tile GEMM.
"""
from __future__ import annotations

from faer_tpu_torch.ops.kernels.trtri import MAX_N, trtri
from faer_tpu_torch.ops.matmul import matmul


def _mm_hi(a, b):
    """A·B in full FP32 whatever the tile GEMM switch says."""
    return matmul(None, a, b, precision="highest")


def invert_lower_triangular(t, *, unit: bool = False):
    """inv(L) for the lower triangle of ``t`` (unit diagonal if ``unit``)."""
    n = t.shape[0]
    if n <= MAX_N:
        return trtri(t.contiguous(), unit=unit)
    h = (n + 1) // 2
    ai = invert_lower_triangular(t[:h, :h], unit=unit)
    ci = invert_lower_triangular(t[h:, h:], unit=unit)
    off = -_mm_hi(_mm_hi(ci, t[h:, :h]), ai)
    out = t.new_zeros((n, n))
    # in place into the fresh output: saves the concatenations
    out[:h, :h] = ai
    out[h:, :h] = off
    out[h:, h:] = ci
    return out


def invert_upper_triangular(t, *, unit: bool = False):
    """inv(U) for the upper triangle of ``t`` (``triangular_inverse.rs:160``)."""
    return invert_lower_triangular(t.mT, unit=unit).mT
