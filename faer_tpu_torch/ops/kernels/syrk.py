"""Kernel 11: ``syrk_lower_sub``, C − A·Aᵀ on the lower tiles.

Counterpart of ``syrk_lower_sub`` (``faer_tpu/ops/pallas/syrk_kernel.py:108``,
bodies ``_syrk_padded :71`` and ``_syrk_kernel :51``), with the numerics of
``tile_matmul`` in both modes of ``config.f32_precision``. The CUDA kernel
(``csrc/syrk.cu``, on the mainloops of ``csrc/gemm_tile.cuh`` that
``tile_matmul`` runs too) computes the lower 128 × 128 tile pairs only and
writes the whole result in one pass: C − A·Aᵀ on and below the diagonal,
C's values above it (the JAX kernel leaves them unspecified), each element
of C read once. No driver calls it: the JAX package keeps it unwired
(``faer_tpu/linalg/cholesky.py:157-164``) and so does the port.
"""
from __future__ import annotations

import torch

from faer_tpu_torch.core.config import check_f32_policy, config, count_launch
from faer_tpu_torch.core.errors import ShapeError
from faer_tpu_torch.ops.kernels import _build
from faer_tpu_torch.ops.kernels.matmul import _MODES, _READS, _cp_read, _ldk, split_bf16

# how the FP32 kernel reads A: the matmul plan's reads (csrc/gemm_tile.cuh
# enum Read), and "cp16_k", a K-major A with 16-byte aligned rows read 16
# bytes at a time by a transposing pass into M-major scratch (csrc/syrk.cu
# kTransposeK), which the mainloop then copies as "cp16_mn"
_SYRK_READS = {**_READS, "cp16_k": 6}


def _check(c, a):
    for x, name in ((c, "c"), (a, "a")):
        _build.check_f32_matrix(x, f"syrk_lower_sub ({name})")
    m = c.shape[0]
    if c.shape[1] != m or a.shape[0] != m:
        raise ShapeError(f"syrk_lower_sub: needs c (m, m) and a (m, k), got "
                         f"{tuple(c.shape)} and {tuple(a.shape)}")
    if c.device != a.device:
        raise ValueError(f"syrk_lower_sub: operands on {c.device} and {a.device}")


def syrk_lower_sub_plain(c, a):
    """``tril(C − A·Aᵀ) + triu(C, 1)``, the product in ``config.f32_precision``."""
    _check(c, a)
    if c.is_cuda:
        check_f32_policy()
    if config.tile_precision() == "highest":
        prod = torch.matmul(a, a.mT)
    else:
        ah, al = split_bf16(a)
        prod = (torch.matmul(ah, ah.mT) + torch.matmul(ah, al.mT)
                + torch.matmul(al, ah.mT))
    return torch.tril(c - prod) + torch.triu(c, 1)


def syrk_read(a) -> str:
    """How the FP32 kernel reads the (m, k) ``a``, from its strides and
    alignment: ``"cp16_k"`` (16-byte reads along k, by a transposing pass
    into M-major scratch), ``"cp16_mn"`` (16-byte copies along m), else
    4-byte copies walking the smaller stride. A and B = Aᵀ are read the
    same way."""
    s_r, s_k = a.stride()
    if s_k == 1 and s_r % 4 == 0 and a.data_ptr() % 16 == 0:
        return "cp16_k"
    return _cp_read(a.data_ptr(), s_r, s_k)


def syrk_lower_sub(c, a):
    """C − A·Aᵀ on and below the diagonal of the (m, m) f32 ``c``, for an
    (m, k) f32 ``a``; above the diagonal the result holds C's values. On a
    CUDA tensor ``a`` may have any strides; ``c`` is read in place when its
    columns are contiguous (any row stride), else from a contiguous copy."""
    _check(c, a)
    if c.device.type == "cpu":
        return syrk_lower_sub_plain(c, a)
    mode = _MODES[config.tile_precision()]
    m, k = a.shape
    out = torch.empty((m, m), dtype=c.dtype, device=c.device)
    if m == 0:
        return out
    if m > 1 and (c.stride(1) != 1 or c.stride(0) < m):
        c = c.contiguous()
    ldc = c.stride(0) if m > 1 else 1
    ldk, ldt = _ldk(k), -(-m // 4) * 4
    read = syrk_read(a)
    # held to the end of the call: A's bf16 hi and lo (256-byte aligned
    # halves), or its M-major copy
    scratch = hi = lo = at = None
    if mode == _MODES["high"] and k > 0:
        half = -(-m * ldk * 2 // 256) * 256
        scratch = torch.empty(2 * half, dtype=torch.uint8, device=c.device)
        hi, lo = scratch.data_ptr(), scratch.data_ptr() + half
    elif read == "cp16_k" and k > 0:
        scratch = torch.empty(k * ldt, dtype=torch.float32, device=c.device)
        at = scratch.data_ptr()
    with torch.cuda.device(c.device):  # the C entry launches on the current device
        code = _build.library().faer_syrk_lower_sub(
            a.data_ptr(), a.stride(0), a.stride(1), c.data_ptr(), ldc, out.data_ptr(), m, k,
            mode, _SYRK_READS[read], hi, lo, ldk, at, ldt, _build.stream_of(c))
    _build.check("syrk_lower_sub", code)
    count_launch("syrk")
    return out
