"""Kernel 11: ``syrk_lower_sub``, C − A·Aᵀ on the lower tiles.

Counterpart of ``syrk_lower_sub`` (``faer_tpu/ops/pallas/syrk_kernel.py:108``,
bodies ``_syrk_padded :71`` and ``_syrk_kernel :51``), with the numerics of
``tile_matmul`` in both modes of ``config.f32_precision``. The CUDA kernel
(``csrc/syrk.cu``) runs one CTA per lower 128 × 128 tile pair and writes
only the elements on and below the diagonal into a copy of C, so the strict
upper triangle of the result holds C's values (the JAX kernel leaves it
unspecified). No driver calls it: the JAX package keeps it unwired
(``faer_tpu/linalg/cholesky.py:157-164``) and so does the port.
"""
from __future__ import annotations

import torch

from faer_tpu_torch.core.config import check_f32_policy, config, count_launch
from faer_tpu_torch.core.errors import ShapeError
from faer_tpu_torch.ops.kernels import _build
from faer_tpu_torch.ops.kernels.matmul import _MODES, split_bf16


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


def syrk_lower_sub(c, a):
    """C − A·Aᵀ on and below the diagonal of the (m, m) f32 ``c``, for an
    (m, k) f32 ``a``; above the diagonal the result holds C's values."""
    _check(c, a)
    if c.device.type == "cpu":
        return syrk_lower_sub_plain(c, a)
    mode = _MODES[config.tile_precision()]
    out = c.clone(memory_format=torch.contiguous_format)
    m, k = a.shape
    if m == 0:
        return out
    with torch.cuda.device(c.device):  # the C entry launches on the current device
        code = _build.library().faer_syrk_lower_sub(
            a.data_ptr(), a.stride(0), a.stride(1), out.data_ptr(), m, k, mode,
            _build.stream_of(c))
    _build.check("syrk_lower_sub", code)
    count_launch("syrk")
    return out
