"""Kernel 8: ``tile_matmul``, C = A·B on 128 × 128 output tiles.

Counterpart of ``pallas_matmul`` (``faer_tpu/ops/pallas/matmul_kernel.py:92``,
bodies ``_mm_padded :59`` and ``_mm_kernel :20``). The CUDA kernel
(``csrc/matmul.cu`` over ``csrc/tile_mma.cuh``) takes 2-D f32 operands in
the two modes of ``config.f32_precision`` and 2-D bf16 operands in one pass,
always accumulating in f32, and reads each operand through its strides, so
a transposed view costs no copy. :func:`tile_matmul_plain` computes the same
function in PyTorch: ``"highest"`` as one FP32 product, ``"high"`` as the
explicit bf16 split ``ah·bh + ah·bl + al·bh`` of three FP32 products of
bf16-valued operands, each of them exact.
"""
from __future__ import annotations

import torch

from faer_tpu_torch.core.config import check_f32_policy, config, count_launch
from faer_tpu_torch.core.errors import ShapeError
from faer_tpu_torch.ops.kernels import _build

_MODES = {"highest": 0, "high": 1}
_BF16_MODE = 2
_DTYPES = (torch.float32, torch.bfloat16)


def split_bf16(x):
    """``(hi, lo)`` as f32 tensors of bf16 values: ``hi = bf16(x)``,
    ``lo = bf16(x − hi)``, as ``_mm_kernel`` splits its operands."""
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def _f32_product(a, b):
    """A·B of f32 tensors in the precision of ``config.f32_precision``."""
    if a.is_cuda:
        check_f32_policy()
    if config.tile_precision() == "highest":
        return torch.matmul(a, b)
    ah, al = split_bf16(a)
    bh, bl = split_bf16(b)
    return torch.matmul(ah, bh) + torch.matmul(ah, bl) + torch.matmul(al, bh)


def _check(a, b, out_dtype):
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ShapeError(f"tile_matmul: needs (m, k)·(k, n), got "
                         f"{tuple(a.shape)}·{tuple(b.shape)}")
    if a.dtype != b.dtype or a.dtype not in _DTYPES:
        raise TypeError(f"tile_matmul: needs two float32 or two bfloat16 "
                        f"operands, got {a.dtype} and {b.dtype}")
    if out_dtype not in _DTYPES:
        raise TypeError(f"tile_matmul: out_dtype must be float32 or bfloat16, "
                        f"got {out_dtype}")
    if a.device != b.device or a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"tile_matmul: operands on {a.device} and {b.device}")


def tile_matmul_plain(a, b, *, out_dtype=None):
    """The function :func:`tile_matmul` computes, in PyTorch."""
    out_dtype = out_dtype or a.dtype
    _check(a, b, out_dtype)
    if a.dtype == torch.bfloat16:  # exact products, f32 sums
        if a.is_cuda:
            check_f32_policy()
        prod = torch.matmul(a.float(), b.float())
    else:
        prod = _f32_product(a, b)
    return prod.to(out_dtype)


def tile_matmul(a, b, *, out_dtype=None):
    """C = A·B of 2-D f32 or bf16 operands, f32 accumulation; the result in
    ``out_dtype`` (default: the operands' dtype). f32 operands multiply in
    ``config.f32_precision``: ``"highest"`` (FP32) or ``"high"`` (bf16x3)."""
    out_dtype = out_dtype or a.dtype
    _check(a, b, out_dtype)
    if a.device.type == "cpu":
        return tile_matmul_plain(a, b, out_dtype=out_dtype)
    mode = _BF16_MODE if a.dtype == torch.bfloat16 else _MODES[config.tile_precision()]
    m, k = a.shape
    n = b.shape[1]
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    if m == 0 or n == 0:
        return out
    with torch.cuda.device(a.device):  # the C entry launches on the current device
        code = _build.library().faer_tile_matmul(
            a.data_ptr(), a.stride(0), a.stride(1), b.data_ptr(), b.stride(0),
            b.stride(1), out.data_ptr(), m, n, k, mode,
            int(out_dtype == torch.bfloat16), _build.stream_of(a))
    _build.check("tile_matmul", code)
    count_launch("matmul")
    return out
