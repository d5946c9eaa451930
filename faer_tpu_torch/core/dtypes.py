"""Dtype policy (counterpart of ``faer_tpu/core/dtypes.py``).

The port computes in ``torch.float32``: the hand-written kernels take f32
only, and :func:`require_f32` turns other dtypes away at the factorizations'
front doors. The other helpers stay generic over the real and complex torch
dtypes so the later slices can reuse them.
"""
from __future__ import annotations

import torch


def real_dtype_of(dtype):
    """The associated real field: c64 → f32, c128 → f64, reals → themselves."""
    if dtype == torch.complex64:
        return torch.float32
    if dtype == torch.complex128:
        return torch.float64
    return dtype


def eps(dtype) -> float:
    """Machine epsilon of the associated real dtype (faer ``ApproxEq::eps``)."""
    return float(torch.finfo(real_dtype_of(dtype)).eps)


def require_f32(a, name: str) -> None:
    """Raise ``NotImplementedError`` unless ``a`` is float32."""
    if a.dtype != torch.float32:
        raise NotImplementedError(
            f"{name}: float32 only, got {a.dtype}; the f64 and complex "
            "factorizations take the JAX package's non-kernel panels, "
            "ROADMAP §1 items 5c (f64) and 10 (complex)")
