"""Dtype policy (counterpart of ``faer_tpu/core/dtypes.py``).

The factorizations take ``torch.float32`` and ``torch.float64``
(:func:`require_real`). The dtype alone picks the route, as the JAX
package's ``panel_kernels_enabled`` picks it (``faer_tpu/core/config.py:
99-107``, f32 only): float32 goes to the hand-written kernels
(:func:`kernel_route`), float64 to the JAX package's non-kernel bodies in
plain PyTorch. The spectral entry points are still float32 only
(:func:`require_f32`). The other helpers stay generic over the real and
complex torch dtypes so the later slices can reuse them.
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


def kernel_route(dtype) -> bool:
    """Whether a factorization of this dtype runs the hand-written kernels:
    float32 only, as on the JAX package's kernel route. A float64 input
    takes the non-kernel bodies because of its dtype, never as a fallback."""
    return dtype == torch.float32


def require_real(a, name: str) -> None:
    """Raise ``NotImplementedError`` unless ``a`` is float32 or float64."""
    if a.dtype not in (torch.float32, torch.float64):
        raise NotImplementedError(
            f"{name}: float32 and float64 only, got {a.dtype}; complex "
            "factorizations are ROADMAP §1 item 10")


def require_f32(a, name: str) -> None:
    """Raise ``NotImplementedError`` unless ``a`` is float32 (the spectral
    entry points)."""
    if a.dtype != torch.float32:
        raise NotImplementedError(
            f"{name}: float32 only, got {a.dtype}; the f64 spectral entry "
            "points and the complex ones are ROADMAP §1 items 5c (what "
            "remains of it) and 10")
