"""Dtype policy (counterpart of ``faer_tpu/core/dtypes.py``).

The factorizations, their solves, the self-adjoint EVD and the SVD take
``torch.float32``, ``torch.float64``, ``torch.complex64`` and
``torch.complex128`` (:func:`require_field`), and so do the general EVD
(a complex matrix takes the complex Schur form) and the generalized EVD (a
complex pencil takes the complex QZ). Only the real QZ's own helpers
(``qz_real.real_qz``, ``qz_eigenvalues_pair``) take the real dtypes alone
(:func:`require_real`). What the dtype decides:

* the dense factorizations: float32 goes to the hand-written kernels
  (:func:`kernel_route`), as the JAX package's ``panel_kernels_enabled``
  picks its kernel route (``faer_tpu/core/config.py:99-107``, f32 only);
  float64 runs the JAX package's non-kernel bodies in plain PyTorch and
  launches no kernel;
* the spectral entry points (the self-adjoint EVD, the SVD, the general
  EVD): both dtypes run the same drivers, and each QR iteration is one
  launch of a batched kernel instantiated for float32 and for float64
  (``tridiag_qr_batched``, ``bidiag_qr_batched``, ``real_schur_batched``),
  as the JAX package runs f64 through the same spectral drivers; the
  general EVD of complex64 and complex128 input runs the complex Schur
  iteration, one launch of ``complex_schur_batched`` (instantiated for
  both) a direct call or AED window, and the generalized EVD of a complex
  pencil the complex QZ, one ``complex_hess_tri_batched`` launch a call
  and one ``complex_qz_batched`` launch a direct call or AED window;
* complex64 LLT and LDLT (and their solves) go through the interleaved
  real embedding (``linalg/cholesky.py``): a 2n float32 problem on the
  float32 route, so the ``llt_panel`` (or ``llt_leaf``) and ``trtri``
  kernels run; complex128 takes the float64 body the same way;
* every other complex factorization runs the non-kernel bodies natively in
  complex, as the JAX package keeps complex off its kernels
  (``faer_tpu/linalg/qr.py:233,253``); the self-adjoint EVD and the SVD of
  complex input reduce to a real tridiagonal or bidiagonal, whose QR
  iteration is the same one launch of ``tridiag_qr_batched`` /
  ``bidiag_qr_batched`` as for the real dtypes.

The dtype picks each route; no route is a fallback for another.

The other helpers stay generic over the real and complex torch dtypes so
the later slices can reuse them.
"""
from __future__ import annotations

import math

import torch


def real_dtype_of(dtype):
    """The associated real field: c64 → f32, c128 → f64, reals → themselves."""
    if dtype == torch.complex64:
        return torch.float32
    if dtype == torch.complex128:
        return torch.float64
    return dtype


def complex_dtype_of(dtype):
    """The complex dtype of the same precision: f64, c128 → c128; else c64."""
    if dtype in (torch.float64, torch.complex128):
        return torch.complex128
    return torch.complex64


def eps(dtype) -> float:
    """Machine epsilon of the associated real dtype (faer ``ApproxEq::eps``)."""
    return float(torch.finfo(real_dtype_of(dtype)).eps)


def min_positive(dtype) -> float:
    """The smallest positive normal number of the associated real dtype."""
    return float(torch.finfo(real_dtype_of(dtype)).tiny)


def deflation_stall_cap(dtype) -> int:
    """Exponent cap for the progressive deflation floor ``2**(stall // 5)``
    of the Schur iterations: keeps the loosened absolute floor at or below
    ``√eps·‖H‖`` in every dtype (11 in float32, 24 in float64)."""
    return min(24, int(-0.5 * math.log2(eps(dtype))))


def kernel_route(dtype) -> bool:
    """Whether a factorization of this dtype runs the hand-written kernels:
    float32 only, as on the JAX package's kernel route. A float64 input
    takes the non-kernel bodies because of its dtype, never as a fallback."""
    return dtype == torch.float32


def abs2(x):
    """|x|² entrywise, in x's real field (x·x for a real tensor)."""
    return x.real * x.real + x.imag * x.imag if x.is_complex() else x * x


def require_real(a, name: str) -> None:
    """Raise ``NotImplementedError`` unless ``a`` is float32 or float64: the
    real QZ's own helpers, whose complex form is ``qz``."""
    if a.dtype not in (torch.float32, torch.float64):
        raise NotImplementedError(
            f"{name}: float32 and float64 only, got {a.dtype}; a complex pencil "
            "takes qz (the complex QZ) and gevd")


def require_field(a, name: str) -> None:
    """Raise ``NotImplementedError`` unless ``a`` is float32, float64,
    complex64 or complex128."""
    if a.dtype not in (torch.float32, torch.float64, torch.complex64, torch.complex128):
        raise NotImplementedError(
            f"{name}: float32, float64, complex64 and complex128 only, got {a.dtype} "
            "(the dtypes of ROADMAP §1)")


