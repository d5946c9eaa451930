"""Reductions: norms, sums, diagonal products (counterpart of
``faer_tpu/ops/reductions.py``).

faer ``linalg/reductions/*``: ``norm_l1``, ``norm_l2`` (overflow-safe,
``norm_l2.rs:81,156``), ``norm_l2_sqr``, ``norm_max``, ``sum``,
``determinant``. As in the JAX package, the overflow-safe 2-norm rescales
by the largest magnitude (one extra max pass) where faer keeps three
accumulators. Every norm is over all entries (the Frobenius norm for a
matrix) and returns a 0-d tensor of the real dtype.
"""
from __future__ import annotations

import torch

from faer_tpu_torch.core import dtypes
from faer_tpu_torch.core.flags import Norm


def _abs_real(x):
    return x.abs().to(dtypes.real_dtype_of(x.dtype))


def norm_max(x):
    a = _abs_real(x)
    return a.max() if x.numel() else a.new_zeros(())


def norm_l1(x):
    return _abs_real(x).sum()


def norm_l2_sqr(x):
    a = _abs_real(x)
    return (a * a).sum()


def norm_l2(x):
    """Overflow/underflow-safe ‖x‖₂ by max rescaling."""
    a = _abs_real(x)
    m = a.max() if x.numel() else a.new_zeros(())
    scaled = a / torch.where(m == 0, torch.ones_like(m), m)
    return m * torch.sqrt((scaled * scaled).sum())


def norm(x, kind: Norm = Norm.L2):
    return {Norm.L1: norm_l1, Norm.L2: norm_l2, Norm.L2_SQR: norm_l2_sqr,
            Norm.MAX: norm_max}[kind](x)


def sum_all(x):
    return x.sum()


def prod_diag(x):
    """Product of the diagonal entries (determinant of a triangular factor)."""
    return torch.diagonal(x).prod()


def log_abs_det_diag(x):
    """``(sign, log|det|)`` of a triangular factor, overflow-safe."""
    d = torch.diagonal(x)
    mag = d.abs()
    if d.is_complex():
        unit = d / torch.where(mag == 0, torch.ones_like(mag), mag).to(d.dtype)
        sign = torch.where(mag == 0, torch.zeros_like(d), unit).prod()
    else:
        sign = torch.sign(d).prod()
    return sign, torch.log(mag).sum()
