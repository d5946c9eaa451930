"""Typed errors and info structs (counterpart of ``faer_tpu/core/errors.py``).

The factorizations return an info dataclass of tensors that carries the
data-dependent outcome, with the same field names as the JAX package, so a
caller can read them without a host sync until it chooses to.
"""
from __future__ import annotations

import dataclasses

import torch


class FaerError(Exception):
    """Base class for all faer_tpu_torch errors."""


class NonPositivePivotError(FaerError):
    """LLT hit a non-positive pivot (matrix not positive definite)."""


class ShapeError(FaerError, ValueError):
    """Operand shapes are incompatible."""


@dataclasses.dataclass
class LltInfo:
    """faer ``LltInfo`` (``cholesky/llt/factor.rs:16``)."""

    dynamic_regularization_count: torch.Tensor  # int32 scalar
    success: torch.Tensor  # bool scalar: all pivots positive


@dataclasses.dataclass
class LuInfo:
    """Partial-pivot LU bookkeeping.

    ``transposition_count`` is the minimal transposition count of each
    panel's applied row permutation (``core.perm.perm_transposition_count``),
    summed over panels; its parity is the sign of the whole permutation.
    """

    transposition_count: torch.Tensor  # int32 scalar
    success: torch.Tensor  # bool scalar: no exactly-zero pivot


@dataclasses.dataclass
class SpectralInfo:
    """SVD/EVD: convergence flag and QR-iteration count."""

    converged: torch.Tensor  # bool scalar
    iterations: torch.Tensor  # int32 scalar
