"""Per-algorithm parameter structs (counterpart of ``faer_tpu/core/params.py``).

Frozen dataclasses with the JAX package's field names and defaults, so that
a call written against ``faer_tpu`` ports unchanged.
"""
from __future__ import annotations

import dataclasses

import torch

from faer_tpu_torch.core import dtypes


@dataclasses.dataclass(frozen=True)
class LltParams:
    """faer ``LltParams`` (``cholesky/llt/factor.rs:40``).

    ``block_size``: panel width of the blocked factor (``None``: 256 for
    n ≥ 1024, else 64). ``kernel_leaf``: leaf width of the off-route
    recursive driver (``None``: 128), clamped to [128, 512].
    ``recursion_threshold`` is the JAX package's non-kernel leaf width,
    kept for parity; the port always takes the kernel route.
    """

    block_size: int | None = None
    recursion_threshold: int = 64
    kernel_leaf: int | None = None

    @staticmethod
    def auto(dtype=torch.float32, shape=None) -> "LltParams":
        return LltParams()


@dataclasses.dataclass(frozen=True)
class PartialPivLuParams:
    """faer ``PartialPivLuParams`` (``lu/partial_pivoting/factor.rs:190``).

    ``block_size``: panel width of the off-route recursive driver (``None``:
    512, 256, 64 or min(m, n) by size); ``kernel_leaf``: its leaf width
    (``None``: 256), clamped to [128, 512].
    """

    block_size: int | None = None
    recursion_threshold: int = 64
    kernel_leaf: int | None = None

    @staticmethod
    def auto(dtype=torch.float32, shape=None) -> "PartialPivLuParams":
        return PartialPivLuParams()


@dataclasses.dataclass(frozen=True)
class QrParams:
    """faer ``QrParams`` (``qr/no_pivoting/factor.rs:119``).

    ``block_size``: panel width (``None``: 512, 256, 128, 32 or min(m, n)
    by size); ``kernel_leaf``: width handed to the ``qr_panel`` kernel
    (``None``: 128), clamped to [128, 512].
    """

    block_size: int | None = None
    kernel_leaf: int | None = None

    @staticmethod
    def auto(dtype=torch.float32, shape=None) -> "QrParams":
        return QrParams()


@dataclasses.dataclass(frozen=True)
class SvdParams:
    """faer ``SvdParams`` (``svd/mod.rs:37-57``).

    ``qr_ratio_threshold``: QR-preprocess when m/n exceeds it (faer 11/6).
    ``max_iters_per_value``: the bidiagonal QR iteration's budget, times n.
    ``max_sweeps`` and ``recursion_threshold`` are kept for parity with the
    JAX package, which does not read them on this path either.
    """

    qr_ratio_threshold: float = 11.0 / 6.0
    max_sweeps: int = 24
    max_iters_per_value: int = 30
    recursion_threshold: int = 128

    @staticmethod
    def auto(dtype=torch.float32, shape=None) -> "SvdParams":
        return SvdParams()


@dataclasses.dataclass(frozen=True)
class EvdParams:
    """Self-adjoint and general EVD budgets (faer ``evd/mod.rs``)."""

    max_iters_per_value: int = 30
    recursion_threshold: int = 32

    @staticmethod
    def auto(dtype=torch.float32, shape=None) -> "EvdParams":
        return EvdParams()


@dataclasses.dataclass(frozen=True)
class LltRegularization:
    """Dynamic regularization (faer ``cholesky/llt/factor.rs:8``).

    If ``epsilon > 0``: any pivot ``≤ delta`` is replaced by ``epsilon`` and
    counted in ``LltInfo.dynamic_regularization_count``.
    """

    epsilon: float = 0.0
    delta: float = 0.0

    @staticmethod
    def auto(dtype=torch.float32, shape=None) -> "LltRegularization":
        e = dtypes.eps(dtype)
        return LltRegularization(epsilon=e, delta=e)
