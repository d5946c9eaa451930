"""``Col`` / ``Row`` / ``Diag`` facades (counterpart of ``faer_tpu/core/vec.py``).

faer's ``Col``, ``Row`` and ``Diag`` (``faer/src/col``, ``row``,
``diag/mod.rs:28``): one facade each over a 1-D tensor, with the device
rule of ``Mat`` (a tensor keeps its device; other data goes to ``"cuda"``
unless ``device="cpu"``).
"""
from __future__ import annotations

import numpy as np
import torch

from faer_tpu_torch.core.mat import DEFAULT_DEVICE, Mat, as_tensor


def _product(a, b):
    """a @ b in full FP32 (the JAX facade's plain ``@``)."""
    from faer_tpu_torch.ops.matmul import matmul

    return matmul(None, a, b, precision="highest")


class _Vec:
    __slots__ = ("a",)
    __array_priority__ = 100

    def __init__(self, a, *, device=None):
        a = as_tensor(a.a if isinstance(a, _Vec) else a, type(self).__name__,
                      device=device)
        if a.dim() != 1:
            raise ValueError(f"{type(self).__name__} expects a 1-D array, "
                             f"got {tuple(a.shape)}")
        self.a = a

    def __len__(self):
        return self.a.shape[0]

    @property
    def shape(self):
        return tuple(self.a.shape)

    @property
    def dtype(self):
        return self.a.dtype

    @property
    def device(self):
        return self.a.device

    def __array__(self, dtype=None, copy=None):
        return np.asarray(self.a.detach().cpu().resolve_conj(), dtype=dtype)

    def __getitem__(self, i):
        return self.a[i]

    def __repr__(self):
        return f"{type(self).__name__}({self.a!r})"

    @staticmethod
    def _coerce(x):
        return x.a if isinstance(x, (_Vec, Mat)) else x

    def norm_l1(self):
        from faer_tpu_torch.ops import reductions

        return reductions.norm_l1(self.a)

    def norm_l2(self):
        from faer_tpu_torch.ops import reductions

        return reductions.norm_l2(self.a)

    def norm_max(self):
        from faer_tpu_torch.ops import reductions

        return reductions.norm_max(self.a)

    def sum(self):
        return self.a.sum()


class Col(_Vec):
    """Column vector (faer ``Col``)."""

    @staticmethod
    def zeros(n, dtype=torch.float32, device=DEFAULT_DEVICE):
        return Col(torch.zeros((n,), dtype=dtype, device=device))

    @staticmethod
    def ones(n, dtype=torch.float32, device=DEFAULT_DEVICE):
        return Col(torch.ones((n,), dtype=dtype, device=device))

    @staticmethod
    def from_fn(n, f, dtype=torch.float32, device=DEFAULT_DEVICE):
        return Col(torch.as_tensor(f(torch.arange(n, device=device)), dtype=dtype,
                                   device=device))

    @property
    def T(self) -> "Row":
        return Row(self.a)

    transpose = T

    @property
    def H(self) -> "Row":
        return Row(self.a.conj())

    adjoint = H

    def as_mat(self) -> Mat:
        return Mat(self.a[:, None])

    def __add__(self, o):
        return Col(self.a + self._coerce(o))

    __radd__ = __add__

    def __sub__(self, o):
        return Col(self.a - self._coerce(o))

    def __rsub__(self, o):
        return Col(self._coerce(o) - self.a)

    def __mul__(self, o):
        return Col(self.a * self._coerce(o))

    __rmul__ = __mul__

    def __neg__(self):
        return Col(-self.a)

    def __matmul__(self, o):  # outer with a Row-shaped matrix; Col @ Col is invalid
        other = self._coerce(o)
        if other.dim() == 1:
            raise ValueError("Col @ Col is not defined; use col.T @ col")
        return Mat(_product(self.a[:, None], other))


class Row(_Vec):
    """Row vector (faer ``Row``)."""

    @staticmethod
    def zeros(n, dtype=torch.float32, device=DEFAULT_DEVICE):
        return Row(torch.zeros((n,), dtype=dtype, device=device))

    @property
    def T(self) -> Col:
        return Col(self.a)

    transpose = T

    @property
    def H(self) -> Col:
        return Col(self.a.conj())

    adjoint = H

    def as_mat(self) -> Mat:
        return Mat(self.a[None, :])

    def __add__(self, o):
        return Row(self.a + self._coerce(o))

    __radd__ = __add__

    def __sub__(self, o):
        return Row(self.a - self._coerce(o))

    def __mul__(self, o):
        return Row(self.a * self._coerce(o))

    __rmul__ = __mul__

    def __neg__(self):
        return Row(-self.a)

    def __matmul__(self, o):
        other = self._coerce(o)
        if other.dim() == 1:  # Row @ Col = scalar
            return (self.a * other).sum()
        return Row(_product(self.a[None, :], other)[0])


class Diag(_Vec):
    """Diagonal matrix over a vector (faer ``Diag``)."""

    def column_vector(self) -> Col:
        return Col(self.a)

    def as_mat(self) -> Mat:
        return Mat(torch.diag(self.a))

    def inverse(self) -> "Diag":
        return Diag(1.0 / self.a)

    def __matmul__(self, o):
        other = self._coerce(o)
        if other.dim() == 1:
            return Col(self.a * other)
        return Mat(self.a[:, None] * other)

    def __rmatmul__(self, o):
        other = self._coerce(o)
        if other.dim() == 1:
            return Row(other * self.a)
        return Mat(other * self.a[None, :])

    def __mul__(self, o):
        return Diag(self.a * self._coerce(o))

    __rmul__ = __mul__
