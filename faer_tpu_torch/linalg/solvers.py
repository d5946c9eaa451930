"""Decomposition objects and their solves (counterpart of
``faer_tpu/linalg/solvers.py``).

faer ``solvers.rs``: the ``Solve``/``SolveLstsq`` traits (``:21-93,639``)
and the decomposition structs (``:697-765``), built by the ``Mat`` methods
(``:346-634``). Each object is a frozen dataclass of tensors (factors and
info) with the JAX dataclass's field names, so that ``interop`` can carry
one across. The port has ``Llt``, ``PartialPivLu``, ``Qr``, ``Svd`` and
``SelfAdjointEigen``; the others wait for ROADMAP §1 items 8 and 9.
Complex input raises ``NotImplementedError`` naming item 10: the JAX
package's split (re, im) pair path is not ported, and native complex
factorizations are that item.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from faer_tpu_torch.core import dtypes
from faer_tpu_torch.core.config import host_read
from faer_tpu_torch.core.errors import (
    LltInfo,
    LuInfo,
    NonPositivePivotError,
    ShapeError,
    SpectralInfo,
)
from faer_tpu_torch.core.flags import Side
from faer_tpu_torch.core.mat import Mat, as_tensor
from faer_tpu_torch.linalg import cholesky as _ch
from faer_tpu_torch.linalg import lu as _lu
from faer_tpu_torch.linalg import qr as _qr
from faer_tpu_torch.ops.matmul import matmul


def _matrix(a, name: str):
    """The tensor of a ``Mat``, tensor or array-like; complex raises."""
    x = as_tensor(a.a if isinstance(a, Mat) else a, name)
    if x.is_complex():
        raise NotImplementedError(
            f"{name}: complex input is not ported to faer_tpu_torch yet "
            "(ROADMAP §1 item 10)")
    return x


def _operand(rhs, like):
    """A right-hand side as a tensor on ``like``'s device."""
    x = rhs.a if hasattr(rhs, "a") and isinstance(rhs.a, torch.Tensor) else rhs
    return as_tensor(x, "rhs", device=like.device)


def _lower_of(a, side: Side, name: str):
    a = _matrix(a, name)
    if a.dim() != 2 or a.shape[0] != a.shape[1]:
        raise ShapeError(f"{name}: expected a square matrix, got {tuple(a.shape)}")
    return a if side is Side.LOWER else a.mT


@dataclasses.dataclass(frozen=True)
class Llt:
    """Cholesky LLT solver object (faer ``solvers.rs:697``)."""

    l: torch.Tensor
    info: LltInfo

    @staticmethod
    def new(a, side: Side = Side.LOWER, *, check: bool = True) -> "Llt":
        """Factor the ``side`` triangle of ``a``; with ``check``, one host
        read of ``info.success`` raises ``NonPositivePivotError``."""
        l, info = _ch.llt_factor(_lower_of(a, side, "Llt"))
        if check and not host_read(info.success):
            raise NonPositivePivotError("matrix is not positive definite")
        return Llt(l=l, info=info)

    def solve(self, rhs):
        return _ch.llt_solve(self.l, _operand(rhs, self.l))

    def solve_conjugate(self, rhs):
        """Solve with conj(A): the plain solve for the port's real dtypes."""
        return self.solve(rhs)

    def inverse(self):
        return _ch.llt_inverse(self.l)

    def reconstruct(self):
        return _ch.llt_reconstruct(self.l)

    def determinant(self):
        d = torch.diagonal(self.l).prod()
        return d * d

    def logdet(self):
        return 2.0 * torch.log(torch.diagonal(self.l)).sum()

    def rank_update(self, w, alpha) -> "Llt":
        raise NotImplementedError(
            "Llt.rank_update (LLT rank up/downdates) is not ported to "
            "faer_tpu_torch yet (ROADMAP §1 item 8)")

    @property
    def L(self):
        return self.l


@dataclasses.dataclass(frozen=True)
class PartialPivLu:
    """Partial-pivot LU solver (faer ``solvers.rs:713``): ``A[row_perm] = L·U``."""

    lu: torch.Tensor
    row_perm: torch.Tensor
    info: LuInfo

    @staticmethod
    def new(a) -> "PartialPivLu":
        a = _matrix(a, "PartialPivLu")
        if a.dim() != 2 or a.shape[0] != a.shape[1]:
            raise ShapeError("PartialPivLu requires a square matrix")
        lu, perm, info = _lu.lu_in_place(a)
        return PartialPivLu(lu=lu, row_perm=perm, info=info)

    def solve(self, rhs):
        return _lu.lu_solve(self.lu, self.row_perm, _operand(rhs, self.lu))

    def solve_transpose(self, rhs):
        return _lu.lu_solve_transpose(self.lu, self.row_perm, _operand(rhs, self.lu))

    def inverse(self):
        return _lu.lu_inverse(self.lu, self.row_perm)

    def reconstruct(self):
        return _lu.lu_reconstruct(self.lu, self.row_perm)

    def determinant(self):
        return _lu.lu_determinant(self.lu, self.row_perm, self.info.transposition_count)

    @property
    def L(self):
        n = self.lu.shape[0]
        return torch.tril(self.lu, -1) + torch.eye(n, dtype=self.lu.dtype,
                                                   device=self.lu.device)

    @property
    def U(self):
        return torch.triu(self.lu)


@dataclasses.dataclass(frozen=True)
class Qr:
    """Householder QR solver (faer ``solvers.rs:733``)."""

    packed: torch.Tensor
    t_stack: torch.Tensor
    block: int

    @staticmethod
    def new(a) -> "Qr":
        packed, ts, block = _qr.qr_in_place(_matrix(a, "Qr"))
        return Qr(packed=packed, t_stack=ts, block=block)

    def solve(self, rhs):
        if self.packed.shape[0] != self.packed.shape[1]:
            raise ShapeError("Qr.solve requires a square matrix; use solve_lstsq")
        return _qr.qr_solve(self.packed, self.t_stack, self.block,
                            _operand(rhs, self.packed))

    def solve_lstsq(self, rhs):
        return _qr.qr_solve_lstsq(self.packed, self.t_stack, self.block,
                                  _operand(rhs, self.packed))

    def inverse(self):
        return _qr.qr_inverse(self.packed, self.t_stack, self.block)

    def reconstruct(self):
        return _qr.qr_reconstruct(self.packed, self.t_stack, self.block)

    def compute_q(self, *, thin: bool = True):
        return _qr.qr_compute_q(self.packed, self.t_stack, self.block, thin=thin)

    def apply_q(self, rhs, *, adjoint: bool = False):
        return _qr.qr_apply_q(self.packed, self.t_stack, self.block,
                              _operand(rhs, self.packed), adjoint=adjoint)

    @property
    def R(self):
        k = min(self.packed.shape)
        return torch.triu(self.packed)[:k, :]


@dataclasses.dataclass(frozen=True)
class Svd:
    """SVD solver object (faer ``solvers.rs:749``): ``A = U diag(S) Vᵀ``."""

    u: torch.Tensor
    s: torch.Tensor
    v: torch.Tensor
    info: SpectralInfo

    @staticmethod
    def new(a, *, thin: bool = True) -> "Svd":
        from faer_tpu_torch.linalg import svd as _svd

        u, s, v, info = _svd.svd(_matrix(a, "Svd"), thin=thin)
        return Svd(u=u, s=s, v=v, info=info)

    @property
    def U(self):
        return self.u

    @property
    def S(self):
        return self.s

    @property
    def V(self):
        return self.v

    def reconstruct(self):
        k = self.s.shape[0]
        return matmul(None, self.u[:, :k] * self.s[None, :], self.v[:, :k].mT)

    def pseudoinverse(self, tol=None):
        from faer_tpu_torch.linalg import svd as _svd

        k = self.s.shape[0]
        return _svd.pseudoinverse_from_svd(self.u[:, :k], self.s, self.v[:, :k], tol=tol)

    def solve_lstsq(self, rhs):
        return matmul(None, self.pseudoinverse(), _operand(rhs, self.u))

    def rank(self, tol=None):
        if tol is None:
            tol = (self.s.max() * max(self.u.shape[0], self.v.shape[0])
                   * dtypes.eps(self.u.dtype))
        return (self.s > tol).sum()


@dataclasses.dataclass(frozen=True)
class SelfAdjointEigen:
    """Self-adjoint EVD: ``A = V diag(w) Vᵀ``, w ascending (faer
    ``solvers.rs:757``)."""

    v: torch.Tensor
    w: torch.Tensor
    info: SpectralInfo

    @staticmethod
    def new(a, side: Side = Side.LOWER) -> "SelfAdjointEigen":
        from faer_tpu_torch.linalg import evd as _evd

        w, v, info = _evd.self_adjoint_evd(_lower_of(a, side, "SelfAdjointEigen"))
        return SelfAdjointEigen(v=v, w=w, info=info)

    @property
    def eigenvalues(self):
        return self.w

    @property
    def eigenvectors(self):
        return self.v

    def reconstruct(self):
        return matmul(None, self.v * self.w[None, :], self.v.mT)

    def solve(self, rhs):
        y = matmul(None, self.v.mT, _operand(rhs, self.v))
        return matmul(None, self.v, y / self.w[:, None])


SOLVERS: dict[str, Any] = {cls.__name__: cls for cls in
                           (Llt, PartialPivLu, Qr, Svd, SelfAdjointEigen)}
