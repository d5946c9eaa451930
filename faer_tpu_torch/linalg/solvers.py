"""Decomposition objects and their solves (counterpart of
``faer_tpu/linalg/solvers.py``).

faer ``solvers.rs``: the ``Solve``/``SolveLstsq`` traits (``:21-93,639``)
and the decomposition structs (``:697-765``), built by the ``Mat`` methods
(``:346-634``). Each object is a frozen dataclass of tensors (factors and
info) with the JAX dataclass's field names, so that ``interop`` can carry
one across. The port has ``Llt``, ``Ldlt``, ``PivLlt``, ``Lblt``,
``PartialPivLu``, ``FullPivLu``, ``Qr``, ``ColPivQr``, ``Svd``,
``SelfAdjointEigen``, ``Eigen`` (the general EVD) and
``GeneralizedEigen`` (the pencil's EVD by QZ). Every object takes float32,
float64, complex64 and complex128, as the JAX package's native path does
(the JAX package's split (re, im) pair path is not ported: ``interop``
turns its pairs into complex tensors); a complex determinant is complex,
L's and D's diagonals real; ``Eigen`` of complex input runs the complex
Schur form, ``GeneralizedEigen`` of a complex pencil the complex QZ (a real
B promoted to a complex A's dtype). A real factor solves a complex
right-hand side as its real and imaginary parts; a complex factor promotes
a real one.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from faer_tpu_torch.core import dtypes
from faer_tpu_torch.core.config import host_read
from faer_tpu_torch.core.errors import (
    LbltInfo,
    LdltInfo,
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


def _matrix(a, name: str, device=None):
    """The tensor of a ``Mat``, tensor or array-like (on ``device`` when
    given)."""
    return as_tensor(a.a if isinstance(a, Mat) else a, name, device=device)


def _operand(rhs, like):
    """A right-hand side as a tensor on ``like``'s device."""
    x = rhs.a if hasattr(rhs, "a") and isinstance(rhs.a, torch.Tensor) else rhs
    return as_tensor(x, "rhs", device=like.device)


def _solve(fn, like, rhs):
    """``fn(b)`` for the right-hand side ``rhs`` against the factor
    ``like``: a complex factor takes b in its dtype; a real factor solves a
    complex b as its real and imaginary parts."""
    b = _operand(rhs, like)
    if like.is_complex():
        return fn(b.to(like.dtype))
    if b.is_complex():
        return torch.complex(fn(b.real), fn(b.imag))
    return fn(b)


def _lower_of(a, side: Side, name: str):
    a = _matrix(a, name)
    if a.dim() != 2 or a.shape[0] != a.shape[1]:
        raise ShapeError(f"{name}: expected a square matrix, got {tuple(a.shape)}")
    return a if side is Side.LOWER else a.mH.resolve_conj()


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
        return _solve(lambda b: _ch.llt_solve(self.l, b), self.l, rhs)

    def solve_conjugate(self, rhs):
        """Solve with conj(A): conj(solve(conj(L), conj(b)))."""
        lc = self.l.conj().resolve_conj()
        return _solve(lambda b: _ch.llt_solve(lc, b.conj()).conj().resolve_conj(),
                      self.l, rhs)

    def inverse(self):
        return _ch.llt_inverse(self.l)

    def reconstruct(self):
        return _ch.llt_reconstruct(self.l)

    def determinant(self):
        """det(A) = ∏ L_ii², real, in the factor's dtype."""
        d = torch.diagonal(self.l).real.prod()
        return (d * d).to(self.l.dtype)

    def logdet(self):
        return 2.0 * torch.log(torch.diagonal(self.l).real).sum()

    def rank_update(self, w, alpha) -> "Llt":
        """The factor of ``L Lᴴ + α w wᴴ`` for an (n,) or (n, r) ``w``;
        ``alpha`` a Python float, negative for a downdate."""
        return Llt(l=_ch.llt_rank_r_update(self.l, _operand(w, self.l), alpha),
                   info=self.info)

    @property
    def L(self):
        return self.l


@dataclasses.dataclass(frozen=True)
class Ldlt:
    """LDLT solver object (faer ``solvers.rs:701``): ``ld`` packs unit L
    strictly below the diagonal and D on it."""

    ld: torch.Tensor
    info: LdltInfo

    @staticmethod
    def new(a, side: Side = Side.LOWER) -> "Ldlt":
        ld, info = _ch.ldlt_factor(_lower_of(a, side, "Ldlt"))
        return Ldlt(ld=ld, info=info)

    def solve(self, rhs):
        return _solve(lambda b: _ch.ldlt_solve(self.ld, b), self.ld, rhs)

    def inverse(self):
        n = self.ld.shape[0]
        return _ch.ldlt_solve(self.ld, torch.eye(n, dtype=self.ld.dtype,
                                                 device=self.ld.device))

    def reconstruct(self):
        return _ch.ldlt_reconstruct(self.ld)

    def determinant(self):
        return torch.diagonal(self.ld).real.prod().to(self.ld.dtype)

    def rank_update(self, w, alpha) -> "Ldlt":
        """L D Lᴴ + α w wᴴ (faer ``ldlt/update.rs:376``)."""
        return Ldlt(ld=_ch.ldlt_rank_r_update(self.ld, _operand(w, self.ld), alpha),
                    info=self.info)

    @property
    def D(self):
        return torch.diagonal(self.ld).real


@dataclasses.dataclass(frozen=True)
class PivLlt:
    """Diagonal-pivoted LLT (rank-revealing, PSD): ``A[perm][:, perm] =
    L Lᴴ``, the columns of L past ``rank`` zero."""

    l: torch.Tensor
    perm: torch.Tensor
    rank: torch.Tensor
    info: LltInfo

    @staticmethod
    def new(a, side: Side = Side.LOWER) -> "PivLlt":
        l, perm, rank, info = _ch.piv_llt_factor(_lower_of(a, side, "PivLlt"))
        return PivLlt(l=l, perm=perm, rank=rank, info=info)

    def solve(self, rhs):
        return _solve(lambda b: _ch.piv_llt_solve(self.l, self.perm, b), self.l, rhs)

    def reconstruct(self):
        return _ch.piv_llt_reconstruct(self.l, self.perm)


@dataclasses.dataclass(frozen=True)
class Lblt:
    """Bunch–Kaufman LBLT (faer ``solvers.rs:705``): ``A[perm][:, perm] =
    L B Lᴴ``, B block diagonal with 1×1 and 2×2 blocks."""

    lb: torch.Tensor
    subdiag: torch.Tensor
    perm: torch.Tensor
    info: LbltInfo

    @staticmethod
    def new(a, side: Side = Side.LOWER) -> "Lblt":
        lb, subdiag, perm, info = _ch.lblt_factor(_lower_of(a, side, "Lblt"))
        return Lblt(lb=lb, subdiag=subdiag, perm=perm, info=info)

    def solve(self, rhs):
        return _solve(lambda b: _ch.lblt_solve(self.lb, self.subdiag, self.perm, b),
                      self.lb, rhs)

    def reconstruct(self):
        return _ch.lblt_reconstruct(self.lb, self.subdiag, self.perm)


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
        return _solve(lambda b: _lu.lu_solve(self.lu, self.row_perm, b), self.lu, rhs)

    def solve_transpose(self, rhs):
        """Solve Aᵀ x = b (no conjugation, as the reference's)."""
        return _solve(lambda b: _lu.lu_solve_transpose(self.lu, self.row_perm, b),
                      self.lu, rhs)

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
class FullPivLu:
    """Full-pivot LU (faer ``solvers.rs:721``): ``A[row_perm][:, col_perm]
    = L·U``."""

    lu: torch.Tensor
    row_perm: torch.Tensor
    col_perm: torch.Tensor
    info: LuInfo

    @staticmethod
    def new(a) -> "FullPivLu":
        lu, rp, cp, info = _lu.full_piv_lu_in_place(_matrix(a, "FullPivLu"))
        return FullPivLu(lu=lu, row_perm=rp, col_perm=cp, info=info)

    def solve(self, rhs):
        return _solve(lambda b: _lu.full_piv_lu_solve(self.lu, self.row_perm,
                                                      self.col_perm, b), self.lu, rhs)

    def reconstruct(self):
        return _lu.full_piv_lu_reconstruct(self.lu, self.row_perm, self.col_perm)

    def determinant(self):
        return _lu.lu_determinant(self.lu, self.row_perm, self.info.transposition_count)

    def rank(self, tol=None):
        d = torch.diagonal(self.lu).abs()
        if tol is None:
            tol = d.max() * max(self.lu.shape) * dtypes.eps(self.lu.dtype)
        return (d > tol).sum()


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
        return _solve(lambda b: _qr.qr_solve(self.packed, self.t_stack, self.block, b),
                      self.packed, rhs)

    def solve_lstsq(self, rhs):
        return _solve(lambda b: _qr.qr_solve_lstsq(self.packed, self.t_stack,
                                                   self.block, b), self.packed, rhs)

    def inverse(self):
        return _qr.qr_inverse(self.packed, self.t_stack, self.block)

    def reconstruct(self):
        return _qr.qr_reconstruct(self.packed, self.t_stack, self.block)

    def compute_q(self, *, thin: bool = True):
        return _qr.qr_compute_q(self.packed, self.t_stack, self.block, thin=thin)

    def apply_q(self, rhs, *, adjoint: bool = False):
        return _solve(lambda b: _qr.qr_apply_q(self.packed, self.t_stack, self.block, b,
                                               adjoint=adjoint), self.packed, rhs)

    @property
    def R(self):
        k = min(self.packed.shape)
        return torch.triu(self.packed)[:k, :]


@dataclasses.dataclass(frozen=True)
class ColPivQr:
    """Column-pivoted QR (faer ``solvers.rs:741``): ``A[:, col_perm] = Q R``,
    the reflectors below the diagonal of ``packed`` with their ``taus``."""

    packed: torch.Tensor
    taus: torch.Tensor
    col_perm: torch.Tensor

    @staticmethod
    def new(a) -> "ColPivQr":
        packed, taus, perm = _qr.col_piv_qr_in_place(_matrix(a, "ColPivQr"))
        return ColPivQr(packed=packed, taus=taus, col_perm=perm)

    def solve(self, rhs):
        return self.solve_lstsq(rhs)

    def solve_lstsq(self, rhs):
        return _solve(lambda b: _qr.col_piv_qr_solve_lstsq(self.packed, self.taus,
                                                           self.col_perm, b),
                      self.packed, rhs)

    def reconstruct(self):
        return _qr.col_piv_qr_reconstruct(self.packed, self.taus, self.col_perm)

    def rank(self, tol=None):
        k = min(self.packed.shape)
        d = torch.diagonal(self.packed[:k, :k]).abs()
        if tol is None:
            tol = d.max() * max(self.packed.shape) * dtypes.eps(self.packed.dtype)
        return (d > tol).sum()


@dataclasses.dataclass(frozen=True)
class Svd:
    """SVD solver object (faer ``solvers.rs:749``): ``A = U diag(S) Vᴴ``."""

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
        return matmul(None, self.u[:, :k] * self.s[None, :], self.v[:, :k].mH)

    def pseudoinverse(self, tol=None):
        from faer_tpu_torch.linalg import svd as _svd

        k = self.s.shape[0]
        return _svd.pseudoinverse_from_svd(self.u[:, :k], self.s, self.v[:, :k], tol=tol)

    def solve_lstsq(self, rhs):
        return _solve(lambda b: matmul(None, self.pseudoinverse(), b), self.u, rhs)

    def rank(self, tol=None):
        if tol is None:
            tol = (self.s.max() * max(self.u.shape[0], self.v.shape[0])
                   * dtypes.eps(self.u.dtype))
        return (self.s > tol).sum()


@dataclasses.dataclass(frozen=True)
class SelfAdjointEigen:
    """Self-adjoint EVD: ``A = V diag(w) Vᴴ``, w real ascending (faer
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
        return matmul(None, self.v * self.w[None, :], self.v.mH)

    def solve(self, rhs):
        """x = V diag(w)⁻¹ Vᴴ b for an (n,) or (n, k) right-hand side (or a
        ``Col``/``Mat``); x has b's shape."""

        def one(b):
            y = matmul(None, self.v.mH, b)
            w = self.w if y.dim() == 1 else self.w[:, None]  # y's first dimension
            return matmul(None, self.v, y / w)

        return _solve(one, self.v, rhs)


@dataclasses.dataclass(frozen=True)
class Eigen:
    """General eigendecomposition: A V = V diag(w), w and V complex
    (complex64 from float32 and complex64 input, complex128 from float64
    and complex128; faer ``solvers.rs:761``)."""

    v: torch.Tensor
    w: torch.Tensor
    info: SpectralInfo

    @staticmethod
    def new(a) -> "Eigen":
        from faer_tpu_torch.linalg import evd as _evd

        w, v, info = _evd.evd(_matrix(a, "Eigen"))
        return Eigen(v=v, w=w, info=info)

    @property
    def eigenvalues(self):
        return self.w

    @property
    def eigenvectors(self):
        return self.v


@dataclasses.dataclass(frozen=True)
class GeneralizedEigen:
    """Generalized eigendecomposition of a pencil (A, B) as (α, β) pairs:
    A V diag(β) = B V diag(α), α, β and V complex; β = 0 marks an infinite
    eigenvalue (``gevd.gevd``: the real QZ for a real pencil, the complex
    QZ for a complex one)."""

    alpha: torch.Tensor
    beta: torch.Tensor
    v: torch.Tensor
    info: SpectralInfo

    @staticmethod
    def new(a, b) -> "GeneralizedEigen":
        from faer_tpu_torch.linalg import gevd as _gevd

        a = _matrix(a, "GeneralizedEigen")
        alpha, beta, v, info = _gevd.gevd(a, _matrix(b, "GeneralizedEigen", a.device))
        return GeneralizedEigen(alpha=alpha, beta=beta, v=v, info=info)

    @property
    def eigenvalues(self):
        return self.alpha / self.beta


SOLVERS: dict[str, Any] = {cls.__name__: cls for cls in
                           (Llt, Ldlt, PivLlt, Lblt, PartialPivLu, FullPivLu, Qr,
                            ColPivQr, Svd, SelfAdjointEigen, Eigen, GeneralizedEigen)}
