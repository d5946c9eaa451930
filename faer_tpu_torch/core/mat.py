"""``Mat`` — the user-facing matrix facade (counterpart of
``faer_tpu/core/mat.py``).

faer's ``Mat/MatRef/MatMut`` (``faer/src/mat/mod.rs:83-167``) and the
operator impls of ``faer/src/linalg/mat_ops.rs``, as one facade over a
``torch.Tensor``. Operators return new ``Mat`` objects and ``at_set`` a new
``Mat`` (the tensor is never changed in place), as in the JAX package.
``@`` goes through the GEMM front door (``ops/matmul.py``), so with the tile
GEMM switch on a large f32 product takes the hand-written kernel. The
linalg methods build the solver objects of ``linalg/solvers.py``
(faer ``solvers.rs:346-634``).

Device: ``Mat(tensor)`` keeps the tensor's device; ``Mat(array_like)`` and
the constructors put the data on ``"cuda"`` unless the caller passes
``device="cpu"``. Methods whose decomposition the port does not have yet
raise ``NotImplementedError`` naming its ROADMAP item.
"""
from __future__ import annotations

import numpy as np
import torch

from faer_tpu_torch.core import dtypes
from faer_tpu_torch.core.flags import Side

DEFAULT_DEVICE = "cuda"
_DTYPES = (torch.float32, torch.float64, torch.complex64, torch.complex128,
           torch.bfloat16)


def as_tensor(a, name: str, *, device=None):
    """A tensor of ``a``: a tensor keeps its device (unless ``device`` is
    given); other array-likes go to ``device`` (default ``"cuda"``).
    Integer and bool data become float32; other dtypes raise ``TypeError``."""
    if isinstance(a, torch.Tensor):
        x = a if device is None else a.to(device)
    else:
        x = torch.as_tensor(np.asarray(a), device=device or DEFAULT_DEVICE)
    if x.dtype not in _DTYPES:
        if x.dtype == torch.bool or not (x.is_floating_point() or x.is_complex()):
            x = x.to(torch.float32)
        else:
            raise TypeError(f"{name}: unsupported dtype {x.dtype}")
    return x.resolve_conj()  # a conjugate view (``Mat.H``) as plain data


class Mat:
    """Dense matrix facade over a tensor of rank ≥ 2."""

    __slots__ = ("a",)
    __array_priority__ = 100  # win against a raw ndarray in mixed operators

    def __init__(self, a, *, device=None):
        self.a = as_tensor(a.a if isinstance(a, Mat) else a, "Mat", device=device)

    # -- constructors (faer Mat::zeros/identity/from_fn) --------------------
    @staticmethod
    def zeros(nrows: int, ncols: int, dtype=torch.float32,
              device=DEFAULT_DEVICE) -> "Mat":
        return Mat(torch.zeros((nrows, ncols), dtype=dtype, device=device))

    @staticmethod
    def ones(nrows: int, ncols: int, dtype=torch.float32,
             device=DEFAULT_DEVICE) -> "Mat":
        return Mat(torch.ones((nrows, ncols), dtype=dtype, device=device))

    @staticmethod
    def identity(nrows: int, ncols: int, dtype=torch.float32,
                 device=DEFAULT_DEVICE) -> "Mat":
        return Mat(torch.eye(nrows, ncols, dtype=dtype, device=device))

    @staticmethod
    def full(nrows: int, ncols: int, value, dtype=torch.float32,
             device=DEFAULT_DEVICE) -> "Mat":
        return Mat(torch.full((nrows, ncols), value, dtype=dtype, device=device))

    @staticmethod
    def from_fn(nrows: int, ncols: int, f, dtype=torch.float32,
                device=DEFAULT_DEVICE) -> "Mat":
        ii = torch.arange(nrows, device=device)[:, None]
        jj = torch.arange(ncols, device=device)[None, :]
        return Mat(torch.as_tensor(f(ii, jj), dtype=dtype, device=device))

    # -- basic properties ----------------------------------------------------
    @property
    def shape(self):
        return tuple(self.a.shape)

    @property
    def nrows(self) -> int:
        return self.a.shape[-2]

    @property
    def ncols(self) -> int:
        return self.a.shape[-1]

    @property
    def dtype(self):
        return self.a.dtype

    @property
    def device(self):
        return self.a.device

    @property
    def T(self) -> "Mat":
        return Mat(self.a.mT)

    transpose = T

    @property
    def H(self) -> "Mat":
        return Mat(self.a.mH)

    adjoint = H

    def conjugate(self) -> "Mat":
        return Mat(self.a.conj())

    def __array__(self, dtype=None, copy=None):
        return np.asarray(self.a.detach().cpu().resolve_conj(), dtype=dtype)

    def __repr__(self):
        return f"Mat({self.a!r})"

    def __getitem__(self, idx) -> "Mat | torch.Tensor":
        out = self.a[idx]
        return Mat(out) if out.dim() >= 2 else out

    def at_set(self, idx, value) -> "Mat":
        """A new ``Mat`` with ``idx`` set to ``value`` (faer's MatMut writes)."""
        out = self.a.clone()
        out[idx] = value.a if isinstance(value, Mat) else value
        return Mat(out)

    def astype(self, dtype) -> "Mat":
        return Mat(self.a.to(dtype))

    # -- operators (mat_ops.rs parity) ---------------------------------------
    @staticmethod
    def _coerce(x):
        return x.a if isinstance(x, Mat) else x

    def __add__(self, o):
        return Mat(self.a + self._coerce(o))

    __radd__ = __add__

    def __sub__(self, o):
        return Mat(self.a - self._coerce(o))

    def __rsub__(self, o):
        return Mat(self._coerce(o) - self.a)

    def __neg__(self):
        return Mat(-self.a)

    def __mul__(self, o):
        return Mat(self.a * self._coerce(o))

    __rmul__ = __mul__

    def __truediv__(self, o):
        return Mat(self.a / self._coerce(o))

    def __matmul__(self, o):
        from faer_tpu_torch.ops.matmul import matmul, matvec

        other = self._coerce(o)
        if not isinstance(other, torch.Tensor):
            return NotImplemented  # e.g. a Diag on the right
        if other.dim() == 1:
            return matvec(self.a, other)
        return Mat(matmul(None, self.a, other))

    def __rmatmul__(self, o):
        from faer_tpu_torch.ops.matmul import matmul

        other = self._coerce(o)
        if not isinstance(other, torch.Tensor):
            return NotImplemented
        return Mat(matmul(None, other, self.a))

    def __eq__(self, o):  # structural equality on values
        return (isinstance(o, Mat) and self.a.shape == o.a.shape
                and bool((self.a == o.a).all()))

    def __hash__(self):
        return id(self)

    # -- reductions / norms ---------------------------------------------------
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

    def trace(self):
        return torch.diagonal(self.a, dim1=-2, dim2=-1).sum(-1)

    # -- decomposition methods (solvers.rs:346-634) ---------------------------
    def llt(self, side: Side = Side.LOWER):
        from faer_tpu_torch.linalg import solvers

        return solvers.Llt.new(self.a, side)

    def ldlt(self, side: Side = Side.LOWER):
        from faer_tpu_torch.linalg import solvers

        return solvers.Ldlt.new(self.a, side)

    def piv_llt(self, side: Side = Side.LOWER):
        from faer_tpu_torch.linalg import solvers

        return solvers.PivLlt.new(self.a, side)

    def lblt(self, side: Side = Side.LOWER):
        from faer_tpu_torch.linalg import solvers

        return solvers.Lblt.new(self.a, side)

    def partial_piv_lu(self):
        from faer_tpu_torch.linalg import solvers

        return solvers.PartialPivLu.new(self.a)

    def full_piv_lu(self):
        from faer_tpu_torch.linalg import solvers

        return solvers.FullPivLu.new(self.a)

    def qr(self):
        from faer_tpu_torch.linalg import solvers

        return solvers.Qr.new(self.a)

    def col_piv_qr(self):
        from faer_tpu_torch.linalg import solvers

        return solvers.ColPivQr.new(self.a)

    def svd(self):
        from faer_tpu_torch.linalg import solvers

        return solvers.Svd.new(self.a)

    def thin_svd(self):
        from faer_tpu_torch.linalg import solvers

        return solvers.Svd.new(self.a, thin=True)

    def self_adjoint_eigen(self, side: Side = Side.LOWER):
        from faer_tpu_torch.linalg import solvers

        return solvers.SelfAdjointEigen.new(self.a, side)

    def eigen(self):
        from faer_tpu_torch.linalg import solvers

        return solvers.Eigen.new(self.a)

    def generalized_eigen(self, b):
        from faer_tpu_torch.linalg import solvers

        return solvers.GeneralizedEigen.new(self.a, b)

    def singular_values(self):
        from faer_tpu_torch.linalg import svd as _svd

        return _svd.singular_values(self.a)

    def eigenvalues(self):
        from faer_tpu_torch.linalg import evd as _evd

        return _evd.eigenvalues(self.a)

    def self_adjoint_eigenvalues(self, side: Side = Side.LOWER):
        from faer_tpu_torch.linalg import evd as _evd

        return _evd.self_adjoint_eigenvalues(self.a, side)

    def determinant(self):
        from faer_tpu_torch.linalg import solvers

        return solvers.PartialPivLu.new(self.a).determinant()

    def inverse(self):
        from faer_tpu_torch.linalg import solvers

        return Mat(solvers.PartialPivLu.new(self.a).inverse())

    def solve(self, rhs):
        """Square solve via partial-pivot LU (faer ``DenseSolve``)."""
        from faer_tpu_torch.linalg import solvers

        return solvers.PartialPivLu.new(self.a).solve(rhs)

    def solve_lstsq(self, rhs):
        from faer_tpu_torch.linalg import solvers

        return solvers.Qr.new(self.a).solve_lstsq(rhs)

    def rank(self, tol=None):
        from faer_tpu_torch.linalg import svd as _svd

        s = _svd.singular_values(self.a)
        if tol is None:
            tol = s.max() * max(self.shape) * dtypes.eps(self.dtype)
        return (s > tol).sum()


class Scale:
    """faer ``Scale`` (``lib.rs:1092``): an explicit scalar for ``*``."""

    __slots__ = ("value",)

    def __init__(self, value):
        self.value = value

    def __mul__(self, other):
        if isinstance(other, Mat):
            return Mat(other.a * self.value)
        if isinstance(other, Scale):
            return Scale(self.value * other.value)
        return other * self.value

    __rmul__ = __mul__
