"""The generalized eigendecomposition A v = λ B v (counterpart of
``faer_tpu/linalg/gevd.py``).

faer ``gevd_real`` and ``gevd_cplx`` (``gevd/mod.rs:1295,1329``),
eigenvalues as (α, β) pairs, and the self-adjoint-definite variant.
:func:`gevd` runs the QZ (``qz.gevd_qz``: the Hessenberg–triangular
reduction, the double-shift real QZ or the complex QZ, the pencil's
eigenvectors), which takes a singular or ill-conditioned B;
``method="reduction"`` forms C = B⁻¹A by LU and runs the general EVD of C
(β = 1), cheaper where B is well conditioned. :func:`gevd_self_adjoint`
reduces a symmetric (Hermitian) A and a positive-definite B by the
Cholesky factor of B: C = L⁻¹AL⁻ᴴ, C y = w y, v = L⁻ᴴy.

float32, float64, complex64 and complex128; a complex A takes a real B of
its precision to its own dtype.
"""
from __future__ import annotations

import torch

from faer_tpu_torch.linalg.qz import _pencil


def gevd(a, b, *, method: str = "qz"):
    """The generalized eigendecomposition of the pencil (A, B): ``(alpha,
    beta, v, info)``, complex (complex64 from float32 and complex64,
    complex128 from float64 and complex128), with A v_k β_k = B v_k α_k
    column by column.

    ``method="qz"`` (the default): the generalized Schur form by QZ, robust
    to a singular or ill-conditioned B (infinite eigenvalues have β = 0).
    ``method="reduction"``: C = B⁻¹A by ``lu_in_place``/``lu_solve``, then
    ``evd(C)``, β = 1."""
    a, b = _pencil(a, b, "gevd")
    if method == "qz":
        from faer_tpu_torch.linalg.qz import gevd_qz

        return gevd_qz(a, b)
    if method != "reduction":
        raise ValueError(f"gevd: method must be 'qz' or 'reduction', got {method!r}")
    from faer_tpu_torch.linalg import lu as _lu
    from faer_tpu_torch.linalg.evd import evd

    lu, perm, _ = _lu.lu_in_place(b)
    w, v, info = evd(_lu.lu_solve(lu, perm, a))
    return w, torch.ones_like(w), v, info


def gevd_eigenvalues(a, b):
    """The generalized eigenvalues α/β of the pencil (A, B) (complex; an
    infinite eigenvalue is inf or nan)."""
    alpha, beta, _, _ = gevd(a, b)
    return alpha / beta


def gevd_self_adjoint(a, b):
    """The self-adjoint-definite pencil (A symmetric or Hermitian, stored
    in its lower triangle; B positive definite, its lower triangle read by
    ``llt_factor``): ``(w, v, info)`` with A v = B v diag(w), w real and
    ascending, Vᴴ B V = I. The Cholesky reduction B = L Lᴴ, C = L⁻¹AL⁻ᴴ,
    C y = w y (``self_adjoint_evd``), v = L⁻ᴴy."""
    from faer_tpu_torch.linalg.cholesky import llt_factor
    from faer_tpu_torch.linalg.evd import self_adjoint_evd
    from faer_tpu_torch.ops.triangular_solve import (
        solve_lower_triangular,
        solve_lower_triangular_adjoint,
    )

    a, b = _pencil(a, b, "gevd_self_adjoint")
    l, _ = llt_factor(b)
    full = torch.tril(a) + torch.tril(a, -1).mH
    c = solve_lower_triangular(l, full)
    c = solve_lower_triangular(l, c.mH).mH
    c = 0.5 * (c + c.mH)
    w, y, info = self_adjoint_evd(c)
    return w, solve_lower_triangular_adjoint(l, y), info
