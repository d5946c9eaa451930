"""faer_tpu_torch — the PyTorch and CUDA port of ``faer_tpu``.

Module names mirror ``faer_tpu`` so that each counterpart is easy to find.
The package imports ``torch`` and numpy only; its CUDA kernels
(``faer_tpu_torch/csrc``) are compiled and loaded at their first launch on a
CUDA tensor, so importing it works on a machine without a GPU.

The ported slices: the LLT and partial-pivot LU factor-and-solve path,
``linalg.cholesky`` (``llt_factor``, ``llt_solve``) and ``linalg.lu``
(``lu_in_place``, ``lu_solve``), chained by ``entry.flagship_step``, for
every float32 shape; the Householder QR path, ``linalg.qr``
(``qr_in_place``, then ``qr_solve_lstsq`` and its siblings); and the
self-adjoint EVD and the SVD, ``linalg.evd`` (``self_adjoint_evd`` and its
siblings) and ``linalg.svd`` (``svd`` and its siblings).
"""
from faer_tpu_torch.core.errors import (
    LltInfo,
    LuInfo,
    NonPositivePivotError,
    ShapeError,
    SpectralInfo,
)
from faer_tpu_torch.core.params import EvdParams, QrParams, SvdParams
from faer_tpu_torch.linalg.cholesky import llt_factor, llt_reconstruct, llt_solve
from faer_tpu_torch.linalg.evd import (
    self_adjoint_eigenvalues,
    self_adjoint_evd,
    self_adjoint_pseudoinverse,
)
from faer_tpu_torch.linalg.lu import (
    lu_determinant,
    lu_in_place,
    lu_reconstruct,
    lu_solve,
)
from faer_tpu_torch.linalg.qr import (
    qr_apply_q,
    qr_compute_q,
    qr_in_place,
    qr_inverse,
    qr_reconstruct,
    qr_solve,
    qr_solve_lstsq,
)
from faer_tpu_torch.linalg.svd import (
    pseudoinverse,
    pseudoinverse_from_svd,
    singular_values,
    svd,
)

__all__ = [
    "LltInfo", "LuInfo", "NonPositivePivotError", "ShapeError",
    "llt_factor", "llt_solve", "llt_reconstruct",
    "lu_in_place", "lu_solve", "lu_reconstruct", "lu_determinant",
    "QrParams", "qr_in_place", "qr_solve_lstsq", "qr_solve", "qr_reconstruct",
    "qr_compute_q", "qr_apply_q", "qr_inverse",
    "SpectralInfo", "EvdParams", "SvdParams",
    "self_adjoint_evd", "self_adjoint_eigenvalues", "self_adjoint_pseudoinverse",
    "svd", "singular_values", "pseudoinverse", "pseudoinverse_from_svd",
]
