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
siblings) and ``linalg.svd`` (``svd`` and its siblings); and the facade over
them: ``Mat``, ``Col``, ``Row``, ``Diag``, ``Scale`` and the solver objects
``Llt``, ``PartialPivLu``, ``Qr``, ``Svd``, ``SelfAdjointEigen``, whose
products go through the GEMM front door (``ops.matmul``) and, with the
switch ``core.config.config.use_tile_matmul`` on, its tile kernel.
"""
from faer_tpu_torch.core.config import config
from faer_tpu_torch.core.errors import (
    LltInfo,
    LuInfo,
    NonPositivePivotError,
    ShapeError,
    SpectralInfo,
)
from faer_tpu_torch.core.flags import Accum, Conj, Norm, Side
from faer_tpu_torch.core.mat import Mat, Scale
from faer_tpu_torch.core.params import EvdParams, QrParams, SvdParams
from faer_tpu_torch.core.vec import Col, Diag, Row
from faer_tpu_torch.linalg.cholesky import (
    llt_factor,
    llt_inverse,
    llt_reconstruct,
    llt_solve,
)
from faer_tpu_torch.linalg.evd import (
    self_adjoint_eigenvalues,
    self_adjoint_evd,
    self_adjoint_pseudoinverse,
)
from faer_tpu_torch.linalg.lu import (
    lu_determinant,
    lu_in_place,
    lu_inverse,
    lu_reconstruct,
    lu_solve,
    lu_solve_transpose,
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
from faer_tpu_torch.linalg.solvers import (
    Llt,
    PartialPivLu,
    Qr,
    SelfAdjointEigen,
    Svd,
)
from faer_tpu_torch.linalg.svd import (
    pseudoinverse,
    pseudoinverse_from_svd,
    singular_values,
    svd,
)
from faer_tpu_torch.ops.matmul import matmul, matvec, rank_update
from faer_tpu_torch.ops.reductions import (
    log_abs_det_diag,
    norm,
    norm_l1,
    norm_l2,
    norm_l2_sqr,
    norm_max,
    prod_diag,
    sum_all,
)

__all__ = [
    "LltInfo", "LuInfo", "NonPositivePivotError", "ShapeError",
    "config", "Accum", "Conj", "Norm", "Side",
    "Mat", "Scale", "Col", "Row", "Diag",
    "Llt", "PartialPivLu", "Qr", "Svd", "SelfAdjointEigen",
    "matmul", "matvec", "rank_update",
    "norm", "norm_l1", "norm_l2", "norm_l2_sqr", "norm_max", "sum_all",
    "prod_diag", "log_abs_det_diag",
    "llt_factor", "llt_solve", "llt_reconstruct", "llt_inverse",
    "lu_in_place", "lu_solve", "lu_solve_transpose", "lu_inverse",
    "lu_reconstruct", "lu_determinant",
    "QrParams", "qr_in_place", "qr_solve_lstsq", "qr_solve", "qr_reconstruct",
    "qr_compute_q", "qr_apply_q", "qr_inverse",
    "SpectralInfo", "EvdParams", "SvdParams",
    "self_adjoint_evd", "self_adjoint_eigenvalues", "self_adjoint_pseudoinverse",
    "svd", "singular_values", "pseudoinverse", "pseudoinverse_from_svd",
]
