"""faer_tpu_torch — the PyTorch and CUDA port of ``faer_tpu``.

Module names mirror ``faer_tpu`` so that each counterpart is easy to find.
The package imports ``torch`` and numpy only; its CUDA kernels
(``faer_tpu_torch/csrc``) are compiled and loaded at their first launch on a
CUDA tensor, so importing it works on a machine without a GPU.

The ported slices: the LLT and partial-pivot LU factor-and-solve path,
``linalg.cholesky`` (``llt_factor``, ``llt_solve``) and ``linalg.lu``
(``lu_in_place``, ``lu_solve``), chained by ``entry.flagship_step``; the
Householder QR path, ``linalg.qr`` (``qr_in_place``, then
``qr_solve_lstsq`` and its siblings); the rest of the dense stack, LDLT,
pivoted LLT, Bunch–Kaufman LBLT, the LLT and LDLT rank updates
(``linalg.cholesky``), full-pivot LU (``linalg.lu``) and column-pivoted QR
(``linalg.qr``); all of them for every float32 and float64 shape (float32
through the hand-written kernels, float64 through the JAX package's
non-kernel bodies); the self-adjoint EVD and the SVD, ``linalg.evd``
(``self_adjoint_evd`` and its siblings) and ``linalg.svd`` (``svd`` and its
siblings), in float32 and float64; the general real EVD, ``linalg.evd``
(``evd``, ``eigenvalues``, their ``_pair`` forms, ``hessenberg_in_place``,
``hessenberg_blocked``), ``linalg.real_schur`` (``real_schur``, one launch
of the ``real_schur`` kernel on a card), ``linalg.schur_multishift``
(``multishift_real_schur``) and ``linalg.eigvec``, in float32 and float64;
the general complex EVD through the same ``evd`` and ``eigenvalues``,
``linalg.complex_schur`` (``complex_schur``, one launch of the
``complex_schur`` kernel on a card, also ``evd.complex_schur``),
``multishift_complex_schur`` and ``eigvec.triangular_eigenvectors``, in
complex64 and complex128;
the generalized real EVD, ``linalg.gevd`` (``gevd``, ``gevd_eigenvalues``,
``gevd_self_adjoint``), ``linalg.qz`` (``hessenberg_triangular``, one
launch of the ``hess_tri`` kernel on a card; ``qz``, ``gevd_qz``) and
``linalg.qz_real`` (``real_qz``, one launch of the ``real_qz`` kernel on a
card; ``qz_eigenvalues_pair``), in float32 and float64; the generalized
complex EVD through the same ``gevd`` and ``qz``, ``linalg.complex_qz``
(``qz_iteration``, one launch of the ``complex_qz`` kernel on a card, also
``qz.qz_iteration``; the Givens chain of ``hessenberg_triangular`` one
launch of ``complex_hess_tri``), ``linalg.qz_multishift``
(``multishift_qz``) and ``eigvec.triangular_generalized_eigenvectors``, in
complex64 and complex128; and the facade
over them: ``Mat``, ``Col``, ``Row``, ``Diag``, ``Scale``
and the solver objects ``Llt``, ``Ldlt``, ``PivLlt``, ``Lblt``,
``PartialPivLu``, ``FullPivLu``, ``Qr``, ``ColPivQr``, ``Svd``,
``SelfAdjointEigen``, ``Eigen``, ``GeneralizedEigen``, whose products go
through the GEMM front door (``ops.matmul``) and, with the switch
``core.config.config.use_tile_matmul`` on, its tile kernel; and
``linalg.batched``, ``ops.jacobi``, ``ops.zip``. complex64 and complex128
run through every factorization, solver object, the self-adjoint EVD, the
SVD, the general EVD and the generalized EVD (``core/dtypes.py`` says
which route each takes).
"""
from faer_tpu_torch.core import dtypes, params, perm
from faer_tpu_torch.core.config import (
    config,
    get_global_parallelism,
    set_global_parallelism,
)
from faer_tpu_torch.core.errors import (
    FaerError,
    LbltInfo,
    LdltInfo,
    LltInfo,
    LuInfo,
    NoConvergenceError,
    NonPositivePivotError,
    ShapeError,
    SingularMatrixError,
    SpectralInfo,
)
from faer_tpu_torch.core.flags import (
    Accum,
    BlockStructure,
    Conj,
    NanHandling,
    Norm,
    Par,
    Side,
)
from faer_tpu_torch.core.mat import Mat, Scale
from faer_tpu_torch.core.params import EvdParams, GevdParams, QrParams, SvdParams
from faer_tpu_torch.core.vec import Col, Diag, Row
from faer_tpu_torch.linalg.cholesky import (
    lblt_factor,
    lblt_reconstruct,
    lblt_solve,
    ldlt_factor,
    ldlt_rank_r_update,
    ldlt_reconstruct,
    ldlt_solve,
    llt_factor,
    llt_inverse,
    llt_rank_r_update,
    llt_reconstruct,
    llt_solve,
    piv_llt_factor,
    piv_llt_reconstruct,
    piv_llt_solve,
)
from faer_tpu_torch.linalg.evd import (
    eigenvalues,
    eigenvalues_pair,
    evd,
    evd_pair,
    hessenberg_blocked,
    hessenberg_in_place,
    self_adjoint_eigenvalues,
    self_adjoint_evd,
    self_adjoint_pseudoinverse,
)
from faer_tpu_torch.linalg.lu import (
    full_piv_lu_in_place,
    full_piv_lu_reconstruct,
    full_piv_lu_solve,
    lu_determinant,
    lu_in_place,
    lu_inverse,
    lu_reconstruct,
    lu_solve,
    lu_solve_transpose,
)
from faer_tpu_torch.linalg.qr import (
    col_piv_qr_in_place,
    col_piv_qr_reconstruct,
    col_piv_qr_solve_lstsq,
    qr_apply_q,
    qr_compute_q,
    qr_in_place,
    qr_inverse,
    qr_reconstruct,
    qr_solve,
    qr_solve_lstsq,
)
from faer_tpu_torch.linalg.solvers import (
    ColPivQr,
    Eigen,
    FullPivLu,
    GeneralizedEigen,
    Lblt,
    Ldlt,
    Llt,
    PartialPivLu,
    PivLlt,
    Qr,
    SelfAdjointEigen,
    Svd,
)
from faer_tpu_torch.linalg.gevd import gevd, gevd_eigenvalues, gevd_self_adjoint
from faer_tpu_torch.linalg.qz import gevd_qz, hessenberg_triangular, qz
from faer_tpu_torch.linalg.complex_qz import qz_iteration
from faer_tpu_torch.linalg.qz_multishift import multishift_qz
from faer_tpu_torch.linalg.qz_real import qz_eigenvalues_pair, real_qz
from faer_tpu_torch.linalg.complex_schur import complex_schur
from faer_tpu_torch.linalg.eigvec import (
    triangular_eigenvectors,
    triangular_generalized_eigenvectors,
)
from faer_tpu_torch.linalg.real_schur import real_schur
from faer_tpu_torch.linalg.schur_multishift import (
    multishift_complex_schur,
    multishift_real_schur,
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
    "LltInfo", "LdltInfo", "LbltInfo", "LuInfo", "FaerError",
    "NonPositivePivotError", "NoConvergenceError", "SingularMatrixError",
    "ShapeError", "config", "set_global_parallelism", "get_global_parallelism",
    "dtypes", "params", "perm",
    "Accum", "BlockStructure", "Conj", "NanHandling", "Norm", "Par", "Side",
    "Mat", "Scale", "Col", "Row", "Diag",
    "Llt", "Ldlt", "PivLlt", "Lblt", "PartialPivLu", "FullPivLu", "Qr",
    "ColPivQr", "Svd", "SelfAdjointEigen", "Eigen", "GeneralizedEigen",
    "matmul", "matvec", "rank_update",
    "norm", "norm_l1", "norm_l2", "norm_l2_sqr", "norm_max", "sum_all",
    "prod_diag", "log_abs_det_diag",
    "llt_factor", "llt_solve", "llt_reconstruct", "llt_inverse",
    "llt_rank_r_update", "ldlt_factor", "ldlt_solve", "ldlt_reconstruct",
    "ldlt_rank_r_update", "piv_llt_factor", "piv_llt_solve",
    "piv_llt_reconstruct", "lblt_factor", "lblt_solve", "lblt_reconstruct",
    "full_piv_lu_in_place", "full_piv_lu_solve", "full_piv_lu_reconstruct",
    "col_piv_qr_in_place", "col_piv_qr_solve_lstsq", "col_piv_qr_reconstruct",
    "lu_in_place", "lu_solve", "lu_solve_transpose", "lu_inverse",
    "lu_reconstruct", "lu_determinant",
    "QrParams", "qr_in_place", "qr_solve_lstsq", "qr_solve", "qr_reconstruct",
    "qr_compute_q", "qr_apply_q", "qr_inverse",
    "SpectralInfo", "EvdParams", "SvdParams",
    "self_adjoint_evd", "self_adjoint_eigenvalues", "self_adjoint_pseudoinverse",
    "svd", "singular_values", "pseudoinverse", "pseudoinverse_from_svd",
    "evd", "eigenvalues", "evd_pair", "eigenvalues_pair", "hessenberg_in_place",
    "hessenberg_blocked", "real_schur", "multishift_real_schur", "complex_schur",
    "multishift_complex_schur", "triangular_eigenvectors", "qz_iteration", "multishift_qz",
    "triangular_generalized_eigenvectors",
    "GevdParams", "gevd", "gevd_eigenvalues", "gevd_self_adjoint", "gevd_qz", "qz",
    "real_qz", "qz_eigenvalues_pair", "hessenberg_triangular",
]
