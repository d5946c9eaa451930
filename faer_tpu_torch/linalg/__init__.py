"""The dense decompositions and the solver objects (counterpart of
``faer_tpu/linalg``): the Cholesky family, LU, QR, the SVD, the
self-adjoint and general EVD, the generalized EVD (``gevd``, ``qz``,
``qz_real``, ``complex_qz``, ``qz_multishift``), ``batched`` and
``solvers``."""

__all__ = [
    "cholesky", "lu", "qr", "solvers", "svd", "evd", "gevd", "qz", "qz_real", "batched",
    "bidiag", "bidiag_svd", "bidiag_dnc", "tridiag", "tridiag_evd", "tridiag_dnc",
    "real_schur", "complex_schur", "schur_multishift", "eigvec", "complex_qz",
    "qz_multishift",
]
