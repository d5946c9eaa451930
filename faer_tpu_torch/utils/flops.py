"""FLOP counts (counterpart of ``faer_tpu/utils/flops.py``): the standard
operation-count table that converts device times into GFLOP/s."""
from __future__ import annotations


def matmul_flops(m: int, n: int, k: int, complex_: bool = False) -> float:
    f = 2.0 * m * n * k
    return 4.0 * f if complex_ else f


def llt_flops(n: int) -> float:
    return n**3 / 3.0


def lu_flops(m: int, n: int) -> float:
    if m >= n:
        return m * n * n - n**3 / 3.0
    return n * m * m - m**3 / 3.0


def qr_flops(m: int, n: int) -> float:
    """Householder QR (factor only)."""
    if m >= n:
        return 2.0 * n * n * (m - n / 3.0)
    return 2.0 * m * m * (n - m / 3.0)


def svd_flops(m: int, n: int, vectors: bool = True) -> float:
    """Rough Golub-Kahan cost model."""
    mn, mx = min(m, n), max(m, n)
    base = 4.0 * mx * mn * mn - 4.0 * mn**3 / 3.0  # bidiagonalization
    return base * (2.5 if vectors else 1.2)


def evd_flops(n: int, vectors: bool = True) -> float:
    return (10.0 if vectors else 4.0) * n**3


def trsm_flops(n: int, k: int) -> float:
    return float(n) * n * k
