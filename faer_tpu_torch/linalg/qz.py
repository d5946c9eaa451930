"""The generalized Schur (QZ) decomposition of a pencil (A, B)
(counterpart of ``faer_tpu/linalg/qz.py``).

faer ``generalized_hessenberg`` (``gen_hessenberg/mod.rs:223``), then
``hessenberg_to_qz``: the real double-shift QZ (``qz_real/mod.rs:1508``,
:mod:`.qz_real`) for a real pencil, the complex QZ (``qz_cplx/mod.rs:1140``,
:mod:`.complex_qz` and :mod:`.qz_multishift`) for a complex one.

:func:`hessenberg_triangular` reduces (A, B) to (H, R), H upper
Hessenberg and R upper triangular, with A = Q H Zᴴ and B = Q R Zᴴ: the QR
of B (``qr_in_place``, ``qr_compute_q``) gives A ← Q₀ᴴA and R, then a
chain of Givens pairs clears H below its subdiagonal column by column,
bottom up. Each pair is a rotation of rows (i, i + 1) that zeroes
H[i + 1, j] (on H, R and Q's columns), which leaves a bulge at R[i + 1, i],
and a rotation of columns (i, i + 1) that zeroes it (on R, H and Z). The
port writes the zeros it makes, so H is exactly Hessenberg and R exactly
triangular with no masking pass.

:func:`hessenberg_triangular_plain` runs the chain of a real pencil in
plain PyTorch and is the twin of the ``hess_tri`` CUDA kernel
(``ops/kernels/hess_tri.py``), as ``complex_qz.hessenberg_triangular_plain``
is of ``complex_hess_tri`` (``ops/kernels/complex_qz.py``) for a complex
one; each kernel runs the whole chain of one problem in one CTA: the scalar
arithmetic of each pair (its two rotations) runs on numpy scalars of the
element type, one IEEE rounding an operation, and the row and column
updates are PyTorch operations, so the two agree to the bit. Each rotation
comes from the pair (x, z) scaled by its larger magnitude (c = |x|/r,
s = sign(x)·z/r, r the norm of the scaled pair): PyTorch keeps the float32
subnormals that XLA flushes, and the unscaled squares of the JAX
package's ``_cgivens`` underflow there.

A complex pencil's generalized Schur form (:func:`qz`) is triangular: the
complex QZ runs directly below ``_MULTISHIFT_MIN_N`` (one ``complex_qz``
launch) and as multishift QZ with AED from it on, as the JAX package's
``qz_cpair.qz_pair`` dispatches (faer's own dispatch); :func:`gevd_qz`
then solves the triangular pencil's eigenvectors
(``eigvec.triangular_generalized_eigenvectors``).
"""
from __future__ import annotations

import numpy as np
import torch

from faer_tpu_torch.core import dtypes
from faer_tpu_torch.core.config import check_f32_policy
from faer_tpu_torch.core.errors import ShapeError
from faer_tpu_torch.linalg.complex_qz import qz_iteration
from faer_tpu_torch.ops.matmul import matmul


#: route n ≥ this through multishift QZ with AED (``qz_cpair._MULTISHIFT_MIN_N``)
_MULTISHIFT_MIN_N = 128


def _pencil(a, b, name: str):
    """``(a, b)`` once checked: a square pencil of one field dtype
    (float32, float64, complex64, complex128) on one device; a complex
    ``a`` takes a real ``b`` of its precision to its own dtype (as the JAX
    package casts a complex pencil's halves). Raises otherwise."""
    if a.dim() != 2 or a.shape[0] != a.shape[1] or b.shape != a.shape:
        raise ShapeError(f"{name}: needs two square matrices of one shape, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    dtypes.require_field(a, name)
    dtypes.require_field(b, name)
    if a.is_complex() and b.dtype == dtypes.real_dtype_of(a.dtype):
        b = b.to(a.dtype)
    if a.dtype != b.dtype or a.device != b.device:
        raise TypeError(f"{name}: a and b must share dtype and device, got "
                        f"{a.dtype} on {a.device} and {b.dtype} on {b.device}")
    if a.is_cuda:
        check_f32_policy()
    return a, b


def _rotation(x, z):
    """The real form of the JAX package's ``_cgivens``: numpy scalars
    (c, s) with c = |x|/r and s = sign(x)·z/r (sign(0) = 1), so that
    [[c, s], [−s, c]] (x, z)ᵀ = (±r, 0)ᵀ; (1, 0) when z = 0. From the pair
    scaled by its larger magnitude."""
    sc = type(x)
    if z == 0:
        return sc(1), sc(0)
    m = max(abs(x), abs(z))
    xs, zs = x / m, z / m
    r = np.sqrt(xs * xs + zs * zs)
    return abs(xs) / r, (zs if xs >= 0 else -zs) / r


def _rotate_rows(m, i: int, c0: int, c, s) -> None:
    """Rows (i, i + 1) of ``m`` from column ``c0`` on: (c·r_i + s·r_{i+1},
    −s·r_i + c·r_{i+1}). In place."""
    r0, r1 = m[i, c0:].clone(), m[i + 1, c0:].clone()
    m[i, c0:] = c * r0 + s * r1
    m[i + 1, c0:] = -s * r0 + c * r1


def _rotate_cols(m, i: int, rend: int, c, s) -> None:
    """Columns (i, i + 1) of ``m``'s rows 0..rend − 1: (c·c_i + s·c_{i+1},
    −s·c_i + c·c_{i+1}). In place."""
    c0, c1 = m[:rend, i].clone(), m[:rend, i + 1].clone()
    m[:rend, i] = c * c0 + s * c1
    m[:rend, i + 1] = -s * c0 + c * c1


def hessenberg_triangular_plain(h, r, q, z):
    """The Givens chain of :func:`hessenberg_triangular` on one problem in
    plain PyTorch: ``(h, r, q, z)`` new tensors, from an (n, n) ``h``, an
    upper-triangular ``r`` and the ``q`` and ``z`` whose columns absorb the
    left and right rotations. The CPU route of ``hess_tri_batched`` and the
    kernel's twin (module docstring); a complex pencil's twin is
    ``complex_qz.hessenberg_triangular_plain``."""
    h, r, q, z = h.clone(), r.clone(), q.clone(), z.clone()
    n = h.shape[0]
    sc = np.float32 if h.dtype == torch.float32 else np.float64
    for j in range(n - 2):
        for i in range(n - 2, j, -1):
            x0, x1 = (sc(v) for v in h[i:i + 2, j].tolist())
            c, s = (float(v) for v in _rotation(x0, x1))
            # rows (i, i + 1): H from column j, R from column i; Q's columns
            _rotate_rows(h, i, j, c, s)
            h[i + 1, j] = 0.0
            _rotate_rows(r, i, i, c, s)
            _rotate_cols(q, i, n, c, s)
            # columns (i + 1, i) clear R's bulge R[i + 1, i] against
            # R[i + 1, i + 1]: (c₂·c_{i+1} + s₂·c_i, −s₂·c_{i+1} + c₂·c_i)
            y1, y0 = (sc(v) for v in r[i + 1, i:i + 2].tolist())
            c2, s2 = (float(v) for v in _rotation(y0, y1))
            for m, rend in ((r, i + 2), (h, n), (z, n)):
                a0, a1 = m[:rend, i].clone(), m[:rend, i + 1].clone()
                m[:rend, i + 1] = c2 * a1 + s2 * a0
                m[:rend, i] = -s2 * a1 + c2 * a0
            r[i + 1, i] = 0.0
    return h, r, q, z


def hessenberg_triangular(a, b):
    """Reduce the pencil (A, B) to (H, R), H upper Hessenberg and R upper
    triangular: ``(h, r, q, z)`` with A = Q H Zᴴ and B = Q R Zᴴ, Q and Z
    orthogonal or unitary (faer ``generalized_hessenberg``,
    ``gen_hessenberg/mod.rs:223``). The QR of B through ``qr_in_place``
    (the ``qr_panel`` and ``trtri`` kernels in float32), then the Givens
    chain: on a CUDA tensor one launch of the ``hess_tri`` kernel (real)
    or of ``complex_hess_tri`` (complex), on a CPU tensor the kernel's
    plain twin."""
    from faer_tpu_torch.linalg.qr import qr_compute_q, qr_in_place
    from faer_tpu_torch.ops.kernels.complex_qz import complex_hess_tri_batched
    from faer_tpu_torch.ops.kernels.hess_tri import hess_tri_batched

    a, b = _pencil(a, b, "hessenberg_triangular")
    n = a.shape[0]
    packed, ts, block = qr_in_place(b)
    q0 = qr_compute_q(packed, ts, block, thin=False)
    r = torch.triu(packed)
    h = matmul(None, q0.mH, a)
    z = torch.eye(n, dtype=a.dtype, device=a.device)
    if n <= 2:
        return h, r, q0, z
    sizes = torch.full((1,), n, dtype=torch.int32, device=a.device)
    chain = complex_hess_tri_batched if a.is_complex() else hess_tri_batched
    h, r, q, z = chain(h[None], r[None], q0[None], z[None], sizes)
    return h[0], r[0], q[0], z[0]


def _complex_qz(a, b, *, max_sweeps_factor: int):
    """The complex generalized Schur form (module docstring): ``(s, t, q,
    z, info)``."""
    from faer_tpu_torch.linalg.qz_multishift import multishift_qz
    from faer_tpu_torch.linalg.schur_multishift import _params_for

    h, r, q, z = hessenberg_triangular(a, b)
    n = a.shape[0]
    if n >= _MULTISHIFT_MIN_N:
        # the budget in shifts a row on both routes: max_sweeps_factor · n
        # single-shift sweeps here, max_sweeps_factor · (n / ns + 2) rounds
        # of ns shifts there (each AED window keeps its own budget)
        ns, _ = _params_for(n)
        return multishift_qz(h, r, q, z, max_rounds=max_sweeps_factor * (n // ns + 2))
    return qz_iteration(h, r, q, z, max_sweeps_factor=max_sweeps_factor)


def qz(a, b, *, max_sweeps_factor: int = 30):
    """The generalized Schur form of the pencil (A, B): ``(s, t, q, z,
    info)`` with A = Q S Zᴴ and B = Q T Zᴴ. A real pencil runs the real QZ
    (:func:`.qz_real.real_qz`): S quasi-triangular, T upper triangular, all
    real. A complex one (a real B promoted to A's dtype) runs the complex
    QZ: S and T upper triangular, one ``complex_hess_tri`` launch, then one
    ``complex_qz`` launch below n = 128 and multishift QZ with AED (one
    launch an AED window) from it on. ``max_sweeps_factor`` bounds the
    iteration: max_sweeps_factor · n sweeps of the single-shift QZ, or
    max_sweeps_factor · (n / ns + 2) multishift rounds of ns shifts each
    (0: none, and ``info.converged`` false for n ≥ 2)."""
    from faer_tpu_torch.linalg.qz_real import real_qz

    a, b = _pencil(a, b, "qz")
    if a.is_complex():
        return _complex_qz(a, b, max_sweeps_factor=max_sweeps_factor)
    return real_qz(a, b, max_sweeps_factor=max_sweeps_factor)


def gevd_qz(a, b):
    """The generalized eigendecomposition of the pencil through QZ:
    ``(alpha, beta, v, info)``, complex, with A v_k β_k = B v_k α_k column
    by column. A real pencil: the real QZ, the (α, β) of its 1×1 and 2×2
    blocks, the pencil's quasi-triangular eigenvectors, back-transformed
    by Z, each of unit norm in (S, T)'s coordinates (faer ``gevd_real``,
    ``gevd/mod.rs:1295``). A complex one: the complex QZ, α = diag(S),
    β = diag(T), the triangular pencil's eigenvectors back-transformed by Z
    and each column of unit norm (``gevd_cplx``, ``:1329``;
    ``qz_cpair.gevd_qz_pair``)."""
    from faer_tpu_torch.linalg.eigvec import (
        quasi_triangular_generalized_eigenvectors_pair,
        triangular_generalized_eigenvectors,
    )
    from faer_tpu_torch.linalg.qz_real import qz_eigenvalues_pair, real_qz

    a, b = _pencil(a, b, "gevd_qz")
    if a.is_complex():
        s, t, _, z, info = _complex_qz(a, b, max_sweeps_factor=30)
        alpha, beta = s.diagonal().clone(), t.diagonal().clone()
        v = matmul(None, z, triangular_generalized_eigenvectors(s, t, alpha, beta))
        norms = torch.linalg.vector_norm(v, dim=0)
        return alpha, beta, v / torch.where(norms == 0, 1.0, norms)[None, :], info
    s, t, _, z, info = real_qz(a, b)
    ar, ai, be = qz_eigenvalues_pair(s, t)
    yr, yi = quasi_triangular_generalized_eigenvectors_pair(s, t, ar, ai, be)
    return (torch.complex(ar, ai), torch.complex(be, torch.zeros_like(be)),
            torch.complex(matmul(None, z, yr), matmul(None, z, yi)), info)
