"""The generalized Schur (QZ) decomposition of a real pencil (A, B)
(counterpart of ``faer_tpu/linalg/qz.py``).

faer ``generalized_hessenberg`` (``gen_hessenberg/mod.rs:223``), then
``hessenberg_to_qz`` (``qz_real/mod.rs:1508``, :mod:`.qz_real`).

:func:`hessenberg_triangular` reduces (A, B) to (H, R), H upper
Hessenberg and R upper triangular, with A = Q H Zᵀ and B = Q R Zᵀ: the QR
of B (``qr_in_place``, ``qr_compute_q``) gives A ← Q₀ᵀA and R, then a
chain of Givens pairs clears H below its subdiagonal column by column,
bottom up. Each pair is a rotation of rows (i, i + 1) that zeroes
H[i + 1, j] (on H, R and Q's columns), which leaves a bulge at R[i + 1, i],
and a rotation of columns (i, i + 1) that zeroes it (on R, H and Z). The
port writes the zeros it makes, so H is exactly Hessenberg and R exactly
triangular with no masking pass.

:func:`hessenberg_triangular_plain` runs the chain in plain PyTorch and is
the twin of the ``hess_tri`` CUDA kernel (``ops/kernels/hess_tri.py``),
which runs the whole chain of one problem in one CTA: the scalar
arithmetic of each pair (its two rotations) runs on numpy scalars of the
element type, one IEEE rounding an operation, and the row and column
updates are PyTorch operations, so the two agree to the bit. Each rotation
comes from the pair (x, z) scaled by its larger magnitude (c = |x|/r,
s = sign(x)·z/r, r the norm of the scaled pair): PyTorch keeps the float32
subnormals that XLA flushes, and the unscaled squares of the JAX
package's ``_cgivens`` underflow there.

Complex pencils (the complex QZ, ``qz_cpair``) are ROADMAP §1 item 10b-ii.
"""
from __future__ import annotations

import numpy as np
import torch

from faer_tpu_torch.core import dtypes
from faer_tpu_torch.core.config import check_f32_policy
from faer_tpu_torch.core.errors import ShapeError
from faer_tpu_torch.ops.matmul import matmul


def _pencil(a, b, name: str) -> None:
    """Raise unless (a, b) is a real square pencil of one dtype and device."""
    if a.dim() != 2 or a.shape[0] != a.shape[1] or b.shape != a.shape:
        raise ShapeError(f"{name}: needs two square matrices of one shape, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    dtypes.require_real(a, name)
    dtypes.require_real(b, name)
    if a.dtype != b.dtype or a.device != b.device:
        raise TypeError(f"{name}: a and b must share dtype and device, got "
                        f"{a.dtype} on {a.device} and {b.dtype} on {b.device}")
    if a.is_cuda:
        check_f32_policy()


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
    kernel's twin (module docstring)."""
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
    triangular: ``(h, r, q, z)`` with A = Q H Zᵀ and B = Q R Zᵀ, Q and Z
    orthogonal (faer ``generalized_hessenberg``,
    ``gen_hessenberg/mod.rs:223``). The QR of B through ``qr_in_place``
    (the ``qr_panel`` and ``trtri`` kernels in float32), then the Givens
    chain: on a CUDA tensor one launch of the ``hess_tri`` kernel, on a
    CPU tensor :func:`hessenberg_triangular_plain`."""
    from faer_tpu_torch.linalg.qr import qr_compute_q, qr_in_place
    from faer_tpu_torch.ops.kernels.hess_tri import hess_tri_batched

    _pencil(a, b, "hessenberg_triangular")
    n = a.shape[0]
    packed, ts, block = qr_in_place(b)
    q0 = qr_compute_q(packed, ts, block, thin=False)
    r = torch.triu(packed)
    h = matmul(None, q0.T, a)
    z = torch.eye(n, dtype=a.dtype, device=a.device)
    if n <= 2:
        return h, r, q0, z
    sizes = torch.full((1,), n, dtype=torch.int32, device=a.device)
    h, r, q, z = hess_tri_batched(h[None], r[None], q0[None], z[None], sizes)
    return h[0], r[0], q[0], z[0]


def qz(a, b, *, max_sweeps_factor: int = 30):
    """The generalized Schur form of a real pencil: ``(s, t, q, z, info)``
    with A = Q S Zᵀ and B = Q T Zᵀ, S quasi-triangular and T upper
    triangular (:func:`.qz_real.real_qz`). Complex pencils, whose form is
    triangular, are ROADMAP §1 item 10b-ii."""
    from faer_tpu_torch.linalg.qz_real import real_qz

    return real_qz(a, b, max_sweeps_factor=max_sweeps_factor)


def gevd_qz(a, b):
    """The generalized eigendecomposition of a real pencil through QZ:
    ``(alpha, beta, v, info)``, complex, with A v_k β_k = B v_k α_k column
    by column: the real QZ, the (α, β) of its 1×1 and 2×2 blocks, the
    pencil's quasi-triangular eigenvectors, back-transformed by Z, each of
    unit norm in (S, T)'s coordinates (faer ``gevd_real``,
    ``gevd/mod.rs:1295``)."""
    from faer_tpu_torch.linalg.eigvec import quasi_triangular_generalized_eigenvectors_pair
    from faer_tpu_torch.linalg.qz_real import qz_eigenvalues_pair, real_qz

    s, t, _, z, info = real_qz(a, b)
    ar, ai, be = qz_eigenvalues_pair(s, t)
    yr, yi = quasi_triangular_generalized_eigenvectors_pair(s, t, ar, ai, be)
    return (torch.complex(ar, ai), torch.complex(be, torch.zeros_like(be)),
            torch.complex(matmul(None, z, yr), matmul(None, z, yi)), info)
