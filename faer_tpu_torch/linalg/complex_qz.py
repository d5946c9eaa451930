"""The complex QZ iteration and the complex Hessenberg–triangular chain
(counterpart of ``faer_tpu/linalg/qz.py:45-212``, and on native complex
tensors of ``faer_tpu/linalg/qz_cpair.py:133-304``).

faer ``generalized_hessenberg`` (``gen_hessenberg/mod.rs:223``) and
``hessenberg_to_qz`` (``qz_cplx/mod.rs:1140``) in their small-block form:

* :func:`hessenberg_triangular_plain` takes (H, R), R upper triangular, to
  H upper Hessenberg by a chain of complex Givens pairs, column by column,
  bottom up: a rotation of rows (i, i + 1) zeroes H[i + 1, j] (on H, R and
  Q's columns: rows take Gᴴ, Q's columns G, G = [[c, −s̄], [s, c]]) and
  leaves a bulge at R[i + 1, i]; a rotation of columns (i + 1, i), formed
  from conj(R[i + 1, i + 1]) and conj(R[i + 1, i]), zeroes it (on R, H and
  Z's columns).
* :func:`qz_iteration_plain` is the single-shift Moler–Stewart QZ on a
  Hessenberg/triangular pencil (H, R). Each iteration zeroes the
  negligible subdiagonal entries of H (an ε·‖H‖ floor that loosens by
  2^(stall // 5), capped at √ε·‖H‖), finds the start ``lo`` of the
  unreduced block that ends at ``hi``, and then deflates a 1×1 block or
  runs one sweep: the shift is the eigenvalue of the trailing 2×2 of H R⁻¹
  nearer its last diagonal entry m22 (R's diagonal guarded: an entry below
  the floor becomes the floor), or m22 + 0.75·|m21| every 10 stalled
  sweeps; then a chain from ``lo`` to ``hi − 1`` of a left rotation (H's
  and R's rows, Q's columns) and a right rotation that clears R[i + 1, i]
  (H's, R's and Z's columns). A final pass zeroes the subdiagonal entries
  that are negligible against the unloosened floor. Infinite eigenvalues
  (a zero on R's diagonal) have no deflation of their own, as in the JAX
  package: the guarded shift carries them.

Both plain versions are the CPU routes and the twins of the CUDA kernels
``complex_hess_tri`` and ``complex_qz`` (``ops/kernels/complex_qz.py``),
which run a problem's whole chain or iteration in one CTA: every
operation here is an IEEE operation on a real number rounded on its own,
in the order the kernels repeat, so the two agree to the bit. They differ
from the JAX package deliberately in two ways:

* **Scaled magnitudes.** |x|, each rotation's norm and the shift's square
  roots come from values scaled by their largest component
  (``complex_schur``'s ``_cabs``, ``_cgivens`` and ``_wilkinson``, whose
  form of the 2×2 eigenvalue, a22 − u²/(x + y), takes the square root of
  the scaled discriminant). The reference's unscaled ``sqrt(ax² + az²)``
  and ``sqrt(tr² − 4·det)`` lose their bits to subnormal squares, which
  PyTorch keeps and XLA flushes (ROADMAP §3, "Subnormals").
* **Exact zeros.** Each rotation writes the zeros it makes (and r into the
  bulge's entry it clears), and touches only the rows and columns that can
  be nonzero: H's rows i, i + 1 from column max(i − 1, lo), R's from
  column i, H's columns i, i + 1 on rows 0..min(i + 2, hi), R's on rows
  0..i + 1, all of Q's and Z's rows. H stays exactly Hessenberg and R
  exactly triangular (the JAX package rotates whole rows and columns and
  masks at the end).

The rounding is pinned as in ``complex_schur``: the scalar arithmetic of a
step runs on numpy *real* scalars of the element type (complex products
spelled out as (ac − bd, ad + bc), quotients by Smith's algorithm), the
deflation test's magnitudes on numpy arrays, and the row and column
updates on ``torch.view_as_real`` views (``complex_schur.rotate_pair``).
No complex tensor product, numpy complex scalar or complex ``sqrt``
enters.
"""
from __future__ import annotations

import numpy as np
import torch

from faer_tpu_torch.core import dtypes
from faer_tpu_torch.core.errors import SpectralInfo
from faer_tpu_torch.linalg.complex_schur import (
    _cabs,
    _cabs_arr,
    _cdiv,
    _cgivens,
    _cmul,
    _wilkinson,
    negligible_subdiag,
    rotate_pair,
)


class _Pencil:
    """One problem of the plain versions: H, R, Q, Z and their real views,
    Z and H stacked as [Z; H] so that a right rotation's columns of Z and of
    H's top rows are one slice (updated in place); ``sc`` the numpy scalar
    type of the real element type, in which each step's scalar arithmetic
    runs."""

    def __init__(self, h, r, q, z):
        n = h.shape[0]
        self.zh = torch.cat([z, h])
        self.mats = [self.zh[n:], r.clone(), q.clone(), self.zh[:n]]
        self.m = torch.view_as_real(self.zh)
        self.h, self.r, self.q, self.z = (torch.view_as_real(x) for x in self.mats)
        rdt = dtypes.real_dtype_of(h.dtype)
        self.sc = np.float32 if rdt == torch.float32 else np.float64
        self.eps = self.sc(dtypes.eps(rdt))
        self.tiny = self.sc(dtypes.min_positive(rdt))
        self.sgn = torch.tensor([1.0, -1.0], dtype=rdt, device=h.device)

    def get(self, m, i: int, j: int):
        """m[i, j] of a real view as a (re, im) pair of numpy scalars."""
        re, im = m[i, j].tolist()
        return self.sc(re), self.sc(im)

    def left(self, i: int, h_from: int, c, sr, si) -> None:
        """The left rotation of rows (i, i + 1): H's from column ``h_from``,
        R's from column i, Q's columns i, i + 1."""
        rotate_pair(self.h[i:i + 2, h_from:], 0, c, sr, si, self.sgn)
        rotate_pair(self.r[i:i + 2, i:], 0, c, sr, si, self.sgn)
        rotate_pair(self.q[:, i:i + 2], 1, c, sr, -si, self.sgn)

    def right(self, i: int, h_rows: int):
        """The rotation of columns (i + 1, i) that clears R[i + 1, i]
        against R[i + 1, i + 1] (formed from their conjugates): H's rows
        0..h_rows − 1, R's rows 0..i + 1, every row of Z; R[i + 1, i] an
        exact zero."""
        b, a = self.get(self.r, i + 1, i), self.get(self.r, i + 1, i + 1)
        c, sr, si, _, _ = _cgivens(a[0], -a[1], b[0], -b[1])
        for m, rend in ((self.m, self.z.shape[0] + h_rows), (self.r, i + 2)):
            rotate_pair(m[:rend, i:i + 2], 1, c, sr, -si, self.sgn, reverse=True)
        self.r[i + 1, i] = 0.0


def hessenberg_triangular_plain(h, r, q, z):
    """The complex Givens chain on one problem in plain PyTorch: ``(h, r,
    q, z)`` new tensors, from an (n, n) ``h``, an upper-triangular ``r`` and
    the ``q`` and ``z`` whose columns absorb the left and right rotations:
    H upper Hessenberg, R upper triangular, both exactly, with Q H Zᴴ and
    Q R Zᴴ those of the input. The CPU route of ``complex_hess_tri_batched``
    and the kernel's twin (module docstring)."""
    p = _Pencil(h, r, q, z)
    n = h.shape[0]
    for j in range(n - 2):
        for i in range(n - 2, j, -1):
            x, y = p.get(p.h, i, j), p.get(p.h, i + 1, j)
            c, sr, si, _, _ = _cgivens(*x, *y)
            p.left(i, j, c, sr, si)
            p.h[i + 1, j] = 0.0
            p.right(i, n)
    return tuple(x.clone() for x in p.mats)


def _shift(p: _Pencil, hi: int, stall: int, smlnum):
    """The sweep's shift: the eigenvalue of the trailing 2×2 of H R⁻¹
    nearer its (2, 2) entry m22 (``_wilkinson``), R's diagonal entries
    below ``smlnum`` in magnitude taken as ``smlnum``; m22 + 0.75·|m21|
    when ``stall % 10 == 9``."""
    sc = p.sc

    def safe(x):
        return (smlnum, sc(0)) if _cabs(*x) < smlnum else x

    h, r = p.h, p.r
    r11, r22 = safe(p.get(r, hi - 1, hi - 1)), safe(p.get(r, hi, hi))
    r12 = p.get(r, hi - 1, hi)
    m11 = _cdiv(*p.get(h, hi - 1, hi - 1), *r11)
    m21 = _cdiv(*p.get(h, hi, hi - 1), *r11)
    h12, h22 = p.get(h, hi - 1, hi), p.get(h, hi, hi)
    tr, ti = _cmul(*m11, *r12)
    m12 = _cdiv(h12[0] - tr, h12[1] - ti, *r22)
    tr, ti = _cmul(*m21, *r12)
    m22 = _cdiv(h22[0] - tr, h22[1] - ti, *r22)
    if stall % 10 == 9:  # exceptional shift
        return m22[0] + sc(0.75) * _cabs(*m21), m22[1]
    return _wilkinson(m11, m12, m21, m22)


def _sweep(p: _Pencil, lo: int, hi: int, stall: int, smlnum) -> int:
    """One single-shift sweep on the unreduced block [lo, hi] (hi > lo),
    in place; returns its chase steps (hi − lo)."""
    mu = _shift(p, hi, stall, smlnum)
    h00, r00 = p.get(p.h, lo, lo), p.get(p.r, lo, lo)
    mr, mi = _cmul(*mu, *r00)
    x, z = (h00[0] - mr, h00[1] - mi), p.get(p.h, lo + 1, lo)
    for i in range(lo, hi):
        if i > lo:  # the bulge below the subdiagonal of column i − 1
            x, z = p.get(p.h, i, i - 1), p.get(p.h, i + 1, i - 1)
        c, sr, si, rr, ri = _cgivens(*x, *z)
        p.left(i, max(i - 1, lo), c, sr, si)
        if i > lo:  # the entry the rotation clears: r and an exact zero
            p.h[i, i - 1, 0], p.h[i, i - 1, 1] = float(rr), float(ri)
            p.h[i + 1, i - 1] = 0.0
        p.right(i, min(i + 2, hi) + 1)
    return hi - lo


def qz_iteration_plain(h, r, q, z, *, max_sweeps_factor: int = 30):
    """The complex QZ iteration on one problem in plain PyTorch: ``(s, t,
    q, z, iterations, converged, steps)`` from the complex upper-Hessenberg
    ``h``, upper-triangular ``r`` (n, n) and the (n, n) ``q`` and ``z``
    whose columns absorb the left and right rotations (new tensors;
    iterations and chase steps ints, converged a bool). The CPU route of
    :func:`qz_iteration` and the ``complex_qz`` kernel's twin (module
    docstring)."""
    n = h.shape[0]
    if n == 1:
        return h.clone(), r.clone(), q.clone(), z.clone(), 0, True, 0
    p = _Pencil(h, r, q, z)
    sc = p.sc
    hv = p.h.cpu().numpy()
    smlnum = p.eps * np.maximum(np.max(_cabs_arr(hv[..., 0], hv[..., 1])), p.tiny)
    cap = dtypes.deflation_stall_cap(h.dtype)
    hc = p.mats[0]
    hi, it, stall, steps = n - 1, 0, 0, 0
    while hi >= 1 and it < max_sweeps_factor * n:
        negligible_subdiag(p.h, p.eps, smlnum * sc(2 ** min(stall // 5, cap)))
        zeros = torch.nonzero(hc.diagonal(-1)[:hi] == 0)
        lo = int(zeros[-1, 0]) + 1 if zeros.numel() else 0
        if lo == hi:
            hi -= 1
            stall = 0
        else:
            steps += _sweep(p, lo, hi, stall, smlnum)
            stall += 1
        it += 1
    # the final negligible pass against the unloosened floor
    negligible_subdiag(p.h, p.eps, smlnum)
    return (*(x.clone() for x in p.mats), it, hi < 1, steps)


def qz_iteration(h, r, q, z, *, max_sweeps_factor: int = 30):
    """The complex QZ on a Hessenberg/triangular pencil (complex64 or
    complex128): ``(s, t, q, z, info)`` with S and T upper triangular once
    converged and Q S Zᴴ, Q T Zᴴ those of the input (A = Q S Zᴴ and
    B = Q T Zᴴ when ``q``, ``z`` come from ``hessenberg_triangular``). On a
    CUDA tensor one launch of the ``complex_qz`` kernel runs the whole
    iteration, with nothing read on the host; on a CPU tensor
    :func:`qz_iteration_plain` runs."""
    from faer_tpu_torch.ops.kernels.complex_qz import complex_qz_batched

    n = h.shape[0]
    sizes = torch.full((1,), n, dtype=torch.int32, device=h.device)
    s, t, qo, zo, its, conv, _ = complex_qz_batched(
        *(x.reshape(1, n, n).contiguous() for x in (h, r, q, z)), sizes,
        max_sweeps_factor=max_sweeps_factor)
    return s[0], t[0], qo[0], zo[0], SpectralInfo(converged=conv[0], iterations=its[0])
