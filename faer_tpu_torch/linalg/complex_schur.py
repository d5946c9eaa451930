"""Complex Schur decomposition: single-shift implicit QR (counterpart of
``complex_schur`` in ``faer_tpu/linalg/evd.py:250-393``).

faer ``complex_schur`` (``complex_schur.rs:631``) in its small-block form
(zlahqr's structure): complex Hessenberg → upper-triangular Schur form.
Each iteration zeroes the negligible subdiagonal entries (an ε·‖H‖ floor
that loosens every 5 stalled sweeps, capped at √ε·‖H‖), finds the start
``lo`` of the unreduced block that ends at ``hi``, and then deflates a 1×1
block or runs one single-shift sweep: the Wilkinson shift (the eigenvalue
of the trailing 2×2 nearer its last diagonal entry; an exceptional shift
``a22 + 0.75·|a21|`` every 10 stalled sweeps), then a chain of complex
Givens rotations from ``lo`` to ``hi − 1`` applied to H's rows and columns
and to Q's columns. A final pass zeroes the subdiagonal entries that are
negligible against the unloosened floor.

:func:`complex_schur_plain` is the CPU route and the twin of the
``complex_schur`` CUDA kernel (``ops/kernels/complex_schur.py``), which runs
the whole iteration of one problem in one CTA: every operation here is an
IEEE operation on a real number rounded on its own, in the order the
kernel repeats, so the two agree to the bit. It differs from the JAX
package deliberately in two ways:

* **Scaled magnitudes.** |x| of a complex x is m·√((re/m)² + (im/m)²) with
  m = max(|re|, |im|); the rotation's r = ‖(x, z)‖ is formed from |x| and
  |z| scaled by the larger; the Wilkinson shift is LAPACK zlahqr's form,
  a22 − u²/(x + y) with u = √a12·√a21, x = (a11 − a22)/2 and y = √(x² + u²)
  taken of values scaled by their largest component. The reference's
  unscaled ``sqrt(ax² + az²)`` and ``sqrt(tr² − 4·det)`` lose their bits
  to subnormal squares, which PyTorch keeps and XLA flushes (ROADMAP §3,
  "Subnormals").
* **H stays exactly Hessenberg.** Each rotation writes r and an exact zero
  into the entry it clears, and touches only rows i, i + 1 from column
  max(i − 1, lo) on, columns i, i + 1 of H's rows 0..min(i + 2, hi), and
  all of Q's rows (the JAX package rotates whole rows and columns and
  leaves rounding noise below the subdiagonal).

The rounding is pinned: the scalar arithmetic of a step runs on numpy
*real* scalars of the element type (a complex product spelled out as
(ac − bd, ad + bc), the complex square root and quotient by explicit real
formulas, numpy's square root correctly rounded), the per-entry
magnitudes of the deflation test on numpy arrays of the element type, and
the matrix updates on ``torch.view_as_real`` of H and Q, real tensors
times real scalars, one rounding an operation. No complex tensor product,
numpy complex scalar or complex ``sqrt`` enters: their rounding differs
between PyTorch's vectorized CPU loops and CUDA's ``c10::complex``.
"""
from __future__ import annotations

import numpy as np
import torch

from faer_tpu_torch.core import dtypes
from faer_tpu_torch.core.errors import SpectralInfo


def _cabs(re, im):
    """|re + i·im| from the pair scaled by its larger magnitude (numpy
    scalars; 0 for 0)."""
    m = np.maximum(abs(re), abs(im))
    if m == 0:
        return m
    a, b = re / m, im / m
    return m * np.sqrt(a * a + b * b)


def _cabs_arr(re, im):
    """:func:`_cabs` entrywise on numpy arrays of the element type."""
    m = np.maximum(np.abs(re), np.abs(im))
    safe = np.where(m == 0, m.dtype.type(1), m)
    a, b = re / safe, im / safe
    return m * np.sqrt(a * a + b * b)


def _cmul(ar, ai, br, bi):
    """(ar + i·ai)(br + i·bi) as (ac − bd, ad + bc)."""
    return ar * br - ai * bi, ar * bi + ai * br


def _cdiv(ar, ai, br, bi):
    """(ar + i·ai)/(br + i·bi) by Smith's algorithm (the divisor nonzero)."""
    if abs(br) >= abs(bi):
        r = bi / br
        d = br + bi * r
        return (ar + ai * r) / d, (ai - ar * r) / d
    r = br / bi
    d = bi + br * r
    return (ar * r + ai) / d, (ai * r - ar) / d


def _csqrt(re, im):
    """The principal square root of re + i·im by its real formula:
    t = √((|z| ± re)/2) on the side without cancellation."""
    sc = type(re)
    if re == 0 and im == 0:
        return sc(0), sc(0)
    m = _cabs(re, im)
    half, two = sc(0.5), sc(2)
    if re >= 0:
        t = np.sqrt(half * (m + re))
        return t, im / (two * t)
    t = np.sqrt(half * (m - re))
    return abs(im) / (two * t), np.copysign(t, im)


def _cgivens(xr, xi, zr, zi):
    """Complex Givens rotation: ``(c, sr, si, rr, ri)`` with c real and
    s = sr + i·si, G = [[c, −s̄], [s, c]] and Gᴴ (x, z)ᵀ = (r, 0)ᵀ,
    r = phase(x)·‖(x, z)‖; |x|, |z| and ‖(x, z)‖ from scaled values. The
    identity, r = x, when z = 0. Numpy scalars in, out."""
    sc = type(xr)
    az = _cabs(zr, zi)
    if az == 0:
        return sc(1), sc(0), sc(0), xr, xi
    ax = _cabs(xr, xi)
    m = np.maximum(ax, az)
    a, b = ax / m, az / m
    r = m * np.sqrt(a * a + b * b)
    c = ax / r
    if ax == 0:
        pr, pi = sc(1), sc(0)
    else:
        pr, pi = xr / ax, xi / ax
    # s = conj(phase)·z / r
    tr, ti = pr * zr + pi * zi, pr * zi - pi * zr
    return c, tr / r, ti / r, pr * r, pi * r


def _wilkinson(a11, a12, a21, a22):
    """The eigenvalue of [[a11, a12], [a21, a22]] nearer a22 (each entry a
    (re, im) pair of numpy scalars), as zlahqr forms it: a22 − u²/(x + y)
    with u = √a12·√a21, x = (a11 − a22)/2, y = ±√(x² + u²) signed so that
    |x + y| is the larger, all from values scaled by their largest
    component."""
    sc = type(a22[0])
    half = sc(0.5)
    s12, s21 = _csqrt(*a12), _csqrt(*a21)
    ur, ui = _cmul(*s12, *s21)
    xr, xi = half * (a11[0] - a22[0]), half * (a11[1] - a22[1])
    s = np.maximum(np.maximum(abs(ur), abs(ui)), np.maximum(abs(xr), abs(xi)))
    if s == 0:
        return a22
    xr, xi, ur, ui = xr / s, xi / s, ur / s, ui / s
    zr, zi = _cmul(xr, xi, xr, xi)
    u2r, u2i = _cmul(ur, ui, ur, ui)
    yr, yi = _csqrt(zr + u2r, zi + u2i)
    if xr * yr + xi * yi < 0:
        yr, yi = -yr, -yi
    dr, di = xr + yr, xi + yi
    if dr == 0 and di == 0:
        return a22
    qr, qi = _cdiv(ur, ui, dr, di)
    pr, pi = _cmul(ur, ui, qr, qi)
    return a22[0] - s * pr, a22[1] - s * pi


class _Problem:
    """One problem of :func:`complex_schur_plain`: ``m`` = [Q; H] stacked
    and viewed as real (rows, n, 2), so that a rotation's columns of Q and
    of H's top rows are one slice; ``sc`` the numpy scalar type of the real
    element type, in which each step's scalar arithmetic runs."""

    def __init__(self, h, q):
        self.r = q.shape[0]
        self.mc = torch.cat([q, h])
        self.m = torch.view_as_real(self.mc)
        self.h = self.m[self.r:]
        rdt = dtypes.real_dtype_of(h.dtype)
        self.sc = np.float32 if rdt == torch.float32 else np.float64
        self.eps = self.sc(dtypes.eps(rdt))
        self.tiny = self.sc(dtypes.min_positive(rdt))
        self.sgn = torch.tensor([1.0, -1.0], dtype=rdt, device=h.device)

    def get(self, i: int, j: int):
        """H[i, j] as a (re, im) pair of numpy scalars."""
        re, im = self.h[i, j].tolist()
        return self.sc(re), self.sc(im)

    def rotate_rows(self, i: int, c_from: int, c, sr, si) -> None:
        """Rows i, i + 1 of H from column ``c_from`` on ← Gᴴ rows: row i ←
        c·a + s̄·b, row i + 1 ← c·b − s·a (s̄·b = sr·b + si·sw(b))."""
        rotate_pair(self.h[i:i + 2, c_from:], 0, c, sr, si, self.sgn)

    def rotate_cols(self, i: int, rend: int, c, sr, si) -> None:
        """Columns i, i + 1 of Q and of H's rows 0..rend − 1 ← columns · G:
        column i ← c·x + s·y, column i + 1 ← c·y − s̄·x (s·y = sr·y −
        si·sw(y))."""
        rotate_pair(self.m[:self.r + rend, i:i + 2], 1, c, sr, -si, self.sgn)

    def negligible_subdiag(self, floor) -> None:
        """Zero every subdiagonal entry of H with |h| at most max(ε·(|d_i| +
        |d_{i+1}|), floor). In place."""
        negligible_subdiag(self.h, self.eps, floor)


def rotate_pair(pair, dim: int, c, s1, s2, sgn, *, reverse: bool = False) -> None:
    """The rotation of a pair of rows (``dim`` 0) or columns (``dim`` 1)
    P0, P1 of a real view (…, 2) of a complex matrix, in place: P0 ← c·P0 +
    (s1·P1 + s2·sw(P1)), P1 ← c·P1 + ((−s1)·P0 + s2·sw(P0)), sw(x) = −i·x =
    (x_im, −x_re), each product and sum one rounding (the kernels'
    ``rotate``); ``reverse`` swaps the roles of P0 and P1. ``sgn`` is the
    real tensor (1, −1) of the view's dtype and device."""
    other = pair.flip(dim)
    other_sw = other.flip(-1).mul_(sgn)
    shape = [1, 1, 1]
    shape[dim] = 2
    s1 = float(s1)
    coef = torch.tensor([-s1, s1] if reverse else [s1, -s1], dtype=pair.dtype,
                        device=pair.device).view(shape)
    # c·P + (coef·other + s2·sw(other)), one rounding an operation
    pair.copy_((pair * float(c)).add_(other.mul_(coef).add_(other_sw.mul_(float(s2)))))


def negligible_subdiag(h, eps, floor) -> None:
    """Zero every subdiagonal entry of the real view ``h`` (n, n, 2) of a
    complex Hessenberg matrix with |h| at most max(ε·(|d_i| + |d_{i+1}|),
    floor), the magnitudes scaled (numpy arrays of the element type). In
    place."""
    d = h.diagonal(0, 0, 1).cpu().numpy()  # (2, n)
    sd = h.diagonal(-1, 0, 1)
    sdn = sd.cpu().numpy()
    ad = _cabs_arr(d[0], d[1])
    tol = np.maximum(eps * (ad[:-1] + ad[1:]), floor)
    kill = np.nonzero(_cabs_arr(sdn[0], sdn[1]) <= tol)[0]
    if kill.size:
        sd[:, torch.from_numpy(kill).to(sd.device)] = 0.0


def _sweep(p: _Problem, lo: int, hi: int, stall: int) -> int:
    """One single-shift sweep on the unreduced block [lo, hi] (hi > lo) of
    the problem's H, Q's columns rotated alongside, in place; returns its
    chase steps (rotations)."""
    sc = p.sc
    a22 = p.get(hi, hi)
    if stall % 10 == 9:  # exceptional shift (LAPACK zlahqr)
        mu = (a22[0] + sc(0.75) * _cabs(*p.get(hi, hi - 1)), a22[1])
    else:
        mu = _wilkinson(p.get(hi - 1, hi - 1), p.get(hi - 1, hi), p.get(hi, hi - 1), a22)
    h00 = p.get(lo, lo)
    xr, xi = h00[0] - mu[0], h00[1] - mu[1]
    zr, zi = p.get(lo + 1, lo)
    for i in range(lo, hi):
        if i > lo:  # the bulge below the subdiagonal of column i − 1
            (xr, xi), (zr, zi) = p.h[i:i + 2, i - 1].tolist()
            xr, xi, zr, zi = sc(xr), sc(xi), sc(zr), sc(zi)
        c, sr, si, rr, ri = _cgivens(xr, xi, zr, zi)
        p.rotate_rows(i, max(i - 1, lo), c, sr, si)
        if i > lo:  # the entry the rotation clears: r and an exact zero
            p.h[i, i - 1, 0], p.h[i, i - 1, 1] = float(rr), float(ri)
            p.h[i + 1, i - 1] = 0.0
        p.rotate_cols(i, min(i + 2, hi) + 1, c, sr, si)
    return hi - lo


def complex_schur_plain(h, q, *, max_sweeps_factor: int = 30):
    """The iteration on one problem in plain PyTorch: ``(t, q, iterations,
    converged, steps)`` for the complex upper-Hessenberg ``h`` (n, n) and
    the (r, n) ``q`` whose columns absorb the similarity (new tensors;
    iterations and chase steps ints, converged a bool). The CPU route of
    :func:`complex_schur`, and the CUDA kernel's twin (module docstring)."""
    n = h.shape[0]
    if n == 1:
        return h.clone(), q.clone(), 0, True, 0
    p = _Problem(h, q)
    sc = p.sc
    hv = p.h.cpu().numpy()
    hn = np.max(_cabs_arr(hv[..., 0], hv[..., 1]))
    smlnum = p.eps * np.maximum(hn, p.tiny)
    cap = dtypes.deflation_stall_cap(h.dtype)
    max_iters = max_sweeps_factor * n
    hi, it, stall, steps = n - 1, 0, 0, 0
    while hi >= 1 and it < max_iters:
        p.negligible_subdiag(smlnum * sc(2 ** min(stall // 5, cap)))
        sd = p.mc[p.r:].diagonal(-1)[:hi]
        zeros = torch.nonzero(sd == 0)
        lo = int(zeros[-1, 0]) + 1 if zeros.numel() else 0
        if lo == hi:
            hi -= 1
            stall = 0
        else:
            steps += _sweep(p, lo, hi, stall)
            stall += 1
        it += 1
    # the final negligible pass against the unloosened floor (H is exactly
    # Hessenberg throughout)
    p.negligible_subdiag(smlnum)
    return p.mc[p.r:].clone(), p.mc[:p.r].clone(), it, hi < 1, steps


def complex_schur(h, q, *, max_sweeps_factor: int = 30):
    """Complex Schur form of the upper-Hessenberg ``h`` (complex64 or
    complex128): ``(t, q, info)`` with A = Q T Qᴴ for A = q h qᴴ, T upper
    triangular once converged. On a CUDA tensor one launch of the
    ``complex_schur`` kernel runs the whole iteration, with nothing read on
    the host; on a CPU tensor :func:`complex_schur_plain` runs."""
    from faer_tpu_torch.ops.kernels.complex_schur import complex_schur_batched

    n = h.shape[0]
    sizes = torch.full((1,), n, dtype=torch.int32, device=h.device)
    t, qo, its, conv, _ = complex_schur_batched(h.reshape(1, n, n).contiguous(),
                                                q.reshape(1, *q.shape).contiguous(), sizes,
                                                max_sweeps_factor=max_sweeps_factor)
    return t[0], qo[0], SpectralInfo(converged=conv[0], iterations=its[0])
