"""The real double-shift QZ iteration (counterpart of
``faer_tpu/linalg/qz_real.py``).

faer ``hessenberg_to_qz`` (``qz_real/mod.rs:1508``): the real
Moler–Stewart QZ with implicit double shifts on a Hessenberg/triangular
pencil (H, T), giving A = Q S Zᵀ and B = Q T Zᵀ with S quasi-triangular
(1×1 and 2×2 blocks) and T upper triangular. Each iteration zeroes the
negligible subdiagonal entries of H (against ε·‖H‖, a floor that loosens
by 2^(stall // 5), capped at √ε·‖H‖) and the negligible diagonal entries of
T (against ε·‖T‖, a floor that does not loosen: loosened, it makes
spurious infinite eigenvalues), finds the start ``lo`` of the unreduced
block that ends at ``hi``, and then runs one of four cases (LAPACK
``dhgeqz``'s structure):

* a 1×1 block deflates;
* a zero diagonal entry T[jz, jz] in the block, where the coupling
  H[jz, jz − 1] allows a clean split (jz = lo, jz = hi, or a coupling under
  the loosened floor), is the infinite-eigenvalue step: at jz = hi a
  rotation of columns (hi − 1, hi) zeroes H[hi, hi − 1] and deflates it;
  below, a rotation of rows (jz, jz + 1) zeroes H[jz + 1, jz], which splits
  the block, its fill at (jz + 1, jz − 1) dropped (bounded by the floor);
* a 2×2 block is standardized (``deflate2``, a dlagv2-lite): triangular
  where its eigenvalues are real, left coupled where they are complex;
* else one double-shift sweep from ``lo``: the shifts from the trailing 2×2
  of H T⁻¹ (an exceptional shift every 10 stalled sweeps), the scaled
  first column of (W² − sW + pI)e₁ with W = H T⁻¹, then the chase: per
  step a 3-row reflector from the left clears H's bulge column (on H's and
  T's rows and Q's columns), a reversed 3-column reflector clears T's fill
  row T[i + 2, i:i + 2], and a 2-column rotation clears T[i + 1, i] (on H's
  and T's columns and Z's).

A final pass zeroes S's subdiagonal entries that are negligible against
the unloosened floor.

:func:`real_qz_iteration_plain` is the CPU route and the twin of the
``real_qz`` CUDA kernel (``ops/kernels/real_qz.py``), which runs the whole
iteration of one problem in one CTA: every scalar step (the floors, the
shifts, the reflectors, the rotations) runs on numpy scalars of the
element type, one IEEE rounding an operation, and every row and column
update is a PyTorch operation, in the order the kernel repeats, so the two
agree to the bit. Against the JAX package it differs where the port keeps
H exactly Hessenberg, as LAPACK does: the chase writes β and exact zeros
into the column each left reflector clears, applies each transform only
where the pencil can change, and keeps no zero-padded carries (indices are
guarded instead). The reflectors and rotations come from scaled entries
(``real_schur._house3`` and ``_unit_pair``): PyTorch keeps the float32
subnormals that XLA flushes, and unscaled squares underflow there.
"""
from __future__ import annotations

import numpy as np
import torch

from faer_tpu_torch.core import dtypes
from faer_tpu_torch.core.errors import SpectralInfo
from faer_tpu_torch.linalg.qz import _pencil, _rotate_cols, _rotate_rows
from faer_tpu_torch.linalg.real_schur import _house3, _negligible_subdiag, _unit_pair


def _reflect_rows(m, i: int, k: int, c0: int, tau, u2, u3) -> None:
    """(I − τ u uᵀ), u = (1, u2[, u3]), on ``k`` = 2 or 3 rows of ``m`` from
    row i, columns c0 on. In place."""
    cu = torch.tensor([1.0, float(u2), float(u3)][:k], dtype=m.dtype, device=m.device)
    tau, u2, u3 = float(tau), float(u2), float(u3)
    rows = m[i:i + k, c0:]
    w = rows[0] + u2 * rows[1]
    if k == 3:
        w = w + u3 * rows[2]
    rows -= tau * (cu[:, None] * w[None, :])


def _reflect_cols(m, i: int, k: int, tau, u2, u3) -> None:
    """The same reflector on ``k`` columns of every row of ``m``. In place."""
    cu = torch.tensor([1.0, float(u2), float(u3)][:k], dtype=m.dtype, device=m.device)
    tau, u2, u3 = float(tau), float(u2), float(u3)
    cols = m[:, i:i + k]
    w = cols[:, 0] + u2 * cols[:, 1]
    if k == 3:
        w = w + u3 * cols[:, 2]
    cols -= tau * (w[:, None] * cu[None, :])


def _reflect_cols_rev(m, i: int, rend: int, tau, r1, r2) -> None:
    """The reversed 3-column reflector (I − τ u uᵀ), u = (r1, r2, 1), on
    columns i..i + 2 of ``m``'s rows 0..rend − 1. In place."""
    uv = torch.tensor([float(r1), float(r2), 1.0], dtype=m.dtype, device=m.device)
    tau, r1, r2 = float(tau), float(r1), float(r2)
    cols = m[:rend, i:i + 3]
    wc = cols[:, 0] * r1 + cols[:, 1] * r2 + cols[:, 2]
    cols -= tau * (wc[:, None] * uv[None, :])


class _Pencil:
    """One problem of :func:`real_qz_iteration_plain`: H, T, Q, Z (new
    tensors, updated in place) and ``sc``, the numpy scalar type of the
    element type, in which each step's scalar arithmetic runs."""

    def __init__(self, h, t, q, z):
        self.h, self.t, self.q, self.z = (x.clone() for x in (h, t, q, z))
        self.n = h.shape[0]
        self.sc = np.float32 if h.dtype == torch.float32 else np.float64
        self.eps = self.sc(dtypes.eps(h.dtype))
        self.tiny = self.sc(dtypes.min_positive(h.dtype))

    def get(self, m, rows, cols):
        """Entries of ``m`` as numpy scalars (``rows``/``cols`` ints or slices)."""
        vals = m[rows, cols].tolist()
        if isinstance(vals, list):
            return [self.sc(v) for v in vals]
        return self.sc(vals)


def _deflate2(p: _Pencil, lo: int) -> None:
    """Standardize the 2×2 block at (lo, lo): where the generalized
    eigenvalues are real, rotate A·adj(T)'s eigenvector into e₁ from the left
    (H's and T's rows lo, lo + 1 and Q's columns) and restore T's
    triangularity from the right (H's and T's columns, rows 0..lo + 1, and
    Z's); a complex pair stays coupled. In place."""
    h, t, sc = p.h, p.t, p.sc
    (a11, a12), (a21, a22) = p.get(h, lo, slice(lo, lo + 2)), p.get(h, lo + 1, slice(lo, lo + 2))
    b11, b12 = p.get(t, lo, slice(lo, lo + 2))
    b22 = p.get(t, lo + 1, lo + 1)
    # each block scaled by its largest magnitude (neither the eigenvectors
    # of A B⁻¹ nor the sign of the discriminant change), so that the
    # products below do not underflow where the pencil is small
    sa = max(abs(a11), abs(a12), abs(a21), abs(a22))
    sb = max(abs(b11), abs(b12), abs(b22))
    sa, sb = (x if x != 0 else sc(1) for x in (sa, sb))
    a11, a12, a21, a22 = a11 / sa, a12 / sa, a21 / sa, a22 / sa
    b11, b12, b22 = b11 / sb, b12 / sb, b22 / sb
    # C = A adj(B): the eigenvectors of A B⁻¹; the real/complex test is unchanged
    c11 = a11 * b22
    c12 = -a11 * b12 + a12 * b11
    c21 = a21 * b22
    c22 = -a21 * b12 + a22 * b11
    m = sc(0.5) * (c11 + c22)
    pp = sc(0.5) * (c11 - c22)
    disc = pp * pp + c12 * c21
    if disc >= 0:
        sq = np.sqrt(abs(disc))
        lam = m + (sq if pp >= 0 else -sq)
        cl, sl = (float(v) for v in _unit_pair(lam - c22, c21))
        _rotate_rows(h, lo, lo, cl, sl)
        _rotate_rows(t, lo, lo, cl, sl)
        _rotate_cols(p.q, lo, p.n, cl, sl)
        cr, sr = (float(v) for v in _unit_pair(*p.get(t, lo + 1, slice(lo, lo + 2))[::-1]))
        for mat, rend in ((h, lo + 2), (t, lo + 2), (p.z, p.n)):
            _rotate_cols(mat, lo, rend, cr, -sr)
        h[lo + 1, lo] = 0.0
    t[lo + 1, lo] = 0.0


def _inf_step(p: _Pencil, lo: int, hi: int, jz: int) -> None:
    """The zero diagonal entry T[jz, jz]: at jz = hi a rotation of columns
    (hi − 1, hi) zeroes H[hi, hi − 1] (H's and T's rows 0..hi, Z's); below
    hi a rotation of rows (jz, jz + 1) zeroes H[jz + 1, jz] (H from column
    jz − 1, T from column jz, Q's columns), its fill at (jz + 1, jz − 1)
    dropped when jz > lo. In place."""
    h, t = p.h, p.t
    if jz >= hi:
        c2, s2 = (float(v) for v in _unit_pair(p.get(h, hi, hi), p.get(h, hi, hi - 1)))
        for mat, rend in ((h, hi + 1), (t, hi + 1), (p.z, p.n)):
            _rotate_cols(mat, hi - 1, rend, c2, -s2)
        h[hi, hi - 1] = 0.0
        return
    cc, ss = (float(v) for v in _unit_pair(p.get(h, jz, jz), p.get(h, jz + 1, jz)))
    _rotate_rows(h, jz, max(jz - 1, 0), cc, ss)
    _rotate_rows(t, jz, jz, cc, ss)
    _rotate_cols(p.q, jz, p.n, cc, ss)
    h[jz + 1, jz] = 0.0
    t[jz, jz] = 0.0
    if jz > lo:
        h[jz + 1, jz - 1] = 0.0


def _safe(x, ref):
    """``x``, or ±ref where |x| < ref (numpy scalars)."""
    if abs(x) < ref:
        return -ref if x < 0 else ref
    return x


def _sweep(p: _Pencil, lo: int, hi: int, stall: int, smlnum_t) -> int:
    """One double-shift sweep on the unreduced block [lo, hi] (hi − lo ≥ 2),
    in place; returns its chase steps."""
    h, t, sc = p.h, p.t, p.sc
    # the shifts: the eigenvalues of the trailing 2×2 of H T⁻¹
    t11 = _safe(p.get(t, hi - 1, hi - 1), smlnum_t)
    t22 = _safe(p.get(t, hi, hi), smlnum_t)
    t12 = p.get(t, hi - 1, hi)
    (h11, h12), (h21, h22) = p.get(h, hi - 1, slice(hi - 1, hi + 1)), p.get(h, hi, slice(hi - 1, hi + 1))
    m11 = h11 / t11
    m21 = h21 / t11
    m12 = (h12 - m11 * t12) / t22
    m22 = (h22 - m21 * t12) / t22
    if stall % 10 == 9:  # the exceptional shift
        se = abs(m21) + abs(m12)
        m11 = sc(0.75) * se + m22
        m12 = sc(-0.4375) * se
        m21 = se
    s = m11 + m22
    pr = m11 * m22 - m12 * m21
    # the first column of W² − sW + pI, W = H T⁻¹: rows lo..lo + 2
    s11 = _safe(p.get(t, lo, lo), smlnum_t)
    s22 = _safe(p.get(t, lo + 1, lo + 1), smlnum_t)
    s12 = p.get(t, lo, lo + 1)
    (a0, b0), (c0, d0) = p.get(h, lo, slice(lo, lo + 2)), p.get(h, lo + 1, slice(lo, lo + 2))
    e0 = p.get(h, lo + 2, lo + 1)
    u1 = a0 / s11
    u2 = c0 / s11
    y2 = u2 / s22
    y1 = (u1 - s12 * y2) / s11
    v1 = a0 * y1 + b0 * y2 - s * u1 + pr
    v2 = c0 * y1 + d0 * y2 - s * u2
    v3 = e0 * y2
    scale = max(max(abs(v1), abs(v2)), max(abs(v3), p.tiny))
    v1, v2, v3 = v1 / scale, v2 / scale, v3 / scale
    for i in range(lo, hi):
        last = i == hi - 1
        k = 2 if last else 3
        if i > lo:  # the bulge below the subdiagonal of column i − 1
            v1, v2, *rest = p.get(h, slice(i, i + k), i - 1)
            v3 = rest[0] if rest else None
        if last:
            v3 = sc(0)
        tau, u2, u3, beta = _house3(v1, v2, v3)
        # from the left: rows i..i + k − 1 of H (from column i − 1, which
        # gets β and exact zeros; from lo on the first step) and of T, Q's
        # columns
        _reflect_rows(h, i, k, i - 1 if i > lo else lo, tau, u2, u3)
        if i > lo:
            h[i, i - 1] = float(beta)
            h[i + 1:i + k, i - 1] = 0.0
        _reflect_rows(t, i, k, i, tau, u2, u3)
        _reflect_cols(p.q, i, k, tau, u2, u3)
        rend = min(i + 3, hi) + 1
        if not last:
            # from the right: the reversed reflector clearing T[i + 2, i:i + 2]
            x1, x2, x3 = p.get(t, i + 2, slice(i, i + 3))
            tau2, r2, r1, _ = _house3(x3, x2, x1)
            _reflect_cols_rev(h, i, rend, tau2, r1, r2)
            _reflect_cols_rev(t, i, i + 3, tau2, r1, r2)
            _reflect_cols_rev(p.z, i, p.n, tau2, r1, r2)
            if tau2 != 0:
                t[i + 2, i:i + 2] = 0.0
        # the rotation of columns (i, i + 1) clearing T[i + 1, i]
        t10, t11_ = p.get(t, i + 1, slice(i, i + 2))
        cg, sg = (float(v) for v in _unit_pair(t11_, t10))
        for mat, rend_ in ((h, rend), (t, min(i + 3, p.n)), (p.z, p.n)):
            _rotate_cols(mat, i, rend_, cg, -sg)
        t[i + 1, i] = 0.0
    return hi - lo


def real_qz_iteration_plain(h, t, q, z, *, max_sweeps_factor: int = 30):
    """The QZ iteration on one problem in plain PyTorch: ``(s, t, q, z,
    iterations, converged, steps)`` from the upper-Hessenberg ``h`` and
    upper-triangular ``t`` (n, n) and the (n, n) ``q`` and ``z`` whose
    columns absorb the left and right transforms (new tensors; the counts
    ints, converged a bool). The CPU route of ``real_qz_batched`` and the
    CUDA kernel's twin (module docstring)."""
    n = h.shape[0]
    if n == 1:
        return h.clone(), t.clone(), q.clone(), z.clone(), 0, True, 0
    p = _Pencil(h, t, q, z)
    sc, eps = p.sc, p.eps
    smlnum = eps * max(sc(h.abs().amax().item()), p.tiny)
    smlnum_t = eps * max(sc(t.abs().amax().item()), p.tiny)
    cap = dtypes.deflation_stall_cap(h.dtype)
    max_iters = max_sweeps_factor * n
    hi, it, stall, steps = n - 1, 0, 0, 0
    while hi >= 1 and it < max_iters:
        floor = smlnum * sc(2 ** min(stall // 5, cap))
        _negligible_subdiag(p.h, floor, eps)
        td = p.t.diagonal()
        td.masked_fill_(td.abs() <= float(smlnum_t), 0.0)
        zeros = torch.nonzero(p.h.diagonal(-1)[:hi] == 0)
        lo = int(zeros[-1, 0]) + 1 if zeros.numel() else 0
        nr = hi - lo + 1
        progressed = True
        if nr == 1:
            hi -= 1
        else:
            # a zero T diagonal entry in [lo, hi] where the block can split
            js = torch.arange(lo, hi + 1, device=h.device)
            sub = torch.cat([p.h.new_zeros(1), p.h.diagonal(-1).abs()])[lo:hi + 1]
            eligible = (td[lo:hi + 1] == 0) & ((js == hi) | (js == lo) | (sub <= float(floor)))
            hits = torch.nonzero(eligible)
            if hits.numel():
                jz = lo + int(hits[0, 0])
                _inf_step(p, lo, hi, jz)
                if jz >= hi:
                    hi -= 1
                else:
                    progressed = False
            elif nr == 2:
                _deflate2(p, lo)
                hi = lo - 1
            else:
                steps += _sweep(p, lo, hi, stall, smlnum_t)
                progressed = False
        stall = 0 if progressed else stall + 1
        it += 1
    # exact zeros below S's subdiagonal and T's diagonal; then the final
    # negligible pass against the unloosened floor
    s = torch.triu(p.h, -1)
    _negligible_subdiag(s, smlnum, eps)
    return s, torch.triu(p.t), p.q, p.z, it, hi < 1, steps


def real_qz_iteration(h, t, q, z, *, max_sweeps_factor: int = 30):
    """The real QZ on a Hessenberg/triangular pencil: ``(s, t, q, z,
    info)`` with S quasi-triangular and T upper triangular, H = Q' S Z'ᵀ
    for the accumulated transforms (A = Q S Zᵀ when ``q``, ``z`` come from
    the reduction). On a CUDA tensor one launch of the ``real_qz`` kernel
    runs the whole iteration, with nothing read on the host; on a CPU
    tensor :func:`real_qz_iteration_plain` runs."""
    from faer_tpu_torch.ops.kernels.real_qz import real_qz_batched

    n = h.shape[0]
    sizes = torch.full((1,), n, dtype=torch.int32, device=h.device)
    s, to, qo, zo, its, conv, _ = real_qz_batched(
        h[None].contiguous(), t[None].contiguous(), q[None].contiguous(),
        z[None].contiguous(), sizes, max_sweeps_factor=max_sweeps_factor)
    return s[0], to[0], qo[0], zo[0], SpectralInfo(converged=conv[0], iterations=its[0])


def real_qz(a, b, *, max_sweeps_factor: int = 30):
    """The real generalized Schur form of the pencil (A, B): ``(s, t, q, z,
    info)`` with A = Q S Zᵀ and B = Q T Zᵀ, S quasi-triangular, T upper
    triangular, all real: ``hessenberg_triangular``, then
    :func:`real_qz_iteration` (one ``hess_tri`` and one ``real_qz`` launch
    on a card)."""
    from faer_tpu_torch.linalg.qz import hessenberg_triangular

    a, b = _pencil(a, b, "real_qz")
    dtypes.require_real(a, "real_qz")
    h, t, q, z = hessenberg_triangular(a, b)
    return real_qz_iteration(h, t, q, z, max_sweeps_factor=max_sweeps_factor)


def qz_eigenvalues_pair(s, t):
    """(α_re, α_im, β) from a real quasi-triangular pair (S, T): a 1×1 block
    gives (S_kk, 0, T_kk), β = 0 an infinite eigenvalue; a 2×2 block
    (S[k + 1, k] ≠ 0) the complex pair of det(S₂ − λT₂) = 0, with
    β = |det T₂| and α = λβ (``faer_tpu/linalg/qz_real.py:373``)."""
    dtypes.require_real(s, "qz_eigenvalues_pair")
    n = s.shape[0]
    d, td = s.diagonal(), t.diagonal()
    if n == 1:
        return d.clone(), torch.zeros_like(d), td.clone()
    sd, sup, tsup = s.diagonal(-1), s.diagonal(1), t.diagonal(1)
    a11, a22, b11, b22 = d[:-1], d[1:], td[:-1], td[1:]
    # det(A − λB) = c2 λ² − c1 λ + c0
    c2 = b11 * b22
    c1 = a11 * b22 + a22 * b11 - sd * tsup
    c0 = a11 * a22 - sup * sd
    sq = (c1 * c1 - 4 * c2 * c0).abs().sqrt()
    safe_c2 = torch.where(c2 == 0, torch.ones_like(c2), c2)
    re_pair = c1 / (2 * safe_c2)
    im_pair = sq / (2 * safe_c2.abs())
    blk = sd != 0
    z1 = torch.zeros(1, dtype=s.dtype, device=s.device)
    f1 = torch.zeros(1, dtype=torch.bool, device=s.device)
    is_top, is_bot = torch.cat([blk, f1]), torch.cat([f1, blk])
    re_t, re_b = torch.cat([re_pair, z1]), torch.cat([z1, re_pair])
    im_t, im_b = torch.cat([im_pair, z1]), torch.cat([z1, im_pair])
    c2_t, c2_b = torch.cat([c2, z1]), torch.cat([z1, c2])
    # in a block α = λ·β with β = |c2| (the sign folded into α)
    sgn_t = torch.where(c2_t < 0, -torch.ones_like(c2_t), torch.ones_like(c2_t))
    sgn_b = torch.where(c2_b < 0, -torch.ones_like(c2_b), torch.ones_like(c2_b))
    ar = torch.where(is_top, re_t * c2_t * sgn_t, torch.where(is_bot, re_b * c2_b * sgn_b, d))
    ai = torch.where(is_top, im_t * c2_t.abs(),
                     torch.where(is_bot, -im_b * c2_b.abs(), torch.zeros_like(d)))
    be = torch.where(is_top, c2_t.abs(), torch.where(is_bot, c2_b.abs(), td))
    return ar, ai, be
