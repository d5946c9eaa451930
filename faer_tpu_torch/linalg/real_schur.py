"""Real Schur decomposition: Francis double-shift implicit QR (counterpart
of ``faer_tpu/linalg/real_schur.py``).

faer ``lahqr`` (``real_schur.rs:2353``): real Hessenberg → quasi-triangular
Schur form with 1×1 and 2×2 diagonal blocks. Each iteration zeroes the
negligible subdiagonal entries (an ε·‖H‖ floor that loosens every 5
stalled sweeps, capped at √ε·‖H‖), finds the start ``lo`` of the
unreduced block that ends at ``hi``, and then deflates a 1×1 block,
standardizes a 2×2 one (``lahqr_schur22``, ``real_schur.rs:121``), or runs
one Francis double-shift sweep: the shifts from the trailing 2×2 (an
exceptional shift every 10 stalled sweeps), the sweep start at the largest
m in (lo, hi − 2] where the bulge's introduction is negligible against
H[m, m − 1] (LAPACK dlahqr's search), then a chain of 3×3 reflectors
applied to H's rows and columns and to Q's columns. A final pass zeroes the
subdiagonal entries that are negligible against the unloosened floor.

:func:`real_schur_plain` is the CPU route and the twin of the
``real_schur`` CUDA kernel (``ops/kernels/real_schur.py``), which runs the
whole iteration of one problem in one CTA: every operation here is an IEEE
operation rounded on its own, in the order the kernel repeats, so the two
agree to the bit. Against the JAX package it differs where the port keeps
H exactly Hessenberg, as LAPACK does: the chase writes β and exact zeros
into the column each reflector clears, drops the fill-in of the first
reflector below H[m, m − 1] (negligible by the choice of m), and therefore
applies each reflector only where H and Q can change (rows i..i+2 from
column i − 1 on, columns i..i+2 down to row min(i + 3, hi), all of Q's
rows). PyTorch keeps float32 subnormals, which XLA flushes, so the squares
that can underflow are taken of scaled values: the reflector's vector is
divided by its largest entry, the sweep start's test divides each
candidate's vector by its largest entry (both sides of the test are
homogeneous in it, as in LAPACK; unscaled, its products underflow below
‖H‖ ≈ 1e-13 in float32 and the start lands where the dropped fill-in is
not negligible), and the 2×2 rotations come from square roots and
quotients of scaled entries (the JAX package's ``atan2``, ``cos`` and
``sin`` round differently on the CPU and the card). The scalar arithmetic
of each step (the reflectors, the shifts, the rotations) runs on numpy
scalars of the element type, one IEEE rounding an operation with a
correctly rounded square root, which PyTorch's CPU ``sqrt`` is not in
every build; the matrix updates are PyTorch products and sums of tensors
and such scalars, which round alike on the CPU and the card.
"""
from __future__ import annotations

import numpy as np
import torch

from faer_tpu_torch.core import dtypes
from faer_tpu_torch.core.errors import SpectralInfo


def _house3(v1, v2, v3):
    """Branchless 3-vector Householder: ``(tau, u2, u3, beta)`` with
    implicit u = (1, u2, u3) and (I − τ u uᵀ)(v1, v2, v3)ᵀ = (β, 0, 0)ᵀ,
    from the vector scaled by its largest magnitude (the identity, β = v1,
    when the scaled tail squares to 0). Numpy scalars of the element type
    in, out."""
    sc = max(abs(v1), abs(v2), abs(v3))
    if sc == 0:
        sc = type(v1)(1)
    w1, w2, w3 = v1 / sc, v2 / sc, v3 / sc
    tail2 = w2 * w2 + w3 * w3
    nrm = np.sqrt(w1 * w1 + tail2)
    zero = type(v1)(0)
    if tail2 == 0:
        return zero, zero, zero, v1
    bs = -nrm if w1 >= 0 else nrm
    denom = w1 - bs
    return (bs - w1) / bs, w2 / denom, w3 / denom, bs * sc


def _unit_pair(x, y):
    """(x, y)/‖(x, y)‖ from the pair scaled by its larger magnitude; (1, 0)
    for (0, 0). Numpy scalars."""
    one = type(x)(1)
    sc = max(abs(x), abs(y))
    if sc == 0:
        return one, type(x)(0)
    xs, ys = x / sc, y / sc
    r = np.sqrt(xs * xs + ys * ys)
    return xs / r, ys / r


def _standardize_2x2(a, b, c, d):
    """Rotation (cs, sn) standardizing the 2×2 block [[a, b], [c, d]] (numpy
    scalars; faer ``lahqr_schur22`` behavior): after the similarity Gᵀ·B·G
    with G = [[cs, −sn], [sn, cs]], the block is upper triangular (real
    eigenvalues) or has equal diagonal entries with b'·c' < 0 (a complex
    pair). Returns (cs, sn, is_real)."""
    sc = type(a)
    half, one, two = sc(0.5), sc(1), sc(2)
    m = half * (a + d)
    pp = half * (a - d)
    disc = pp * pp + b * c
    if disc >= 0:
        # real eigenvalues: rotate the eigenvector of λ = m + sign(pp)·√disc
        # into e1 (then Gᵀ B G e1 = λ e1: the lower-left entry 0)
        sq = np.sqrt(abs(disc))
        lam = m + (sq if pp >= 0 else -sq)
        return (*_unit_pair(lam - d, c), True)
    # complex pair: equalize the diagonal, cos2θ·(a − d) + sin2θ·(b + c) = 0,
    # with (cos2θ, sin2θ) the unit vector of (b + c, d − a) and θ in
    # (−π/2, π/2] (the JAX package's ½·atan2(d − a, b + c)); cos θ and sin θ
    # by the half-angle formulas, each from the side without cancellation
    c2, s2 = _unit_pair(b + c, d - a)
    if c2 >= 0:
        big = np.sqrt((one + c2) * half)
        return big, s2 / (two * big), False
    small = np.copysign(np.sqrt((one - c2) * half), s2)
    return s2 / (two * small), small, False


class _Problem:
    """One problem of :func:`real_schur_plain`: ``m`` = [Q; H] stacked, so
    that a reflector's columns of Q and of H's top rows are one slice;
    ``sc`` the numpy scalar type of the element type, in which each
    step's scalar arithmetic runs (IEEE, one rounding an operation, as the
    kernel rounds it)."""

    def __init__(self, h, q):
        self.r = q.shape[0]
        self.m = torch.cat([q, h])
        self.h = self.m[self.r:]
        self.sc = np.float32 if h.dtype == torch.float32 else np.float64
        self.eps = self.sc(dtypes.eps(h.dtype))
        self.tiny = self.sc(dtypes.min_positive(h.dtype))

    def get(self, rows, cols):
        """Entries of H as numpy scalars (``rows``/``cols`` ints or slices)."""
        vals = self.h[rows, cols].tolist()
        if isinstance(vals, list):
            return [self.sc(v) for v in vals]
        return self.sc(vals)

    def reflect(self, i: int, k: int, c_from: int, rend: int, tau, u2, u3) -> None:
        """The reflector (I − τ u uᵀ), u = (1, u2[, u3]) on k = 2 or 3
        indices from i: H's rows i.. from column c_from on, then the columns
        i.. of Q and of H's rows 0..rend − 1. In place."""
        cu = torch.tensor([1.0, u2, u3][:k], dtype=self.m.dtype, device=self.m.device)
        tau, u2, u3 = float(tau), float(u2), float(u3)
        rows = self.h[i:i + k, c_from:]
        w = rows[0] + u2 * rows[1]
        if k == 3:
            w = w + u3 * rows[2]
        rows -= tau * (cu[:, None] * w[None, :])
        cols = self.m[:self.r + rend, i:i + k]
        w = cols[:, 0] + u2 * cols[:, 1]
        if k == 3:
            w = w + u3 * cols[:, 2]
        cols -= tau * (w[:, None] * cu[None, :])


def _sweep(p: _Problem, lo: int, hi: int, stall: int) -> int:
    """One Francis double-shift sweep on the unreduced block [lo, hi]
    (hi − lo ≥ 2) of the problem's H, Q's columns rotated alongside, in
    place; returns its chase steps (reflectors)."""
    h, sc, eps = p.h, p.sc, p.eps
    (h11, h12), (h21, h22) = (p.get(hi - 1, slice(hi - 1, hi + 1)),
                              p.get(hi, slice(hi - 1, hi + 1)))
    if stall % 10 == 9:  # exceptional shift (LAPACK dlahqr)
        se = abs(h21) + abs(p.get(hi - 1, hi - 2))
        h11 = sc(0.75) * se + h22
        h12 = sc(-0.4375) * se
        h21 = se
        h22 = sc(0.75) * se + p.get(hi, hi)
    s = h11 + h22
    pr = h11 * h22 - h12 * h21
    # the sweep start: the largest m in (lo, hi − 2] where the bulge's
    # introduction is negligible against H[m, m − 1], else lo
    m0 = lo
    if hi - 2 > lo:
        dv, sdv, supv = h.diagonal(), h.diagonal(-1), h.diagonal(1)
        ms = slice(lo + 1, hi - 1)
        h11m, h22m = dv[ms], dv[lo + 2:hi]
        h21m, h12m, h32m = sdv[ms], supv[ms], sdv[lo + 2:hi]
        v1m = h11m * h11m + h12m * h21m - float(s) * h11m + float(pr)
        v2m = h21m * (h11m + h22m - float(s))
        v3m = h21m * h32m
        # each candidate's vector scaled by its largest magnitude, as LAPACK
        # scales it: both sides of the test are homogeneous in it, and
        # unscaled their products underflow at small ‖H‖
        vm = torch.maximum(torch.maximum(v1m.abs(), v2m.abs()), v3m.abs())
        vm = torch.where(vm == 0, torch.ones_like(vm), vm)
        v1m, v2m, v3m = v1m / vm, v2m / vm, v3m / vm
        cond = (sdv[lo:hi - 2].abs() * (v2m.abs() + v3m.abs())
                <= float(eps) * v1m.abs() * (dv[lo:hi - 2].abs() + h11m.abs() + h22m.abs()))
        hits = torch.nonzero(cond)
        if hits.numel():
            m0 = lo + 1 + int(hits[-1, 0])
    # the first column of H² − sH + pI at the sweep start, scaled
    (a0, b0), (c0, d0) = p.get(m0, slice(m0, m0 + 2)), p.get(m0 + 1, slice(m0, m0 + 2))
    e0 = p.get(m0 + 2, m0 + 1)
    v1 = a0 * a0 + b0 * c0 - s * a0 + pr
    v2 = c0 * (a0 + d0 - s)
    v3 = c0 * e0
    scale = max(max(abs(v1), abs(v2)), max(abs(v3), p.tiny))
    v1, v2, v3 = v1 / scale, v2 / scale, v3 / scale
    for i in range(m0, hi):
        last = i == hi - 1
        k = 2 if last else 3
        if i > m0:  # the bulge below the subdiagonal of column i − 1
            v1, v2, *rest = p.get(slice(i, i + k), i - 1)
            v3 = rest[0] if rest else None
        if last:
            v3 = sc(0)
        tau, u2, u3, beta = _house3(v1, v2, v3)
        if i >= 1:  # the row update starts at column i − 1 ...
            p.reflect(i, k, i - 1, min(i + 3, hi) + 1, tau, u2, u3)
            # ... and the column the reflector clears gets β and exact zeros
            if i > m0:
                h[i, i - 1] = float(beta)
            h[i + 1:i + k, i - 1] = 0.0
        else:
            p.reflect(i, k, 0, min(i + 3, hi) + 1, tau, u2, u3)
    return hi - m0


def _standardize_block(p: _Problem, lo: int) -> None:
    """Standardize the 2×2 diagonal block at (lo, lo) of H by a rotation of
    its rows (from column lo on), its columns (rows 0..lo + 1) and Q's
    columns. In place."""
    h = p.h
    (a, b), (c, d) = p.get(lo, slice(lo, lo + 2)), p.get(lo + 1, slice(lo, lo + 2))
    cs, sn, is_real = _standardize_2x2(a, b, c, d)
    cs, sn = float(cs), float(sn)
    r0, r1 = h[lo, lo:].clone(), h[lo + 1, lo:].clone()
    h[lo, lo:] = cs * r0 + sn * r1
    h[lo + 1, lo:] = -sn * r0 + cs * r1
    cols = p.m[:p.r + lo + 2]  # Q's rows and H's rows 0..lo + 1
    c0, c1 = cols[:, lo].clone(), cols[:, lo + 1].clone()
    cols[:, lo] = cs * c0 + sn * c1
    cols[:, lo + 1] = -sn * c0 + cs * c1
    # triangular exactly when real; equal diagonal when complex
    if is_real:
        h[lo + 1, lo] = 0.0
    else:
        h[lo, lo] = h[lo + 1, lo + 1] = float(p.sc(0.5) * (p.get(lo, lo) + p.get(lo + 1, lo + 1)))


def _negligible_subdiag(h, floor, eps) -> None:
    """Zero every subdiagonal entry of ``h`` at most max(ε·(|d_i| +
    |d_{i+1}|), floor). In place."""
    d = h.diagonal()
    sd = h.diagonal(-1)
    tol = torch.clamp(float(eps) * (d[:-1].abs() + d[1:].abs()), min=float(floor))
    sd.masked_fill_(sd.abs() <= tol, 0.0)


def real_schur_plain(h, q, *, max_sweeps_factor: int = 30):
    """The iteration on one problem in plain PyTorch: ``(t, q, iterations,
    converged, steps)`` for the upper-Hessenberg ``h`` (n, n) and the (r,
    n) ``q`` whose columns absorb the similarity (new tensors; iterations
    and chase steps ints, converged a bool). The CPU route of :func:`real_schur`, and the
    CUDA kernel's twin (module docstring): the matrix updates are PyTorch
    operations, the scalar arithmetic of each step runs on numpy scalars
    of the element type, rounded as the kernel rounds it, without a launch
    an operation."""
    n = h.shape[0]
    if n == 1:
        return h.clone(), q.clone(), 0, True, 0
    p = _Problem(h, q)
    sc, eps = p.sc, p.eps
    smlnum = eps * max(sc(h.abs().amax().item()), p.tiny)
    cap = dtypes.deflation_stall_cap(h.dtype)
    max_iters = max_sweeps_factor * n
    hi, it, stall, steps = n - 1, 0, 0, 0
    while hi >= 1 and it < max_iters:
        _negligible_subdiag(p.h, smlnum * sc(2 ** min(stall // 5, cap)), eps)
        zeros = torch.nonzero(p.h.diagonal(-1)[:hi] == 0)
        lo = int(zeros[-1, 0]) + 1 if zeros.numel() else 0
        nr = hi - lo + 1
        if nr == 1:
            hi -= 1
        elif nr == 2:
            _standardize_block(p, lo)
            hi = lo - 1
        else:
            steps += _sweep(p, lo, hi, stall)
        stall = 0 if nr <= 2 else stall + 1
        it += 1
    # exact zeros below the subdiagonal; then the final negligible pass
    # against the unloosened floor
    t = torch.triu(p.h, -1)
    _negligible_subdiag(t, smlnum, eps)
    return t, p.m[:p.r].clone(), it, hi < 1, steps


def real_schur(h, q, *, max_sweeps_factor: int = 30):
    """Real Schur form of the upper-Hessenberg ``h``: ``(t, q, info)`` with
    A = Q T Qᵀ for A = q h qᵀ, T quasi-triangular (1×1 and 2×2 diagonal
    blocks, each 2×2 standardized). On a CUDA tensor one launch of the
    ``real_schur`` kernel runs the whole iteration, with nothing read on
    the host; on a CPU tensor :func:`real_schur_plain` runs."""
    from faer_tpu_torch.ops.kernels.real_schur import real_schur_batched

    n = h.shape[0]
    sizes = torch.full((1,), n, dtype=torch.int32, device=h.device)
    t, qo, its, conv, _ = real_schur_batched(h.reshape(1, n, n).contiguous(),
                                             q.reshape(1, *q.shape).contiguous(), sizes,
                                             max_sweeps_factor=max_sweeps_factor)
    return t[0], qo[0], SpectralInfo(converged=conv[0], iterations=its[0])


def schur_eigenvalues_pair(t):
    """Eigenvalues of a real quasi-triangular Schur ``t`` as ``(re, im)``
    real tensors (faer ``lahqr_eig22``, ``real_schur.rs:418``): a 2×2
    block with a complex pair gives m ± i·√|disc|, top row +."""
    n = t.shape[0]
    d = t.diagonal()
    if n == 1:
        return d.clone(), torch.zeros_like(d)
    sd, sup = t.diagonal(-1), t.diagonal(1)
    m = 0.5 * (d[:-1] + d[1:])
    pp = 0.5 * (d[:-1] - d[1:])
    disc = pp * pp + sup * sd
    sq = disc.abs().sqrt()
    blk = sd != 0
    z = torch.zeros(1, dtype=t.dtype, device=t.device)
    f = torch.zeros(1, dtype=torch.bool, device=t.device)
    is_top, is_bot = torch.cat([blk, f]), torch.cat([f, blk])
    m_t, m_b = torch.cat([m, z]), torch.cat([z, m])
    sq_t, sq_b = torch.cat([sq, z]), torch.cat([z, sq])
    disc_t, disc_b = torch.cat([disc, z]), torch.cat([z, disc])
    wr = torch.where(is_top, torch.where(disc_t >= 0, m_t + sq_t, m_t),
                     torch.where(is_bot, torch.where(disc_b >= 0, m_b - sq_b, m_b), d))
    wi = torch.where(is_top & (disc_t < 0), sq_t,
                     torch.where(is_bot & (disc_b < 0), -sq_b, torch.zeros_like(d)))
    return wr, wi
