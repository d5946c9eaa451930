"""Eigenvectors of a Schur form (counterpart of
``faer_tpu/linalg/eigvec.py``).

faer's shifted (quasi-)triangular back-substitution
(``evd/mod.rs:670-882``): column k of V solves (T − λ_k I) x = 0 with the
components below λ_k's own block pinned. Every eigenvector is solved at
once, bottom-up, one row (or one 2×2 block's pair of rows) a step: each
step is one product of T's rows with the whole batch of eigenvectors.
:func:`triangular_eigenvectors` takes the upper-triangular complex Schur
form, in its own dtype; the real quasi-triangular form runs in real
arithmetic with (re, im) pairs. The pencil forms solve the homogeneous
(β S − α T) y = 0 the same way: :func:`triangular_generalized_eigenvectors`
for the complex QZ's upper-triangular (S, T), in their own dtype, and
:func:`quasi_triangular_generalized_eigenvectors_pair` for the real QZ's
quasi-triangular S, in real arithmetic with (re, im) pairs.
"""
from __future__ import annotations

import torch

from faer_tpu_torch.core import dtypes
from faer_tpu_torch.ops.matmul import matmul


def _cdiv2(nr, ni, dr, di):
    """(nr + i·ni) / (dr + i·di), componentwise on real tensors."""
    d2 = dr * dr + di * di
    return (nr * dr + ni * di) / d2, (ni * dr - nr * di) / d2


def triangular_eigenvectors(t):
    """Right eigenvectors of the upper-triangular ``t`` (complex or real),
    each column of unit 2-norm (``faer_tpu/linalg/eigvec.py:22-45``): the
    bottom-up scan, each step one product of T's row j with the whole batch
    X, x_j = −(T[j, :]·X)/(T[j, j] − λ_k) for the eigenvectors k > j, the
    denominator clamped to the real floor ε·max(‖T‖_max, 1) where its
    magnitude is below it; X starts as the identity."""
    n = t.shape[0]
    dt, dev = t.dtype, t.device
    rdt = dtypes.real_dtype_of(dt)
    diag = t.diagonal()
    floor = (dtypes.eps(dt) * torch.clamp(t.abs().amax(), min=1.0)).to(rdt)
    ks = torch.arange(n, device=dev)
    x = torch.eye(n, dtype=dt, device=dev)
    for j in range(n - 2, -1, -1):  # row n − 1 commits no eigenvector
        rhs = -matmul(None, t[j:j + 1], x)[0]
        den = t[j, j] - diag
        den = torch.where(den.abs() < floor, floor.to(dt), den)
        x[j] = torch.where(ks > j, rhs / den, x[j])
    norms = torch.linalg.vector_norm(x, dim=0)
    return x / norms[None, :]


def triangular_generalized_eigenvectors(s, t, alpha, beta):
    """Right eigenvectors of the upper-triangular pencil (``s``, ``t``)
    with eigenvalues as (α, β) pairs (the complex QZ's diagonals), each
    column of unit 2-norm (``faer_tpu/linalg/qz_cpair.py:326-364``,
    ``_gen_eigvec_scan``): column k solves the homogeneous
    (β_k S − α_k T) y = 0 with y_k = 1 and y_j = 0 below k, so an infinite
    eigenvalue (β = 0) gives a null direction of T. Every eigenvector is
    solved at once by a bottom-up scan, each step two products of S's and
    T's row j with the whole batch Y: y_j = (α_k·T[j, :]·Y − β_k·S[j, :]·Y)
    / (β_k S_jj − α_k T_jj) for k > j, the denominator clamped to the real
    floor ε·max(‖(S, T)‖_max, 1) where its magnitude is below it."""
    n = s.shape[0]
    dt, dev = s.dtype, s.device
    rdt = dtypes.real_dtype_of(dt)
    floor = (dtypes.eps(dt) * torch.clamp(torch.maximum(s.abs().amax(), t.abs().amax()),
                                          min=1.0)).to(rdt)
    ks = torch.arange(n, device=dev)
    sd, td = s.diagonal(), t.diagonal()
    y = torch.eye(n, dtype=dt, device=dev)
    for j in range(n - 2, -1, -1):  # row n − 1 commits no eigenvector
        rhs = alpha * matmul(None, t[j:j + 1], y)[0] - beta * matmul(None, s[j:j + 1], y)[0]
        den = beta * sd[j] - alpha * td[j]
        den = torch.where(den.abs() < floor, floor.to(dt), den)
        y[j] = torch.where(ks > j, rhs / den, y[j])
    norms = torch.linalg.vector_norm(y, dim=0)
    return y / norms[None, :]


def quasi_triangular_eigenvectors_pair(t, wr, wi):
    """Right eigenvectors of the real quasi-triangular Schur ``t`` with
    eigenvalues ``wr + i·wi``, as real ``(Vr, Vi)``: column k of Vr + i·Vi
    satisfies T v ≈ (wr_k + i·wi_k) v, conjugate pairs give conjugate
    columns, each of unit 2-norm. faer ``evd/mod.rs:670-882`` for the real
    path."""
    n = t.shape[0]
    dt, dev = t.dtype, t.device
    eps = dtypes.eps(dt)
    floor = eps * torch.maximum(t.abs().amax(), torch.ones((), dtype=dt, device=dev))
    zero_n = torch.zeros(n, dtype=dt, device=dev)
    sd = zero_n.clone()
    sup = zero_n.clone()
    if n > 1:
        sd[:n - 1] = t.diagonal(-1)
        sup[:n - 1] = t.diagonal(1)
    pair_top = sd != 0  # rows (j, j+1) form a 2×2 block
    pair_bot = torch.cat([torch.zeros(1, dtype=torch.bool, device=dev), pair_top[:-1]])
    ks = torch.arange(n, device=dev)
    # the first row of eigenvalue k's own block
    start = torch.where(pair_bot, ks - 1, ks)
    diag = t.diagonal()
    # seeds: 1×1 → e_k; the 2×2 block (m, m+1) with λ = a ± i·b →
    # (t[m, m+1], λ − t[m, m]) on rows (m, m+1)
    xr = torch.zeros((n + 1, n), dtype=dt, device=dev)  # row n: padding
    xi = torch.zeros((n + 1, n), dtype=dt, device=dev)
    in_pair = pair_top[start]
    xr[start, ks] = torch.where(in_pair | pair_bot[ks], sup[start], torch.ones_like(zero_n))
    row2 = torch.where(in_pair, start + 1, start)
    xr[row2, ks] += torch.where(in_pair, wr - diag[start], zero_n)
    xi[row2, ks] += torch.where(in_pair, wi, zero_n)

    tp = torch.zeros((n + 1, n), dtype=dt, device=dev)
    tp[:n] = t
    dfloor = floor * floor
    for j in range(n - 1, -1, -1):
        j1 = min(j + 1, n)
        jc = min(j + 1, n - 1)
        rows = tp[[j, j1]]  # (2, n)
        rhs_r = -matmul(None, rows, xr[:n])
        rhs_i = -matmul(None, rows, xi[:n])
        rhs0r, rhs1r = rhs_r[0], rhs_r[1]
        rhs0i, rhs1i = rhs_i[0], rhs_i[1]
        # singleton: x_j = rhs_j / (t_jj − λ)
        d0r = tp[j, j] - wr
        d0i = -wi
        small = torch.sqrt(d0r * d0r + d0i * d0i) < floor
        d0r = torch.where(small, floor, d0r)
        d0i = torch.where(small, zero_n, d0i)
        sing_r, sing_i = _cdiv2(rhs0r, rhs0i, d0r, d0i)
        # 2×2 pair: complex Cramer on rows (j, j+1)
        p11r, p11i = tp[j, j] - wr, -wi
        p22r, p22i = tp[j1, jc] - wr, -wi
        p12, p21 = tp[j, jc], tp[j1, j]
        detr = p11r * p22r - p11i * p22i - p12 * p21
        deti = p11r * p22i + p11i * p22r
        bad = torch.sqrt(detr * detr + deti * deti) < dfloor
        detr = torch.where(bad, dfloor, detr)
        deti = torch.where(bad, zero_n, deti)
        n0r = rhs0r * p22r - rhs0i * p22i - p12 * rhs1r
        n0i = rhs0r * p22i + rhs0i * p22r - p12 * rhs1i
        n1r = p11r * rhs1r - p11i * rhs1i - p21 * rhs0r
        n1i = p11r * rhs1i + p11i * rhs1r - p21 * rhs0i
        pj_r, pj_i = _cdiv2(n0r, n0i, detr, deti)
        pj1_r, pj1_i = _cdiv2(n1r, n1i, detr, deti)
        is_top, is_bot = pair_top[j], pair_bot[j]
        solve = (j < start) & ~is_bot  # the eigenvectors this row commits
        xr[j] = torch.where(solve, torch.where(is_top, pj_r, sing_r), xr[j])
        xi[j] = torch.where(solve, torch.where(is_top, pj_i, sing_i), xi[j])
        pair = solve & is_top
        xr[j1] = torch.where(pair, pj1_r, xr[j1])
        xi[j1] = torch.where(pair, pj1_i, xi[j1])
    xr, xi = xr[:n], xi[:n]
    norms = torch.sqrt((xr * xr + xi * xi).sum(dim=0))
    norms = torch.where(norms == 0, torch.ones_like(norms), norms)
    return xr / norms[None, :], xi / norms[None, :]


def quasi_triangular_generalized_eigenvectors_pair(s, t, ar, ai, be):
    """Right eigenvectors of the real quasi-triangular pencil (S, T) (S
    quasi-triangular, T upper triangular) with eigenvalues as (α_re, α_im,
    β) triples (``qz_real.qz_eigenvalues_pair``), as real ``(Yr, Yi)``:
    column k of Yr + i·Yi solves the homogeneous (β_k S − α_k T) y = 0, so an
    infinite eigenvalue (β = 0) gives a null direction of T; each column of
    unit 2-norm (``faer_tpu/linalg/eigvec.py:160``). Every eigenvector is
    solved at once, bottom-up, one row (or one 2×2 block's pair of rows) a
    step, with a per-vector floor ε·max(β‖S‖ + |α|‖T‖, 1) on the pivots and
    Cramer's rule on a 2×2 block."""
    n = s.shape[0]
    dt, dev = s.dtype, s.device
    eps = dtypes.eps(dt)
    amag = torch.sqrt(ar * ar + ai * ai)
    floor = eps * torch.clamp(be * s.abs().amax() + amag * t.abs().amax(), min=1.0)
    zero_n = torch.zeros(n, dtype=dt, device=dev)
    sd, ssup, tsup = zero_n.clone(), zero_n.clone(), zero_n.clone()
    if n > 1:
        sd[:n - 1] = s.diagonal(-1)
        ssup[:n - 1] = s.diagonal(1)
        tsup[:n - 1] = t.diagonal(1)
    pair_top = sd != 0  # rows (j, j+1) form a 2×2 block
    pair_bot = torch.cat([torch.zeros(1, dtype=torch.bool, device=dev), pair_top[:-1]])
    ks = torch.arange(n, device=dev)
    start = torch.where(pair_bot, ks - 1, ks)  # the first row of k's own block
    # seeds: 1×1 → e_k; the 2×2 block (m, m+1) → (P12, −P11), P = β S − α T
    # on the block (a null vector of the singular 2×2 pencil)
    sdiag, tdiag = s.diagonal(), t.diagonal()
    in_pair = pair_top[start]
    xr = torch.zeros((n + 1, n), dtype=dt, device=dev)  # row n: padding
    xi = torch.zeros((n + 1, n), dtype=dt, device=dev)
    xr[start, ks] = torch.where(in_pair, be * ssup[start] - ar * tsup[start],
                                torch.ones_like(zero_n))
    xi[start, ks] = torch.where(in_pair, -ai * tsup[start], zero_n)
    row2 = torch.where(in_pair, start + 1, start)
    xr[row2, ks] += torch.where(in_pair, -(be * sdiag[start] - ar * tdiag[start]), zero_n)
    xi[row2, ks] += torch.where(in_pair, -(-ai * tdiag[start]), zero_n)

    sp = torch.zeros((n + 1, n), dtype=dt, device=dev)
    tp = torch.zeros((n + 1, n), dtype=dt, device=dev)
    sp[:n], tp[:n] = s, t
    dfloor = floor * floor
    for j in range(n - 1, -1, -1):
        j1 = min(j + 1, n)
        jc = min(j + 1, n - 1)
        rows_s, rows_t = sp[[j, j1]], tp[[j, j1]]  # (2, n)
        us_r, us_i = matmul(None, rows_s, xr[:n]), matmul(None, rows_s, xi[:n])
        ut_r, ut_i = matmul(None, rows_t, xr[:n]), matmul(None, rows_t, xi[:n])
        # −(β S − α T) x on rows (j, j + 1)
        rhs_r = -(be * us_r - (ar * ut_r - ai * ut_i))
        rhs_i = -(be * us_i - (ar * ut_i + ai * ut_r))
        rhs0r, rhs1r, rhs0i, rhs1i = rhs_r[0], rhs_r[1], rhs_i[0], rhs_i[1]
        # singleton: y_j = rhs_j / (β S_jj − α T_jj)
        d0r = be * sp[j, j] - ar * tp[j, j]
        d0i = -ai * tp[j, j]
        small = torch.sqrt(d0r * d0r + d0i * d0i) < floor
        d0r = torch.where(small, floor, d0r)
        d0i = torch.where(small, zero_n, d0i)
        sing_r, sing_i = _cdiv2(rhs0r, rhs0i, d0r, d0i)
        # 2×2 block: complex Cramer (P21 real: T has no subdiagonal)
        p11r, p11i = be * sp[j, j] - ar * tp[j, j], -ai * tp[j, j]
        p22r, p22i = be * sp[j1, jc] - ar * tp[j1, jc], -ai * tp[j1, jc]
        p12r, p12i = be * sp[j, jc] - ar * tp[j, jc], -ai * tp[j, jc]
        p21 = be * sp[j1, j]
        detr = p11r * p22r - p11i * p22i - p12r * p21
        deti = p11r * p22i + p11i * p22r - p12i * p21
        bad = torch.sqrt(detr * detr + deti * deti) < dfloor
        detr = torch.where(bad, dfloor, detr)
        deti = torch.where(bad, zero_n, deti)
        n0r = rhs0r * p22r - rhs0i * p22i - (p12r * rhs1r - p12i * rhs1i)
        n0i = rhs0r * p22i + rhs0i * p22r - (p12r * rhs1i + p12i * rhs1r)
        n1r = p11r * rhs1r - p11i * rhs1i - p21 * rhs0r
        n1i = p11r * rhs1i + p11i * rhs1r - p21 * rhs0i
        pj_r, pj_i = _cdiv2(n0r, n0i, detr, deti)
        pj1_r, pj1_i = _cdiv2(n1r, n1i, detr, deti)
        is_top = pair_top[j]
        solve = (j < start) & ~pair_bot[j]  # the eigenvectors this row commits
        xr[j] = torch.where(solve, torch.where(is_top, pj_r, sing_r), xr[j])
        xi[j] = torch.where(solve, torch.where(is_top, pj_i, sing_i), xi[j])
        pair = solve & is_top
        xr[j1] = torch.where(pair, pj1_r, xr[j1])
        xi[j1] = torch.where(pair, pj1_i, xi[j1])
    xr, xi = xr[:n], xi[:n]
    norms = torch.sqrt((xr * xr + xi * xi).sum(dim=0))
    norms = torch.where(norms == 0, torch.ones_like(norms), norms)
    return xr / norms[None, :], xi / norms[None, :]
