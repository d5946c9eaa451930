"""Divide & conquer bidiagonal SVD (counterpart of
``faer_tpu/linalg/bidiag_dnc.py``).

faer ``divide_and_conquer`` (``svd/bidiag_svd.rs:1005``), in the LAPACK
``dlasd`` row-tear form: an (m, m+sqre) upper bidiagonal splits at its
middle row; with the sub-SVDs substituted, the merge is the SVD of
``M = [diag pattern] + e₁ zᵀ``, whose singular values solve the unsquared
secular equation ``f(σ) = 1 + Σ z_j²/((d_j − σ)(d_j + σ))`` (dlasd4 style,
the log-coordinate bisection of ``tridiag_dnc``). Right vectors come from
the Gu–Eisenstat ẑ / Löwner formula, left ones from
``u ∝ (−1, d_j ẑ_j/((d_j − σ)(d_j + σ)))``; the O(n³) work is block-diagonal
GEMMs. Leaves of ``_LEAF`` = 64 take the QR iteration: all of them, wide
(the upper halves, (m, m+1)) and square, in one launch of the batched QR
kernel (``bidiag_qr_batched``, counted under ``bidiag_sweep``), which
chases a wide leaf's extra column out first; the merges then run
bottom-up in the recursion's order.

Precision: the JAX package runs the merge's secular part in f64 whenever JAX
has x64 on (``bidiag_dnc.py:190``), as its tests run; the port always does
(the H100 runs f64 natively) and casts the vectors back to f32 before the
back-transform products. Its ``hi`` flag has no counterpart: every f32
product of the port runs in full FP32. The deflation scan and the
``undefl`` row loops are closed forms, as in ``tridiag_dnc``.
"""
from __future__ import annotations

import functools

import torch

from faer_tpu_torch.core import dtypes
from faer_tpu_torch.core.errors import SpectralInfo
from faer_tpu_torch.linalg.tridiag_dnc import (
    _F64,
    _bisect,
    _host_ints,
    _log_abs,
    _next_active,
    _pair_deflation,
)
from faer_tpu_torch.linalg.tridiag_evd import _apply_rotation_chain_rows, _info
from faer_tpu_torch.ops.kernels.sweep import bidiag_qr_batched
from faer_tpu_torch.ops.matmul import matmul

_LEAF = 64


def _secular_solve_svd(d, z2, n_iter: int = 64):
    """Roots of ``f(σ) = 1 + Σ_j z2_j/((d_j − σ)(d_j + σ))`` for ``d``
    ascending ≥ 0 with strict gaps, root i in (d_i, d_{i+1}), bisected in
    log coordinates off the nearer gap endpoint. Returns ``(sig, dms, dps)``
    with ``dms[j, i] = d_j − σ_i`` (shifted-exact) and ``dps[j, i] = d_j + σ_i``."""
    n = d.shape[0]
    eps = dtypes.eps(d.dtype)
    active = z2 > 0  # a z_j = 0 pole is deflated: its root is d_j
    big = d[-1] + 2 * torch.sqrt(z2.sum()) + eps  # Weyl bound, 2× slack
    upper, jhat = _next_active(d, active, big)
    g = upper - d
    delta_lo = d[:, None] - d[None, :]
    delta_hi = d[:, None] - upper[None, :]
    sum_lo = d[:, None] + d[None, :]
    sum_hi = d[:, None] + upper[None, :]
    idx = torch.arange(n, device=d.device)
    eye0 = idx[:, None] == idx[None, :]
    pin_hi = idx[:, None] == jhat[None, :]
    zdead = (z2 == 0)[:, None]

    def dms_lo(t):
        tg = t * g
        return torch.where(eye0, (-tg)[None, :].expand(n, n), delta_lo - tg[None, :])

    def dps_lo(t):
        return sum_lo + (t * g)[None, :]

    def dms_hi(u):
        ug = u * g
        return torch.where(pin_hi, ug[None, :].expand(n, n), delta_hi + ug[None, :])

    def dps_hi(u):
        return sum_hi - (u * g)[None, :]

    def f_of(dms, dps):
        prod = dms * dps
        # dead poles have numerator 0: guard their 0/0
        prod = torch.where(zdead & (prod == 0), torch.ones_like(prod), prod)
        return 1.0 + (z2[:, None] / prod).sum(dim=0)

    t, u, use_lo = _bisect(lambda t: f_of(dms_lo(t), dps_lo(t)),
                           lambda u: f_of(dms_hi(u), dps_hi(u)),
                           torch.ones_like(d), n_iter)
    sig = torch.where(use_lo, d + t * g, upper - u * g)
    dms = torch.where(use_lo[None, :], dms_lo(t), dms_hi(u))
    dps = torch.where(use_lo[None, :], dps_lo(t), dps_hi(u))
    sig = torch.where(active, sig, d)
    dms = torch.where(active[None, :], dms, delta_lo)
    dps = torch.where(active[None, :], dps, sum_lo)
    return sig, dms, dps


def _svd_merge(u1, s1, w1, u2, s2, w2, alpha, beta, sqre: int, hi: bool = False):
    """Combine the sub-SVDs across the torn middle row: in the permuted
    column order [W1-null, σ1…, σ2…(, W2-null)] the merged matrix is
    ``M' = [diag(d) pattern] + e₁ zᵀ`` with d = (0, s1, s2[, 0])."""
    k = s1.shape[0]  # rows of the left sub-block
    m2 = s2.shape[0]  # rows of the right sub-block
    mm = k + 1 + m2  # merged rows
    nt = mm + sqre  # merged columns
    out_dt = s1.dtype
    dev = s1.device
    eps = dtypes.eps(_F64)
    zw1 = alpha * w1[k, :]
    zw2 = beta * w2[0, :]
    z = torch.cat([zw1[k:k + 1], zw1[:k], zw2]).to(_F64)
    dd = torch.cat([z.new_zeros(1), s1.to(_F64), s2.to(_F64), z.new_zeros(sqre)])
    # the row-less zero poles (the z row's and, when wide, the extra
    # column's) sort side by side, ahead of any exact-zero σ of the
    # sub-blocks, so that they always pair-deflate: the extra column's z
    # rotates onto the z row's, as LAPACK dlasd2 rotates it, and its root
    # is the null root. Sorted apart, a zero σ between them, the extra pole
    # kept a tiny z, and the root beside it took a left vector made of its
    # row-less component alone: a zero column of U.
    seq = torch.arange(nt, device=dev)
    if sqre:
        seq = torch.cat([seq[:1], seq[-1:], seq[1:-1]])
    order = seq[torch.argsort(dd[seq], stable=True)]
    d_s = dd[order]
    z_s = z[order]
    # a pole owns a U row iff its unsorted M'-index is a σ row (1..mm−1)
    has_row = (order >= 1) & (order < mm)
    scale = torch.clamp(d_s.max(), min=1.0)
    min_gap = eps * scale * 8
    tol_d = eps * scale * 64
    no = torch.zeros(1, dtype=torch.bool, device=dev)
    close = torch.cat([(d_s[1:] - d_s[:-1]) <= tol_d, no])
    # pair-deflate only poles of the same class (both row-owning or both not)
    close = close & torch.cat([has_row[1:] == has_row[:-1], no])
    z_s, c_defl, s_defl = _pair_deflation(z_s, close)
    z2 = z_s * z_s
    ramp = min_gap * torch.arange(nt, dtype=_F64, device=dev)
    d_s = torch.cummax(d_s - ramp, dim=0).values + ramp
    s_all, dms, dps = _secular_solve_svd(d_s, z2)

    # Gu–Eisenstat ẑ / Löwner vectors in log space, every (d_j² − σ_i²)
    # kept as the product dms·dps
    dist = dms.abs()
    near_j = torch.argmin(dist, dim=0)
    deflated = dist.min(dim=0).values == 0
    safe_m = torch.where(dms == 0, torch.ones_like(dms), dms)
    safe_p = torch.where(dps == 0, torch.ones_like(dps), dps)
    log_diff = _log_abs(safe_m) + _log_abs(safe_p)
    diff_d = d_s[None, :] - d_s[:, None]
    sum_d = d_s[None, :] + d_s[:, None]
    eye = torch.eye(nt, dtype=torch.bool, device=dev)
    log_num = log_diff.sum(dim=1)
    log_den = torch.where(eye, 0.0, _log_abs(torch.where(eye, 1.0, diff_d))
                          + _log_abs(torch.where(eye, 1.0, sum_d))).sum(dim=1)
    log_zhat = 0.5 * (log_num - log_den)  # ρ = 1
    zsgn = torch.where(z_s >= 0, 1.0, -1.0).to(_F64)
    sgn_u = zsgn[:, None] * torch.where(safe_m >= 0, 1.0, -1.0).to(_F64)

    # right vectors: v_ji ∝ ẑ_j / ((d_j − σ_i)(d_j + σ_i))
    log_v = log_zhat[:, None] - log_diff
    v = sgn_u * torch.exp(log_v - log_v.max(dim=0).values[None, :])
    onehot = torch.arange(nt, device=dev)[:, None] == near_j[None, :]
    row_defl = (onehot & deflated[None, :]).any(dim=1)
    v = torch.where(row_defl[:, None], 0.0, v)
    v = torch.where(deflated[None, :], onehot.to(_F64), v)
    vnorm = torch.sqrt((v * v).sum(dim=0))
    v = v / torch.where(vnorm == 0, 1.0, vnorm)[None, :]

    # left vectors: u ∝ (−1 [z row], d_j ẑ_j / ((d_j − σ_i)(d_j + σ_i)))
    log_p_half = torch.where(d_s > 0, torch.log(torch.where(d_s > 0, d_s, 1.0)),
                             -1e30)
    log_ul = log_p_half[:, None] + log_zhat[:, None] - log_diff
    logs = torch.cat([log_ul.new_zeros((1, nt)), log_ul])  # log|−1| = 0
    sgns = torch.cat([-torch.ones((1, nt), dtype=_F64, device=dev), sgn_u])
    ue = sgns * torch.exp(logs - logs.max(dim=0).values[None, :])
    # deflated columns: left vector e_{row of the absorbing pole}, only for
    # poles that own a U row; a root collapsed onto a zero pole keeps the
    # closed-form column (the null direction)
    defl_nz = deflated & has_row[near_j]
    ue[0] = torch.where(defl_nz, 0.0, ue[0])
    ue[1:] = torch.where(row_defl[:, None], 0.0, ue[1:])
    ue[1:] = torch.where(defl_nz[None, :], onehot.to(_F64), ue[1:])
    unorm = torch.sqrt((ue * ue).sum(dim=0))
    ue = ue / torch.where(unorm == 0, 1.0, unorm)[None, :]

    # undo the pair deflation on V's rows and on U's pole rows alike (LAPACK
    # dlasd2 rotates U and Vᵀ by the same G)
    v = _apply_rotation_chain_rows(v, c_defl, s_defl)
    ue_poles = _apply_rotation_chain_rows(ue[1:], c_defl, s_defl)

    # unsort pole rows back to M' order
    inv = torch.argsort(order)
    v = v[inv].to(out_dt)  # (nt, nt): M' column space
    ue_p = ue_poles[inv].to(out_dt)
    # U' rows: row 0 the z row, rows 1..mm−1 the σ poles (the zero poles at
    # 0 and nt−1 own no row; their formula components are exactly 0)
    u_m = torch.cat([ue[0:1].to(out_dt), ue_p[1:mm]])
    # a root collapsed onto a row-less (zero) pole is a null direction:
    # pin σ = 0 so the descending sort puts it last
    s_all = torch.where(deflated & ~has_row[near_j], torch.zeros_like(s_all), s_all)
    srt = torch.argsort(-s_all, stable=True)
    s_all = s_all[srt].to(out_dt)
    u_m = u_m[:, srt][:, :mm]  # wide case: drop the null root's left column
    v = v[:, srt]

    # M' row i ↔ M row rowp[i] = [k, 0..k−1, k+1..mm−1]; columns likewise
    # up to nt; then the block back-transforms
    head = torch.tensor([k], device=dev)
    rowp = torch.cat([head, torch.arange(k, device=dev),
                      torch.arange(k + 1, mm, device=dev)])
    colp = torch.cat([head, torch.arange(k, device=dev),
                      torch.arange(k + 1, nt, device=dev)])
    u_sc = torch.empty_like(u_m)
    u_sc[rowp] = u_m
    v_sc = torch.empty_like(v)
    v_sc[colp] = v
    # the top-level merge (hi) pins full-FP32 back-transforms, as the
    # reference does (bidiag_dnc.py:351-357)
    prec = "highest" if hi else None
    u_out = torch.cat([matmul(None, u1, u_sc[:k], precision=prec), u_sc[k:k + 1],
                       matmul(None, u2, u_sc[k + 1:], precision=prec)])
    w_out = torch.cat([matmul(None, w1, v_sc[:k + 1], precision=prec),
                       matmul(None, w2, v_sc[k + 1:], precision=prec)])
    return u_out, s_all, w_out


def _leaf_plan(m: int, sqre: int, leaf: int = _LEAF):
    """The recursion's split of an (m, m + sqre) bidiagonal: its leaves
    ``(start, rows, sqre)`` left to right. A block of more than ``leaf``
    rows tears at its middle row k: the rows above form a wide (k, k+1)
    block, the rows below keep the block's sqre."""
    leaves = []

    def rec(start, rows, sq):
        if rows <= leaf:
            leaves.append((start, rows, sq))
            return
        k = rows // 2
        rec(start, k, 1)
        rec(start + k + 1, rows - k - 1, sq)

    rec(0, m, sqre)
    return leaves


@functools.lru_cache(maxsize=None)
def _plan_tensors(m: int, sqre: int, device):
    """``_leaf_plan(m, sqre)`` and its leaf starts, sizes (int32) and sqre
    (int32) on ``device``, made once per (m, sqre, device)."""
    leaves = _leaf_plan(m, sqre)
    packed = _host_ints([x for leaf in zip(*leaves) for x in leaf], device)
    nl = len(leaves)
    return (leaves, packed[:nl], packed[nl:2 * nl].to(torch.int32),
            packed[2 * nl:].to(torch.int32))


def _leaf_inputs(d, e, sqre: int):
    """Every leaf's (d, e) of the (m, m + sqre) bidiagonal, padded into
    (B, nmax) each (leaf b's e has rows − 1 + sq entries), their sizes and
    sqre (int32 (B,)): index slices, as ``_dnc``'s recursion cuts them."""
    m = d.shape[0]
    leaves, starts, sizes, sqres = _plan_tensors(m, sqre, d.device)
    nmax = max(rows for _, rows, _ in leaves)
    j = torch.arange(nmax, device=d.device)
    idx = starts[:, None] + j[None, :]
    dl = torch.where(j[None, :] < sizes[:, None], d[idx.clamp(max=m - 1)], 0.0)
    e_pad = torch.cat([e, e.new_zeros(1)])  # a gather target even when e is empty
    el = torch.where(j[None, :] < sizes[:, None] - 1 + sqres[:, None],
                     e_pad[idx.clamp(max=e.shape[0])], 0.0)
    return dl, el, sizes, sqres


def _leaf_stage(d, e, sqre: int):
    """Every leaf of the (m, m + sqre) bidiagonal solved in one batched
    launch: ``(u, s, w, info, leaves)``, leaf b (rows, sq) with
    ``u[b, :rows, :rows]``, descending ``s[b, :rows + sq]`` (a wide leaf's
    last the null root 0) and ``w[b, :rows + sq, :rows + sq]``, ``leaves``
    the (start, rows, sq) plan. Reads nothing on the host."""
    dl, el, sizes, sqres = _leaf_inputs(d, e, sqre)
    nmax = dl.shape[1]
    j = torch.arange(nmax, device=d.device)
    u, w, its, conv, _ = bidiag_qr_batched(dl, el, sizes, sqres)
    # sign fix (σ ≥ 0, flip U's columns) and sort descending; padding last,
    # a wide leaf's extra column (index rows) kept in place after its σ's
    sgn = torch.where(dl < 0, -1.0, 1.0)
    s = dl * sgn
    pad = j[None, :] >= sizes[:, None]
    order = torch.argsort(torch.where(pad, float("inf"), -s), dim=1, stable=True)
    u = torch.gather(u * sgn[:, None, :], 2, order[:, None, :].expand(-1, nmax, -1))
    order_w = torch.cat([order, order.new_full((order.shape[0], 1), nmax)], dim=1)
    w = torch.gather(w, 2, order_w[:, None, :].expand(-1, nmax + 1, -1))
    s = torch.cat([torch.gather(s, 1, order), s.new_zeros((s.shape[0], 1))], dim=1)
    info = SpectralInfo(converged=conv.all(), iterations=its.sum(dtype=torch.int32))
    return u, s, w, info, _plan_tensors(d.shape[0], sqre, d.device)[0]


def _dnc(d, e, sqre: int, hi: bool = False):
    """Solve of the (m, m+sqre) upper bidiagonal B by the recursion's tears:
    ``(u, s, w)``, s descending (m + sqre entries, the last the ≈0 null root
    when sqre = 1), ``B = u @ [diag(s[:m]) | 0] @ wᵀ``."""
    u_leaf, s_leaf, w_leaf, _, leaves = _leaf_stage(d, e, sqre)
    next_leaf = iter(range(len(leaves)))

    def solve(start, rows, sq, top):
        # the recursion's order: upper rows, lower rows, then their merge
        if rows <= _LEAF:
            b = next(next_leaf)
            return (u_leaf[b, :rows, :rows], s_leaf[b, :rows + sq],
                    w_leaf[b, :rows + sq, :rows + sq])
        k = rows // 2
        u1, s1, w1 = solve(start, k, 1, False)
        u2, s2, w2 = solve(start + k + 1, rows - k - 1, sq, False)
        # the merge takes only each sub-block's genuine singular values
        return _svd_merge(u1, s1[:k], w1, u2, s2[:rows - k - 1], w2, d[start + k],
                          e[start + k], sq, top)

    return solve(0, d.shape[0], sqre, hi)


def bidiag_svd_dnc(d, e, *, want_u: bool = True, want_v: bool = True):
    """D&C SVD of the square upper bidiagonal ``B = bidiag(d, e)``:
    ``(s, u, v, info)``, the contract of ``bidiag_svd.bidiag_svd``. Reports
    ``converged=True, iterations=0``, as the reference does."""
    n = d.shape[0]
    # normalize the scale (the secular tolerances assume O(1) entries)
    nrm = d.abs().max()
    if n > 1:
        nrm = torch.maximum(nrm, e.abs().max())
    nrm = torch.where(nrm == 0, torch.ones_like(nrm), nrm)
    u, s, w = _dnc(d / nrm, e / nrm, 0, hi=True)
    return (s * nrm, (u if want_u else None), (w if want_v else None),
            _info(True, 0, d.device))
