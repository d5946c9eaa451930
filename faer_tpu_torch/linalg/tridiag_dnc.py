"""Divide & conquer symmetric tridiagonal eigensolver (counterpart of
``faer_tpu/linalg/tridiag_dnc.py``).

faer ``divide_and_conquer`` (``evd/tridiag_evd.rs:608``): recursion over
halves down to leaves of ``_LEAF`` = 64, which take the QR iteration. The
port forms every leaf's input up front (the tears' corrections at each
split point, the same subtractions the recursion makes, each on its own
entry) and solves all the leaves in one launch of the batched QR kernel
(``tridiag_qr_batched``, counted under ``tridiag_sweep``), then merges
bottom-up in the recursion's order. Each merge solves
the rank-one-update eigenproblem ``D + ρ z zᵀ``: all secular roots at once by
a 64-step log-coordinate bisection, Gu–Eisenstat pair deflation, the Löwner
formula for the vectors, and one block-diagonal back-transform GEMM pair.

Precision: the JAX package runs the secular solve and the Löwner
reconstruction in f64 whenever JAX has x64 on (``tridiag_dnc.py:143``),
which is how its tests run. The H100 runs f64 natively, so the port always
runs that part in f64, with the same promotions (the tear vector and the
pair deflation stay in the input dtype, as there), and casts the vectors
back to f32 before the back-transform products. The reference's ``hi``
flag (HIGHEST precision for the top merge's products) has no counterpart:
every f32 product of the port runs in full FP32.

The reference's two sequential scans are closed forms here: the deflation
carry is z_j unless pair j−1 was close, then 0; and the ``undefl`` loop of
row rotations is a rotation chain applied to rows in descending order.
"""
from __future__ import annotations

import functools

import torch

from faer_tpu_torch.core import dtypes
from faer_tpu_torch.core.errors import SpectralInfo
from faer_tpu_torch.linalg.tridiag_evd import _apply_rotation_chain_rows
from faer_tpu_torch.ops.kernels.sweep import tridiag_qr_batched
from faer_tpu_torch.ops.matmul import matmul

_LEAF = 64
_F64 = torch.float64


def _suffix_min(x):
    return torch.flip(torch.cummin(torch.flip(x, dims=[0]), dim=0).values, dims=[0])


def _next_active(d, active, big):
    """Per root i: the next active pole above pole i (``upper``, ``big`` for
    the top root), its index ``jhat`` (n if none), as the reference's
    ``associative_scan(minimum)`` and ``searchsorted`` give them."""
    inf = torch.tensor(float("inf"), dtype=d.dtype, device=d.device)
    sufmin = _suffix_min(torch.where(active, d, inf))
    nxt = torch.cat([sufmin[1:], inf.reshape(1)])
    jhat = torch.searchsorted(d, nxt, side="left")
    upper = torch.where(torch.isinf(nxt), big, nxt)
    return upper, jhat


def _bisect(f_lo, f_hi, ones, n_iter: int):
    """The two log-coordinate bisections of the secular solves: ``t = 2^{−s}``
    off the lower pole (f_lo decreasing in s) and ``u = 2^{−s}`` off the
    upper one (f_hi increasing in s). Returns (t, u, use_lo)."""
    s_max = 1100.0  # past the f64 subnormals
    lo_l, hi_l = ones.clone(), ones * s_max
    lo_h, hi_h = ones.clone(), ones * s_max
    for _ in range(n_iter):
        mid_l = 0.5 * (lo_l + hi_l)
        pos = f_lo(2.0 ** (-mid_l)) > 0
        lo_l, hi_l = torch.where(pos, mid_l, lo_l), torch.where(pos, hi_l, mid_l)
        mid_h = 0.5 * (lo_h + hi_h)
        neg = f_hi(2.0 ** (-mid_h)) < 0
        lo_h, hi_h = torch.where(neg, mid_h, lo_h), torch.where(neg, hi_h, mid_h)
    t = 2.0 ** (-0.5 * (lo_l + hi_l))
    u = 2.0 ** (-0.5 * (lo_h + hi_h))
    return t, u, f_lo(0.5 * ones) > 0  # root below its gap's midpoint


def _secular_solve(d, z2, rho, n_iter: int = 64):
    """Roots of ``f(λ) = 1 + ρ Σ z2_j/(d_j − λ)`` with ρ > 0, for ``d``
    (f64, ascending, strict gaps) in gap-local log coordinates (LAPACK
    dlaed4 style; the reference's docstring gives the reasoning). Returns
    ``(lam, diff)`` with ``diff[j, i] = d_j − λ_i`` in shifted-exact form."""
    n = d.shape[0]
    eps = dtypes.eps(d.dtype)
    active = z2 > 0  # a z_j = 0 pole is deflated: its root is d_j
    z2d = z2.to(d.dtype)
    rho_d = rho.to(d.dtype)
    # top-root bound with 2× slack
    big = d[-1] + (2 * rho * z2.sum()).to(d.dtype) + eps
    upper, jhat = _next_active(d, active, big)
    g = upper - d
    delta_lo = d[:, None] - d[None, :]
    delta_hi = d[:, None] - upper[None, :]
    idx = torch.arange(n, device=d.device)
    eye0 = idx[:, None] == idx[None, :]
    pin_hi = idx[:, None] == jhat[None, :]
    zdead = (z2 == 0)[:, None]

    # the root's own gap endpoints are pinned to ∓t·g directly (−(t·g) keeps
    # IEEE −0 when t·g underflows)
    def denom_lo(t):
        tg = t * g
        return torch.where(eye0, (-tg)[None, :].expand(n, n), delta_lo - tg[None, :])

    def denom_hi(u):
        ug = u * g
        return torch.where(pin_hi, ug[None, :].expand(n, n), delta_hi + ug[None, :])

    def f_of(denom):
        # dead poles have numerator 0: guard their 0/0
        denom = torch.where(zdead & (denom == 0), torch.ones_like(denom), denom)
        return 1.0 + rho_d * (z2d[:, None] / denom).sum(dim=0)

    t, u, use_lo = _bisect(lambda t: f_of(denom_lo(t)), lambda u: f_of(denom_hi(u)),
                           torch.ones_like(d), n_iter)
    lam = torch.where(use_lo, d + t * g, upper - u * g)
    diff = torch.where(use_lo[None, :], denom_lo(t), denom_hi(u))
    lam = torch.where(active, lam, d)
    diff = torch.where(active[None, :], diff, delta_lo)
    return lam, diff


def _pair_deflation(z_s, close):
    """Gu–Eisenstat pair deflation of the sorted tear vector: for each close
    pair (j, j+1) a rotation moves z_{j+1} onto z_j. The reference's scan
    carries z_j unless pair j−1 was close, in which case 0; in closed form
    the carry is ``where(close_{j−1}, 0, z_j)``. Returns (z', c, s) with the
    rotations (identity off close pairs) for ``_apply_rotation_chain_rows``.
    r is ``hypot``, not the reference's ``sqrt(zc² + z²)``: PyTorch keeps
    f32 subnormals, where XLA flushes them, so below about 1e-19 the squares
    lose their relative accuracy and (c, s) would stop being a rotation."""
    cl = close[:-1]
    prev = torch.cat([cl.new_zeros(1), cl[:-1]])
    zc = torch.where(prev, torch.zeros_like(z_s[:-1]), z_s[:-1])
    z_next = z_s[1:]
    r = torch.hypot(zc, z_next)
    one = torch.ones_like(r)
    safe = torch.where(r == 0, one, r)
    c = torch.where(cl, torch.where(r == 0, one, zc / safe), one)
    s = torch.where(cl, torch.where(r == 0, 0.0 * one, z_next / safe), 0.0 * one)
    z_head = torch.where(cl, r, zc)
    z_last = torch.where(cl[-1:], torch.zeros_like(z_s[-1:]), z_s[-1:])
    return torch.cat([z_head, z_last]), c, s


def _log_abs(x):
    return torch.log(torch.abs(x))


def _merge(d1, q1, d2, q2, beta, hi: bool = False):
    """Eigen of ``blkdiag(T1, T2) + β (e_k + e_{k+1})(e_k + e_{k+1})ᵀ`` from
    the sub-solutions (the standard rank-one-tear formulation): ``(w, v)``.
    The reference's eigenvalues-only mode of this function is never called
    (its recursion always merges vectors) and has no counterpart."""
    n1, n2 = d1.shape[0], d2.shape[0]
    n = n1 + n2
    out_dt = d1.dtype
    dev = d1.device
    eps = dtypes.eps(_F64)
    # z = [last row of Q1, first row of Q2]: the tear vector in eigenbasis
    z = torch.cat([q1[n1 - 1, :], q2[0, :]])
    d = torch.cat([d1, d2])
    rho = beta
    # for ρ < 0 solve the mirrored problem −(D + ρ z zᵀ) = (−D) + |ρ| z zᵀ
    pos = rho >= 0
    d_eff = torch.where(pos, d, -d)
    order = torch.argsort(d_eff, stable=True)
    d_s = d_eff[order]
    z_s = z[order]
    scale = torch.clamp(d_s.abs().max().to(_F64), min=1.0)
    min_gap = eps * scale * 8
    tol_d = eps * scale * 64
    close = torch.cat([(d_s[1:] - d_s[:-1]).to(_F64) <= tol_d,
                       torch.zeros(1, dtype=torch.bool, device=dev)])
    z_s, c_defl, s_defl = _pair_deflation(z_s, close)
    z2 = z_s * z_s
    # spread ONLY the gaps below min_gap (cummax keeps separated poles exact)
    ramp = min_gap * torch.arange(n, dtype=_F64, device=dev)
    d_s = torch.cummax(d_s.to(_F64) - ramp, dim=0).values + ramp
    rho_a = rho.abs()
    lam, diff = _secular_solve(d_s, z2, rho_a)  # diff[j, i] = d_j − λ_i
    w = torch.where(pos, lam, -lam).to(out_dt)

    # Löwner / Gu–Eisenstat ẑ, all in log space with a per-column max-log
    # shift: |ẑ_j|² = ∏_i (λ_i − d_j) / (ρ ∏_{i≠j} (d_i − d_j)), and
    # u_ji = ẑ_j / (d_j − λ_i)
    dist = diff.abs()
    near_j = torch.argmin(dist, dim=0)
    near_d = dist.min(dim=0).values
    deflated = near_d == 0  # exact collapse: the vector is e_j
    safe = torch.where(diff == 0, torch.ones_like(diff), diff)
    log_diff = _log_abs(safe)
    diff_d = d_s[None, :] - d_s[:, None]  # (j, i): d_i − d_j
    eye = torch.eye(n, dtype=torch.bool, device=dev)
    log_num = log_diff.sum(dim=1)
    log_den = torch.where(eye, 0.0, _log_abs(torch.where(eye, 1.0, diff_d))).sum(dim=1)
    log_rho = torch.log(torch.where(rho_a == 0, torch.ones_like(rho_a), rho_a))
    log_zhat = 0.5 * (log_num - log_den - log_rho.to(_F64))
    zsgn = torch.where(z_s >= 0, 1.0, -1.0).to(_F64)
    sgn_u = zsgn[:, None] * torch.where(safe >= 0, 1.0, -1.0).to(_F64)
    log_u = log_zhat[:, None] - log_diff
    u = sgn_u * torch.exp(log_u - log_u.max(dim=0).values[None, :])
    onehot = torch.arange(n, device=dev)[:, None] == near_j[None, :]
    # a pole that absorbed an exact collapse has ẑ_j = 0: zero its row, then
    # restore the collapsed columns' e_j entries
    row_defl = (onehot & deflated[None, :]).any(dim=1)
    u = torch.where(row_defl[:, None], 0.0, u)
    u = torch.where(deflated[None, :], onehot.to(_F64), u)
    norms = torch.sqrt((u * u).sum(dim=0))
    u = u / torch.where(norms == 0, 1.0, norms)[None, :]
    # undo the pair-deflation rotations on rows, j descending
    u = _apply_rotation_chain_rows(u, c_defl, s_defl)
    # undo the sort permutation on rows, then back-transform with blkdiag(Q1, Q2)
    inv = torch.argsort(order)
    u = u[inv, :].to(out_dt)
    # the top-level merge (hi) pins full-FP32 back-transforms, as the
    # reference does (tridiag_dnc.py:257-259)
    prec = "highest" if hi else None
    v = torch.cat([matmul(None, q1, u[:n1], precision=prec),
                   matmul(None, q2, u[n1:], precision=prec)], dim=0)
    srt = torch.argsort(w, stable=True)
    return w[srt], v[:, srt]


def _host_ints(values, device):
    """An int64 tensor of ``values`` on ``device``, copied from pinned memory
    without a host sync."""
    t = torch.tensor(values, dtype=torch.int64)
    if device.type == "cuda":
        t = t.pin_memory().to(device, non_blocking=True)
    return t


def _tear_plan(n: int, leaf: int = _LEAF):
    """The recursion's halving of [0, n): the leaves ``(start, size)`` left
    to right, and the split points p (the first row of the right half)."""
    leaves, splits = [], []

    def rec(start, size):
        if size <= leaf:
            leaves.append((start, size))
            return
        k = size // 2
        splits.append(start + k)
        rec(start, k)
        rec(start + k, size - k)

    rec(0, n)
    return leaves, splits


@functools.lru_cache(maxsize=None)
def _plan_tensors(n: int, device):
    """``_tear_plan(n)`` and its index tensors on ``device`` (split points,
    leaf starts, leaf sizes as int32), made once per (n, device): later
    calls, and a CUDA graph's capture, copy nothing from the host."""
    leaves, splits = _tear_plan(n)
    starts, sizes = zip(*leaves)
    packed = _host_ints([*splits, *starts, *sizes], device)
    ns, nl = len(splits), len(leaves)
    return (leaves, packed[:ns], packed[ns:ns + nl], packed[ns + nl:].to(torch.int32))


def _leaf_inputs(d, e):
    """Every leaf's (d, e), padded into (B, nmax) and (B, nmax − 1), and
    their sizes (int32 (B,)): the tear of split point p takes e[p−1] off
    d[p−1] and d[p], as ``tridiag_evd_dnc``'s recursion does; no entry is
    an end of two leaves (leaves have more than one row), so each is
    corrected once, by the same subtraction, to the same bits."""
    n = d.shape[0]
    leaves, splits, starts, sizes = _plan_tensors(n, d.device)
    nmax = max(size for _, size in leaves)
    d_torn = d.clone()
    beta = e[splits - 1]
    d_torn[splits - 1] -= beta
    d_torn[splits] -= beta
    j = torch.arange(nmax, device=d.device)
    idx = (starts[:, None] + j[None, :]).clamp(max=n - 1)
    dl = torch.where(j[None, :] < sizes[:, None], d_torn[idx], 0.0)
    je = j[:nmax - 1]
    idx_e = (starts[:, None] + je[None, :]).clamp(max=n - 2)
    el = torch.where(je[None, :] < sizes[:, None] - 1, e[idx_e], 0.0)
    return dl, el, sizes


def _leaf_stage(d, e):
    """Every leaf solved in one batched launch: ``(w, z, info, leaves)``,
    leaf b's ascending eigenvalues ``w[b, :size]`` and eigenvectors
    ``z[b, :size, :size]``, ``leaves`` the (start, size) plan. Reads
    nothing on the host."""
    dl, el, sizes = _leaf_inputs(d, e)
    z, its, conv, _ = tridiag_qr_batched(dl, el, sizes)
    nmax = dl.shape[1]
    pad = torch.arange(nmax, device=d.device)[None, :] >= sizes[:, None]
    order = torch.argsort(torch.where(pad, float("inf"), dl), dim=1, stable=True)
    w = torch.gather(dl, 1, order)
    z = torch.gather(z, 2, order[:, None, :].expand(-1, nmax, -1))
    info = SpectralInfo(converged=conv.all(), iterations=its.sum(dtype=torch.int32))
    return w, z, info, _plan_tensors(d.shape[0], d.device)[0]


def tridiag_evd_dnc(d, e, *, want_vectors: bool = True, hi: bool = True):
    """D&C eigendecomposition of tridiag(d, e): ``(w, z, info)``."""
    from faer_tpu_torch.linalg.tridiag_evd import tridiag_evd

    n = d.shape[0]
    if n <= _LEAF:
        return tridiag_evd(d, e, want_vectors=want_vectors)
    w_leaf, z_leaf, info, leaves = _leaf_stage(d, e)
    next_leaf = iter(range(len(leaves)))

    def merge(size, start, top):
        # the recursion's order: left half, right half, then their merge
        if size <= _LEAF:
            b = next(next_leaf)
            return w_leaf[b, :size], z_leaf[b, :size, :size]
        k = size // 2
        w1, q1 = merge(k, start, False)
        w2, q2 = merge(size - k, start + k, False)
        return _merge(w1, q1, w2, q2, e[start + k - 1], top)

    w, v = merge(n, 0, hi)
    return w, (v if want_vectors else None), info
