"""Cholesky family (counterpart of ``faer_tpu/linalg/cholesky.py``): LLT,
LDLT, pivoted LLT, Bunch–Kaufman LBLT and the LLT and LDLT rank updates.

faer ``cholesky_in_place`` (``llt/factor.rs:67``, ``ldlt/factor.rs:725``),
``llt_pivoting/factor.rs:199``, ``bunch_kaufman/factor.rs:1161``, the
updates of ``llt/update.rs:360`` and ``ldlt/update.rs:376``, and the
solves. Every routine reads the lower triangle (callers mirror through
``Side``) and takes float32, float64, complex64 or complex128 (Hermitian
input, ``A = L Lᴴ``); the dtype picks the route, as the JAX package's
``panel_kernels_enabled`` picks it.

Complex LLT and LDLT (and their solves and inverse) go through the
interleaved real embedding of the JAX package's pair path
(``faer_tpu/linalg/factor_cpair.py:42-107``): each entry becomes the real
2×2 block [[re, −im], [im, re]], a *-algebra isomorphism under which the
factor is unique, so ``chol(embed(C)) = embed(chol(C))`` and
``ldlt(embed(C)) = embed(ldlt(C))``. A complex64 matrix of side n is a
2n float32 problem on the kernel route (``llt_panel`` or ``llt_leaf``
leaves, ``trtri`` in the solves); complex128 runs the float64 body. The
pivoted LLT, LBLT and the rank updates run natively in complex on their
non-kernel bodies, as the JAX package's do (pivoting does not commute with
the embedding).

LLT has three drivers, chosen as the JAX package chooses them
(``cholesky.py:119-175``):

* float32 squares with ``n > block``, ``n % 128 == 0`` and
  ``block % 128 == 0`` take the fused-panel two-level strip driver
  (``_llt_factor_v5``), one ``llt_panel`` kernel call per panel;
* every other float32 square takes the recursive driver
  (``_llt_factor_recursive``): panels of ``block`` columns, each factored
  by halving down to ``llt_leaf`` kernel leaves (``_llt_panel_recursive``),
  the panel TRSM as one product against the panel's triangular inverse and
  a rank-``block`` trailing update;
* float64 takes the same recursive driver with the JAX package's
  non-kernel leaf, ``_panel_llt``, at ``params.recursion_threshold`` (64).

The other factorizations have no kernel in either package: their bodies
are the JAX ones in plain PyTorch (products through the front door, so
cuBLAS on the card), and in float32 they reach the ``trtri`` kernel only
through their triangular solves. Where a JAX body masks a full block in a
``fori_loop``, the port updates the live slice, the same arithmetic on
every entry that changes. Pivots, ranks and counts stay on the device
(``torch.argmax``, index tensors, ``torch.where``); the one host read a
panel is Bunch–Kaufman's, where the JAX body's ``while_loop`` trip count
depends on the data (and one a step of its unblocked form, n ≤ 96).
"""
from __future__ import annotations

import torch

from faer_tpu_torch.core import dtypes
from faer_tpu_torch.core import perm as permod
from faer_tpu_torch.core.config import host_read
from faer_tpu_torch.core.errors import LbltInfo, LdltInfo, LltInfo, ShapeError
from faer_tpu_torch.core.params import (
    LbltParams,
    LdltParams,
    LdltRegularization,
    LltParams,
    LltRegularization,
)
from faer_tpu_torch.ops.kernels.leaf import llt_leaf
from faer_tpu_torch.ops.kernels.llt_panel import llt_panel
from faer_tpu_torch.ops.matmul import matmul
from faer_tpu_torch.ops.triangular import invert_lower_triangular
from faer_tpu_torch.ops.triangular_solve import (
    solve_lower_triangular,
    solve_lower_triangular_adjoint,
    solve_unit_lower_triangular,
    solve_upper_triangular,
)

_BK_ALPHA = (1.0 + 17.0 ** 0.5) / 8.0  # Bunch–Kaufman's growth bound


def _square(a, name: str):
    """``a`` checked: a square float32, float64, complex64 or complex128
    matrix."""
    if a.dim() != 2 or a.shape[0] != a.shape[1]:
        raise ShapeError(f"{name}: needs a square matrix, got {tuple(a.shape)}")
    dtypes.require_field(a, name)
    return a


# ---------------------------------------------------------------------------
# the interleaved real embedding (faer_tpu/linalg/factor_cpair.py:42-66)
# ---------------------------------------------------------------------------

def embed_pair(c):
    """A complex (n, m) matrix → its (2n, 2m) interleaved real embedding,
    entry (i, j) the block [[re, −im], [im, re]] at rows 2i, 2i+1 and
    columns 2j, 2j+1."""
    n, m = c.shape
    re, im = c.real, c.imag
    out = re.new_empty((2 * n, 2 * m))
    out[0::2, 0::2] = re
    out[1::2, 1::2] = re
    out[0::2, 1::2] = -im
    out[1::2, 0::2] = im
    return out


def extract_pair(m2):
    """The complex matrix of an interleaved embedding (its even rows' even
    columns and odd rows' even columns)."""
    return torch.complex(m2[0::2, 0::2], m2[1::2, 0::2])


def _extract_factor(m2):
    """The complex factor (L, or packed L\\D) of an embedded one, its
    diagonal real: the embedding's (2k+1, 2k) entries are the imaginary
    parts of a real diagonal, zero up to rounding."""
    im = m2[1::2, 0::2].clone()
    im.diagonal().zero_()
    return torch.complex(m2[0::2, 0::2], im)


def embed_rhs(b):
    """A complex (n,) or (n, k) right-hand side → the interleaved real
    (2n,) or (2n, k) one."""
    re, im = b.real, b.imag
    out = re.new_empty((2 * b.shape[0],) + tuple(b.shape[1:]))
    out[0::2] = re
    out[1::2] = im
    return out


def extract_rhs(x2):
    return torch.complex(x2[0::2], x2[1::2])


def _counters(a):
    """A zero int32 count and a true flag on ``a``'s device."""
    return (torch.zeros((), dtype=torch.int32, device=a.device),
            torch.ones((), dtype=torch.bool, device=a.device))


def _symmetric_from_lower(a):
    """The full symmetric (Hermitian) matrix of ``a``'s lower triangle, a
    fresh tensor."""
    lo = torch.tril(a)
    return lo + torch.tril(lo, -1).mH


# ---------------------------------------------------------------------------
# LLT
# ---------------------------------------------------------------------------

def llt_factor(a, *, reg: LltRegularization | None = None,
               params: LltParams | None = None):
    """Blocked LLT of the lower triangle of ``a``: returns ``(L, LltInfo)``.
    Complex input factors its real embedding (``L`` complex, real
    diagonal; the regularization count is the embedding's halved, rounded
    up: each complex pivot is two real ones)."""
    _square(a, "llt_factor")
    if a.is_complex():
        l2, info = llt_factor(embed_pair(a), reg=reg, params=params)
        return _extract_factor(l2), LltInfo(
            dynamic_regularization_count=(info.dynamic_regularization_count + 1) // 2,
            success=info.success)
    # the kernels read rows with unit stride: a strided input is copied once
    a = a.contiguous()
    params = params or LltParams.auto(a.dtype, a.shape)
    reg = reg or LltRegularization()
    n = a.shape[0]
    block = params.block_size or (256 if n >= 1024 else 64 if n >= 128 else n)
    if not dtypes.kernel_route(a.dtype):
        return _llt_factor_recursive(a, reg, block,
                                     min(params.recursion_threshold, block))
    if n > block and n % 128 == 0 and block % 128 == 0:
        return _llt_factor_v5(a, reg, block)
    # kernel_leaf: None is unset; clamped to [128, 512], rounded up to 128
    leaf = params.kernel_leaf if params.kernel_leaf is not None else 128
    leaf = min(max(128, -(-leaf // 128) * 128), 512)
    return _llt_factor_recursive(a, reg, block, min(leaf, block))


def _panel_llt(a, reg: LltRegularization):
    """Unblocked LLT of a (b, b) lower block (``cholesky.py:43-70``):
    returns ``(L, count, ok)``; a column a step, the trailing update on
    the live slice."""
    b = a.shape[0]
    a = a.clone(memory_format=torch.contiguous_format)
    count, ok = _counters(a)
    one = a.new_ones(())
    for j in range(b):
        pj = a[j, j]
        needs_reg = pj <= reg.delta
        ok = ok & (pj > 0)
        if reg.epsilon > 0:
            pj = torch.where(needs_reg, reg.epsilon * one, pj)
            count = count + needs_reg.to(torch.int32)
        else:
            pj = torch.where(pj <= 0, one, pj)  # keep finite
        piv = torch.sqrt(pj)
        col = a[j + 1:, j] / piv
        a[j, j] = piv
        a[j + 1:, j] = col
        a[j + 1:, j + 1:].sub_(torch.outer(col, col))
    return torch.tril(a), count, ok


def _llt_panel_recursive(a, reg: LltRegularization, base: int):
    """LLT of a (b, b) block by halving down to leaves of at most ``base``
    columns: ``llt_leaf`` kernel leaves in float32, ``_panel_llt`` in
    float64. Returns ``(L, count, ok)``.

    Only the lower triangle of ``a`` is read, by the leaves as by the
    couplings, so no mirror is needed (the JAX package mirrors because its
    leaf kernel reads rows as columns).
    """
    b = a.shape[0]
    if b <= base:
        if dtypes.kernel_route(a.dtype):
            return llt_leaf(a, eps=reg.epsilon, delta=reg.delta)
        return _panel_llt(a, reg)
    h = (b + 1) // 2
    d1, c1, o1 = _llt_panel_recursive(a[:h, :h], reg, base)
    # SPD: ‖L11⁻¹‖ ≤ √cond(A), so the coupling is one product against the
    # explicit inverse
    l21 = matmul(None, a[h:, :h], invert_lower_triangular(d1, base=h).mT)
    d2, c2, o2 = _llt_panel_recursive(a[h:, h:] - matmul(None, l21, l21.mT), reg, base)
    # in place into a fresh output where the JAX package concatenates
    out = a.new_zeros((b, b))
    out[:h, :h] = d1
    out[h:, :h] = l21
    out[h:, h:] = d2
    return out, c1 + c2, o1 & o2


def _llt_factor_recursive(a, reg: LltRegularization, block: int, base: int):
    """Right-looking over a shrinking trail: per panel, a recursive factor
    of the diagonal block, L21 = A21·L11⁻ᵀ, and a rank-``block`` update.
    Each finished strip is written once into a fresh output."""
    n = a.shape[0]
    l = a.new_zeros((n, n))
    count, ok = _counters(a)
    trail = a
    for k in range(0, n, block):
        bw = min(block, n - k)
        d, c, o = _llt_panel_recursive(trail[:bw, :bw], reg, base)
        count, ok = count + c, ok & o
        l[k:k + bw, k:k + bw] = torch.tril(d)
        if k + bw < n:
            l21 = matmul(None, trail[bw:, :bw],
                         invert_lower_triangular(d, base=bw).mT)
            l[k + bw:, k:k + bw] = l21
            trail = trail[bw:, bw:] - matmul(None, l21, l21.mT)
    return l, LltInfo(dynamic_regularization_count=count, success=ok)


def _llt_factor_v5(a, reg: LltRegularization, block: int):
    """Fused panels plus two-level SYRK-shaped trailing updates
    (``faer_tpu/linalg/cholesky.py:178-234``).

    The trailing matrix is carried as ``ob``-wide column strips holding only
    their rows at and below the diagonal block (``ob = max(block, 1024)``
    for n ≥ 2048). Inside an outer block each panel is one ``llt_panel``
    call plus one product; after an outer block, every later strip gets one
    rank-``ob`` product.
    """
    n = a.shape[0]
    ob = max(block, 1024) if n >= 2048 else block
    starts = list(range(0, n, ob))
    # private copies of the strips: the trailing updates run in place on them
    strips = [a[k:, k:k + ob].clone() for k in starts]
    l = a.new_zeros((n, n))
    count, ok = _counters(a)
    for jj, kk in enumerate(starts):
        obw = strips[jj].shape[1]
        pblock = strips[jj]
        for k in range(0, obw, block):
            bw = min(block, obw - k)
            strip, c, o = llt_panel(pblock[:, :bw], eps=reg.epsilon,
                                    delta=reg.delta)
            count, ok = count + c, ok & o
            w2 = obw - k - bw
            if w2 > 0:
                l21 = strip[bw:]
                # remaining columns of this block: in place on the strip copy
                pblock[bw:, bw:] -= matmul(None, l21, l21[:w2].mT)
                pblock = pblock[bw:, bw:]
            l[kk + k:, kk + k:kk + k + bw] = strip
        lblock = l[kk:, kk:kk + obw]
        for j in range(jj + 1, len(starts)):
            r0 = starts[j] - kk
            wj = strips[j].shape[1]
            strips[j] -= matmul(None, lblock[r0:], lblock[r0:r0 + wj].mT)
    return l, LltInfo(dynamic_regularization_count=count, success=ok)


def llt_solve(l, b):
    """Solve L Lᴴ x = b (faer ``llt/solve.rs:12``); a complex L solves
    through the real embedding."""
    if l.is_complex():
        return extract_rhs(llt_solve(embed_pair(l), embed_rhs(b.to(l.dtype))))
    y = solve_lower_triangular(l, b)
    return solve_lower_triangular_adjoint(l, y)


def llt_inverse(l):
    """A⁻¹ from the LLT factor: ``llt_solve(L, I)``
    (``faer_tpu/linalg/cholesky.py:244-247``)."""
    return llt_solve(l, torch.eye(l.shape[0], dtype=l.dtype, device=l.device))


def llt_reconstruct(l):
    return matmul(None, l, l.mH)


# ---------------------------------------------------------------------------
# LDLT (no pivoting)
# ---------------------------------------------------------------------------

def _panel_ldlt(a, reg: LdltRegularization):
    """Unblocked LDLT of a (b, b) lower block (``cholesky.py:259-286``):
    returns ``(packed, count, ok)``, unit L strictly below the diagonal and
    D on it."""
    b = a.shape[0]
    a = a.clone(memory_format=torch.contiguous_format)
    count, ok = _counters(a)
    one = a.new_ones(())
    for j in range(b):
        dj = a[j, j]
        ok = ok & (dj != 0)
        if reg.epsilon > 0:
            needs = dj.abs() <= reg.delta
            sign = torch.where(dj < 0, -one, one)
            dj = torch.where(needs, sign * reg.epsilon, dj)
            count = count + needs.to(torch.int32)
        else:
            dj = torch.where(dj == 0, one, dj)
        col = a[j + 1:, j] / dj
        a[j, j] = dj
        a[j + 1:, j] = col
        a[j + 1:, j + 1:].sub_(torch.outer(col * dj, col))
    return torch.tril(a), count, ok


def ldlt_factor(a, *, reg: LdltRegularization | None = None,
                params: LdltParams | None = None):
    """Blocked LDLT of the lower triangle of ``a``: returns ``(ld,
    LdltInfo)``, ``ld`` packing unit L strictly below the diagonal and D on
    it (faer ``cholesky_in_place``, ``ldlt/factor.rs:725``;
    ``cholesky.py:289-325``). Per panel: ``_panel_ldlt``, then
    L21 = A21·L11⁻ᵀ·D⁻¹ through one unit-lower solve and a rank-``block``
    update of the lower trail, in place on a fresh copy. Complex input
    factors its real embedding (D real on the diagonal)."""
    _square(a, "ldlt_factor")
    if a.is_complex():
        ld2, info = ldlt_factor(embed_pair(a), reg=reg, params=params)
        return _extract_factor(ld2), LdltInfo(
            dynamic_regularization_count=(info.dynamic_regularization_count + 1) // 2,
            success=info.success)
    params = params or LdltParams.auto(a.dtype, a.shape)
    reg = reg or LdltRegularization()
    n = a.shape[0]
    block = params.block_size or (256 if n >= 1024 else 64 if n >= 128 else n)
    count, ok = _counters(a)
    a = torch.tril(a)
    for k in range(0, n, block):
        bw = min(block, n - k)
        d, c, o = _panel_ldlt(a[k:k + bw, k:k + bw], reg)
        count, ok = count + c, ok & o
        a[k:k + bw, k:k + bw] = d
        if k + bw < n:
            # L21 D L11ᵀ = A21 → L21 = A21 L11⁻ᵀ D⁻¹
            x = solve_unit_lower_triangular(d, a[k + bw:, k:k + bw].mT).mT
            dd = torch.diagonal(d)
            l21 = x / dd[None, :]
            a[k + bw:, k + bw:] -= torch.tril(matmul(None, l21 * dd[None, :], l21.mT))
            a[k + bw:, k:k + bw] = l21
    return a, LdltInfo(dynamic_regularization_count=count, success=ok)


def ldlt_solve(ld, b):
    """Solve (L D Lᴴ) x = b from the packed LDLT, for an (n,) or (n, k) b;
    a complex factor solves through the real embedding."""
    if ld.is_complex():
        return extract_rhs(ldlt_solve(embed_pair(ld), embed_rhs(b.to(ld.dtype))))
    y = solve_unit_lower_triangular(ld, b)
    d = torch.diagonal(ld)
    y = y / (d if y.dim() == 1 else d[:, None])
    return solve_upper_triangular(ld.mT, y, unit=True)


def ldlt_reconstruct(ld):
    n = ld.shape[0]
    l = torch.tril(ld, -1) + torch.eye(n, dtype=ld.dtype, device=ld.device)
    return matmul(None, l * torch.diagonal(ld).real[None, :], l.mH)


# ---------------------------------------------------------------------------
# pivoted LLT (diagonal full pivoting, rank-revealing for PSD)
# ---------------------------------------------------------------------------

def piv_llt_factor(a):
    """Diagonal-pivoted LLT: returns ``(L, perm, rank, LltInfo)`` with
    ``A[perm][:, perm] = L Lᴴ`` (faer ``llt_pivoting/factor.rs:199``,
    LAPACK ``pstrf``). A column whose remaining pivot is at most
    ``n·eps·max(diag)`` is zeroed (in the blocked form) and left out of
    ``rank``; ``dynamic_regularization_count`` counts those columns.
    Blocked at n > 64 (``cholesky.py:350-363``)."""
    _square(a, "piv_llt_factor")
    if a.shape[0] > 64:
        return _piv_llt_blocked(a, 64)
    return _piv_llt_unblocked(a)


def _piv_tol(a):
    n = a.shape[0]
    return n * dtypes.eps(a.dtype) * torch.clamp(torch.diagonal(a).real, min=0).max()


def _piv_llt_unblocked(a):
    """``cholesky.py:365-400``: symmetric swaps on the full symmetric
    matrix, one column a step, its mirror row written back."""
    n = a.shape[0]
    a = _symmetric_from_lower(a)
    tol = _piv_tol(a)
    perm = torch.arange(n, dtype=torch.long, device=a.device)
    rank, _ = _counters(a)
    count = rank.clone()
    one = a.new_ones(())
    rone = one.real
    for j in range(n):
        p = torch.argmax(torch.diagonal(a)[j:].real) + j
        idx = permod.pair_index(a, j, p)
        rev = idx.flip(0)
        a[idx] = a[rev]
        a[:, idx] = a[:, rev]
        perm[idx] = perm[rev]
        pj = a[j, j].real
        alive = pj > tol
        rank = rank + alive.to(torch.int32)
        count = count + (~alive).to(torch.int32)
        piv = torch.sqrt(torch.where(alive, pj, rone)).to(a.dtype)
        # a dead column keeps its entries below (over a pivot of 1) and a 0
        # on the diagonal, as the JAX body leaves them
        col = a[j + 1:, j] / piv
        a[j, j] = torch.where(alive, piv, 0 * one)
        a[j + 1:, j] = col
        a[j, j + 1:] = col.conj()  # the mirror, for later swaps
        a[j + 1:, j + 1:].sub_(torch.outer(col, col.conj()))
    info = LltInfo(dynamic_regularization_count=count, success=count == 0)
    return torch.tril(a), perm, rank, info


def _piv_llt_blocked(a, block: int):
    """``pstrf`` panels (``cholesky.py:403-471``): per step one virtual
    column c = (A − V Vᵀ) e_j against the panel's own columns V and a
    downdate of the pivot diagonal; the rank-``block`` trailing update once
    a panel. Rows above the step are never read (they are the upper
    triangle, which the result drops)."""
    n = a.shape[0]
    a = _symmetric_from_lower(a)
    tol = _piv_tol(a)
    perm = torch.arange(n, dtype=torch.long, device=a.device)
    rank, _ = _counters(a)
    count = rank.clone()
    one = a.new_ones(())
    diag_v = torch.diagonal(a).real.clone()
    for k0 in range(0, n, block):
        bw = min(block, n - k0)
        v_p = a.new_zeros((n, bw))
        for i in range(bw):
            j = k0 + i
            p = torch.argmax(diag_v[j:]) + j
            idx = permod.pair_index(a, j, p)
            rev = idx.flip(0)
            a[idx] = a[rev]
            a[:, idx] = a[:, rev]
            v_p[idx] = v_p[rev]
            diag_v[idx] = diag_v[rev]
            perm[idx] = perm[rev]
            c = a[j:, j] - matmul(None, v_p[j:], v_p[j].conj())
            pj = c[0].real
            alive = pj > tol
            rank = rank + alive.to(torch.int32)
            count = count + (~alive).to(torch.int32)
            piv = torch.sqrt(torch.where(alive, pj, one.real)).to(a.dtype)
            lcol = torch.where(alive, torch.cat([piv.reshape(1), c[1:] / piv]), 0 * one)
            a[j:, j] = lcol
            v_p[j:, i] = lcol
            diag_v[j + 1:] -= (lcol[1:] * lcol[1:].conj()).real
        end = k0 + bw
        if end < n:
            a[end:, end:] -= matmul(None, v_p[end:], v_p[end:].mH)
            diag_v = torch.diagonal(a).real.clone()
    info = LltInfo(dynamic_regularization_count=count, success=count == 0)
    return torch.tril(a), perm, rank, info


def piv_llt_solve(l, perm, b):
    """Solve A x = b from ``A[perm][:, perm] = L Lᴴ`` (full rank)."""
    x = llt_solve(l, b.index_select(0, perm))
    return permod.permute_rows_inverse(x, perm)


def piv_llt_reconstruct(l, perm):
    iperm = permod.invert_perm(perm)
    return llt_reconstruct(l).index_select(0, iperm).index_select(1, iperm)


# ---------------------------------------------------------------------------
# Bunch–Kaufman LBLT (1×1 and 2×2 pivots)
# ---------------------------------------------------------------------------

def lblt_factor(a, params: LbltParams | None = None):
    """Bunch–Kaufman LBLT of the lower triangle: ``A[perm][:, perm] =
    L B Lᵀ``, faer ``bunch_kaufman/factor.rs:1161`` (partial pivoting).

    Returns ``(lb, subdiag, perm, LbltInfo)``: ``lb`` packs unit L strictly
    below the diagonal and B's diagonal on it; ``subdiag[k] ≠ 0`` marks a
    2×2 block at (k, k+1) with that off-diagonal (the slot (k+1, k) of
    ``lb`` holds it too, not an entry of L). n > 96 takes the blocked
    (``lahef``) form with panels of 32, else the unblocked one
    (``cholesky.py:491-506``).
    """
    del params
    _square(a, "lblt_factor")
    if a.shape[0] > 96:
        return _lblt_blocked(a, 32)
    return _lblt_unblocked(a)


def _lblt_unblocked(a):
    """``cholesky.py:509-618``: a pivot decision a step, read on the host
    (the JAX ``while_loop`` steps by 1 or 2), on the full symmetric
    matrix."""
    n = a.shape[0]
    a = _symmetric_from_lower(a)
    dev = a.device
    perm = torch.arange(n, dtype=torch.long, device=dev)
    subdiag = a.new_zeros((n,))
    nt, count = _counters(a)[0], _counters(a)[0]
    k = 0
    while k < n:
        absakk = a[k, k].real.abs()
        if k + 1 < n:
            colmag = a[k + 1:, k].abs()
            r = torch.argmax(colmag) + (k + 1)
            colmax = colmag.max()
        else:  # no entry below: the JAX body's argmax over −1s picks row 0
            r = torch.zeros((), dtype=torch.long, device=dev)
            colmax = a.new_zeros(()).real
        rows = torch.arange(n, device=dev)
        rowmag = torch.where((rows >= k) & (rows != r), a.index_select(0, r.reshape(1))[0].abs(),
                             -a.new_ones(()).real)
        rowmax = torch.clamp(rowmag.max(), min=0)
        arr = a[r, r].real.abs()
        zero_piv = torch.maximum(absakk, colmax) == 0
        u11_a = absakk >= _BK_ALPHA * colmax
        u11_b = absakk * rowmax >= _BK_ALPHA * colmax * colmax
        u11_sw = arr >= _BK_ALPHA * rowmax
        one_by_one = zero_piv | u11_a | u11_b | u11_sw
        do_swap = ~zero_piv & ~u11_a & ~u11_b
        kp = torch.where(do_swap, r, k)
        one, kp = host_read(torch.stack([one_by_one.long(), kp]))
        swap_row = k if one else k + 1
        if kp != swap_row:
            permod.swap_rows_(a, swap_row, kp)
            permod.swap_cols_(a, swap_row, kp)
            permod.swap_rows_(perm, swap_row, kp)
            nt = nt + 1
        if one or k + 1 >= n:
            d = a[k, k].real
            safe = torch.where(d == 0, torch.ones_like(d), d).to(a.dtype)
            col = a[k + 1:, k] / safe
            a[k + 1:, k + 1:].sub_(torch.outer(col * safe, col.conj()))
            a[k + 1:, k] = col
            a[k, k + 1:] = col.conj()
            k += 1
        else:
            # D = [[d11, conj(d21)], [d21, d22]], Hermitian
            d11, d21, d22 = a[k, k], a[k + 1, k], a[k + 1, k + 1]
            det = (d11 * d22 - d21 * d21.conj()).real
            safe_det = torch.where(det == 0, torch.ones_like(det), det)
            w = a[k + 2:, k:k + 2]
            inv = torch.stack([torch.stack([d22.real.to(a.dtype), -d21.conj()]),
                               torch.stack([-d21, d11.real.to(a.dtype)])]) / safe_det
            lw = matmul(None, w, inv)  # [l1 l2] = W inv(D)
            a[k + 2:, k + 2:] -= matmul(None, lw, w.mH)
            a[k + 2:, k:k + 2] = lw
            a[k:k + 2, k + 2:] = lw.mH
            subdiag[k] = d21
            k += 2
        count = count + zero_piv.to(torch.int32)
    info = LbltInfo(dynamic_regularization_count=count, transposition_count=nt)
    return torch.tril(a), subdiag, perm, info


def _lblt_blocked(a, bw: int):
    """``lahef``-style blocked Bunch–Kaufman (``cholesky.py:621-770``).

    A panel runs ``bw − 1`` steps; each reads virtual columns
    ``c = (A − V Wᵀ) e_j`` (V the panel's L columns, W its updated
    columns), picks a 1×1 or a 2×2 pivot and may swap a row and column;
    a 2×2 pivot consumes two columns, so a panel ends after ``bw − 1`` or
    ``bw`` columns. The step's column j = panel start + ``kl`` lives on the
    device; a step past the panel's end (``kl > bw − 2``) changes nothing.
    Both eliminations are formed and one is kept by ``torch.where``, as the
    JAX body's ``lax.cond`` keeps one. The panel's end is read on the host
    once a panel; the rank-2·bw trailing update follows it.
    """
    n = a.shape[0]
    dev = a.device
    a = _symmetric_from_lower(a)
    rows = torch.arange(n, device=dev)
    neg1 = -a.new_ones(())
    perm = torch.arange(n, dtype=torch.long, device=dev)
    subdiag = a.new_zeros((n,))
    nt, _ = _counters(a)
    count = nt.clone()
    kg = 0
    while kg < n:
        v_p = a.new_zeros((n, bw))
        w_p = a.new_zeros((n, bw))
        kl = torch.zeros((), dtype=torch.long, device=dev)

        def vcols(idx):
            """(A − V Wᴴ)[:, idx] for a (k,) index tensor: (n, k)."""
            return a.index_select(1, idx) - matmul(None, v_p, w_p.index_select(0, idx).mH)

        # a step can only be active while the column it would start is in
        # range: kl ≥ i after i active steps
        for _ in range(min(bw - 1, n - kg)):
            j = kl + kg
            active = (kl <= bw - 2) & (j < n)
            jc = torch.clamp(j, max=n - 1).reshape(1)
            c = vcols(jc)[:, 0]
            absakk = c.index_select(0, jc)[0].real.abs()
            colmag = torch.where(rows > j, c.abs(), neg1.real)
            r = torch.argmax(colmag)
            colmax = torch.clamp(colmag.index_select(0, r.reshape(1))[0], min=0)
            cr = vcols(r.reshape(1))[:, 0]
            rowmag = torch.where((rows >= j) & (rows != r), cr.abs(), neg1.real)
            rowmax = torch.clamp(rowmag.max(), min=0)
            arr = cr.index_select(0, r.reshape(1))[0].real.abs()
            zero_piv = torch.maximum(absakk, colmax) == 0
            u11_a = absakk >= _BK_ALPHA * colmax
            u11_b = absakk * rowmax >= _BK_ALPHA * colmax * colmax
            u11_sw = arr >= _BK_ALPHA * rowmax
            one = zero_piv | u11_a | u11_b | u11_sw | (j + 1 >= n)
            do_swap = ~zero_piv & ~u11_a & ~u11_b
            kp = torch.where(do_swap, r, j)
            swap_row = torch.where(one, j, j + 1)
            swapped = active & (kp != swap_row)
            # an inactive or unswapped step swaps a row with itself
            s0 = torch.where(active, swap_row, 0)
            idx = torch.stack([s0, torch.where(swapped, kp, s0)])
            rev = idx.flip(0)
            a[idx] = a[rev]
            a[:, idx] = a[:, rev]
            v_p[idx] = v_p[rev]
            w_p[idx] = w_p[rev]
            perm[idx] = perm[rev]
            nt = nt + swapped.to(torch.int32)
            count = count + (active & zero_piv).to(torch.int32)

            # both eliminations, on the columns j and j + 1 after the swap
            j1 = torch.clamp(j + 1, max=n - 1).reshape(1)
            c12 = vcols(torch.cat([jc, j1]))
            c1, c2 = c12[:, 0], c12[:, 1]
            on, below = rows == j, rows > j
            d11 = c1.index_select(0, jc)[0]
            d = d11.real
            safe = torch.where(d == 0, torch.ones_like(d), d).to(a.dtype)
            l = torch.where(below, c1 / safe, 0 * neg1)
            packed1 = torch.where(on, d.to(a.dtype), torch.where(below, l, c1))
            wm = torch.where(below, c1, 0 * neg1)
            d21 = c1.index_select(0, j1)[0]
            d22 = c2.index_select(0, j1)[0]
            det = (d11 * d22 - d21 * d21.conj()).real
            safe_det = torch.where(det == 0, torch.ones_like(det), det)
            inv11, inv22 = d22.real / safe_det, d11.real / safe_det
            inv21 = -d21 / safe_det
            below2 = rows > j + 1
            l1 = torch.where(below2, c1 * inv11 + c2 * inv21, 0 * neg1)
            l2 = torch.where(below2, c1 * inv21.conj() + c2 * inv22, 0 * neg1)
            p1 = torch.where(on, d11, torch.where(rows == j + 1, d21,
                                                  torch.where(below2, l1, c1)))
            p2 = torch.where(rows == j + 1, d22, torch.where(below2, l2, c2))
            wm1 = torch.where(below2, c1, 0 * neg1)
            wm2 = torch.where(below2, c2, 0 * neg1)
            two = active & ~one
            # column j + 1 first: where it is clamped onto j, j's write wins
            a[:, j1] = torch.where(two, p2, a.index_select(1, j1)[:, 0])[:, None]
            a[:, jc] = torch.where(active, torch.where(one, packed1, p1),
                                   a.index_select(1, jc)[:, 0])[:, None]
            klc = torch.clamp(kl, max=bw - 1).reshape(1)
            kl1 = torch.clamp(kl + 1, max=bw - 1).reshape(1)
            v_p[:, kl1] = torch.where(two, l2, v_p.index_select(1, kl1)[:, 0])[:, None]
            w_p[:, kl1] = torch.where(two, wm2, w_p.index_select(1, kl1)[:, 0])[:, None]
            v_p[:, klc] = torch.where(active, torch.where(one, l, l1),
                                      v_p.index_select(1, klc)[:, 0])[:, None]
            w_p[:, klc] = torch.where(active, torch.where(one, wm, wm1),
                                      w_p.index_select(1, klc)[:, 0])[:, None]
            subdiag[jc] = torch.where(two, d21, subdiag.index_select(0, jc)[0])
            kl = kl + torch.where(active, torch.where(one, 1, 2), 0)
        end = kg + host_read(kl)
        if end < n:
            a[end:, end:] -= matmul(None, v_p[end:], w_p[end:].mH)
        kg = end
    info = LbltInfo(dynamic_regularization_count=count, transposition_count=nt)
    return torch.tril(a), subdiag, perm, info


def _solve_block_diag(diag, subdiag, b):
    """Solve B x = b for the Hermitian block diagonal B of 1×1 and 2×2
    blocks (``cholesky.py:773-805``): ``subdiag[k] ≠ 0`` starts a 2×2
    block at (k, k+1). Vectorized with shifted copies and masks."""
    vec = b.dim() == 1
    b = b[:, None] if vec else b
    diag = diag.real.to(b.dtype)
    is2 = subdiag != 0
    is2_second = torch.cat([is2.new_zeros(1), is2[:-1]])
    d, e = diag, subdiag
    one = d.new_ones(1)
    d_next = torch.cat([d[1:], one])
    e_prev = torch.cat([one, e[:-1]])
    d_prev = torch.cat([one, d[:-1]])
    zrow = b.new_zeros((1, b.shape[1]))
    b_next = torch.cat([b[1:], zrow])
    b_prev = torch.cat([zrow, b[:-1]])
    det = torch.where(is2, d * d_next - e * e.conj(), torch.ones_like(d))
    det_prev = torch.cat([one, det[:-1]])
    safe_d = torch.where(d == 0, torch.ones_like(d), d)
    x_1x1 = b / safe_d[:, None]
    x_first = (d_next[:, None] * b - e.conj()[:, None] * b_next) / det[:, None]
    x_second = (d_prev[:, None] * b - e_prev[:, None] * b_prev) / det_prev[:, None]
    x = torch.where(is2[:, None], x_first,
                    torch.where(is2_second[:, None], x_second, x_1x1))
    return x[:, 0] if vec else x


def _lblt_strip_l(lb, subdiag):
    """Packed → clean unit L: inside a 2×2 pivot the (k+1, k) slot holds
    B's off-diagonal, which is not an entry of L."""
    n = lb.shape[0]
    if n <= 1:
        return lb
    is2 = (subdiag[:-1] != 0).to(lb.dtype)
    return lb - torch.diag(torch.diagonal(lb, -1) * is2, -1)


def lblt_solve(lb, subdiag, perm, b):
    """Solve A x = b from the LBLT factorization."""
    lb = _lblt_strip_l(lb, subdiag)
    y = solve_unit_lower_triangular(lb, b.index_select(0, perm))
    z = _solve_block_diag(torch.diagonal(lb), subdiag, y)
    w = solve_upper_triangular(lb.mH, z, unit=True)
    return permod.permute_rows_inverse(w, perm)


def lblt_reconstruct(lb, subdiag, perm):
    n = lb.shape[0]
    l = torch.tril(_lblt_strip_l(lb, subdiag), -1) + torch.eye(
        n, dtype=lb.dtype, device=lb.device)
    bmat = torch.diag(torch.diagonal(lb).real.to(lb.dtype))
    if n > 1:
        off = torch.diag(subdiag[:-1], -1)
        bmat = bmat + off + off.mH
    a = matmul(None, matmul(None, l, bmat), l.mH)
    iperm = permod.invert_perm(perm)
    return a.index_select(0, iperm).index_select(1, iperm)


# ---------------------------------------------------------------------------
# rank updates (llt/update.rs:360, ldlt/update.rs:376)
# ---------------------------------------------------------------------------

def _column(w, dtype):
    """``w`` as an (n, r) matrix of the factor's dtype."""
    w = w.to(dtype)
    return w[:, None] if w.dim() == 1 else w


def _wavefronts(n: int, r: int, device):
    """The steps of r sequential rank-1 updates over n columns, run as
    wavefronts: step t takes the pairs (update k, column j = t − k). A pair
    reads column j as update k − 1 left it and update k's vector as its
    column j − 1 left it, and no other pair of its step touches either, so
    each pair sees exactly the operands of the sequential order. Yields
    ``(ks, js)`` index tensors on ``device``, js descending."""
    ar = torch.arange(max(n, r), device=device)
    for t in range(n + r - 1):
        k0, k1 = max(0, t - n + 1), min(r, t + 1)
        ks = ar[k0:k1]
        yield ks, t - ks


def llt_rank_r_update(l, w, alpha: float):
    """The LLT factor of ``L Lᴴ + α W Wᴴ`` (faer ``rank_r_update_clobber``,
    ``llt/update.rs:360``; ``cholesky.py:847-903``): one rank-1 update a
    column of ``W`` (n,) or (n, r), in order.

    ``alpha`` is a Python float whose sign picks the update (Givens
    rotations folding v = √α·w into L column by column, LINPACK ``chud``)
    or the downdate (hyperbolic rotations, ``chdd``; the result must stay
    positive definite). The r updates run as wavefronts (``_wavefronts``),
    the same rotations on the same operands as one after another; each step
    updates L's columns (rows of Lᵀ) and the vectors below their pivots.
    """
    n = l.shape[0]
    alpha = float(alpha)
    lt = torch.tril(l).mT.contiguous()  # row j: column j of L
    v = ((abs(alpha) ** 0.5) * _column(w, l.dtype)).mT.contiguous()  # (r, n)
    cols = torch.arange(n, device=l.device)
    floor = dtypes.eps(l.dtype)
    for ks, js in _wavefronts(n, v.shape[0], l.device):
        col, vec = lt.index_select(0, js), v.index_select(0, ks)
        jj = js[:, None]
        # L's diagonal is real: c (and γ) real, s (and t) of w's field
        a_, b_ = col.gather(1, jj).real, vec.gather(1, jj)
        below = cols[None, :] > jj
        if alpha >= 0:
            r = torch.sqrt(a_ * a_ + (b_ * b_.conj()).real)
            safe_r = torch.where(r == 0, torch.ones_like(r), r)
            c, s = a_ / safe_r, b_ / safe_r
            new_col = torch.where(below, c * col + s.conj() * vec, col)
            new_vec = torch.where(below, c * vec - s * col, vec)
            new_col.scatter_(1, jj, r.to(l.dtype))
        else:
            safe_a = torch.where(a_ == 0, torch.ones_like(a_), a_)
            t = b_ / safe_a
            one_m = torch.clamp(1.0 - (t * t.conj()).real, min=floor)
            gamma = 1.0 / torch.sqrt(one_m)
            new_col = torch.where(below, gamma * (col - t.conj() * vec), col)
            new_vec = torch.where(below, gamma * (vec - t * col), vec)
            new_col.scatter_(1, jj, (a_ * torch.sqrt(one_m)).to(l.dtype))
        lt.index_copy_(0, js, new_col)
        v.index_copy_(0, ks, new_vec)
    return lt.mT.contiguous()


def llt_rank_1_update(l, w, alpha: float):
    """The LLT factor of ``L Lᴴ + α w wᴴ`` for an (n,) ``w``."""
    return llt_rank_r_update(l, w, alpha)


def ldlt_rank_r_update(ld, w, alpha: float):
    """The packed LDLT factor of ``L D Lᴴ + α W Wᴴ`` (faer
    ``ldlt/update.rs:376``; ``cholesky.py:906-945``): one rank-1 update a
    column of ``W``, in order, each Gill–Golub–Murray–Saunders algorithm
    C1, a forward pass carrying its running multiplier (from ``alpha``, a
    Python float); updates and downdates alike (the result must stay
    nonsingular). Run as wavefronts, as :func:`llt_rank_r_update`."""
    n = ld.shape[0]
    ldt = torch.tril(ld).mT.contiguous()  # row j: column j, D_j on the diagonal
    v = _column(w, ld.dtype).mT.contiguous()  # (r, n)
    # the running multipliers and D are real in every field
    mult = torch.full((v.shape[0], 1), float(alpha), dtype=dtypes.real_dtype_of(ld.dtype),
                      device=ld.device)
    cols = torch.arange(n, device=ld.device)
    for ks, js in _wavefronts(n, v.shape[0], ld.device):
        col, vec, a = ldt.index_select(0, js), v.index_select(0, ks), mult.index_select(0, ks)
        jj = js[:, None]
        p, dj = vec.gather(1, jj), col.gather(1, jj).real
        dj_new = dj + (a * p * p.conj()).real
        safe = torch.where(dj_new == 0, torch.ones_like(dj_new), dj_new)
        beta = a * p.conj() / safe
        below = cols[None, :] > jj
        new_vec = torch.where(below, vec - p * col, vec)
        new_col = torch.where(below, col + beta * new_vec, col)
        new_col.scatter_(1, jj, dj_new.to(ld.dtype))
        ldt.index_copy_(0, js, new_col)
        v.index_copy_(0, ks, new_vec)
        mult.index_copy_(0, ks, a * dj / safe)
    return ldt.mT.contiguous()


def ldlt_rank_1_update(ld, w, alpha: float):
    """The packed LDLT factor of ``L D Lᴴ + α w wᴴ`` for an (n,) ``w``."""
    return ldlt_rank_r_update(ld, w, alpha)
