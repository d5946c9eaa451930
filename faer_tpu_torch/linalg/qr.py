"""Householder QR, without and with column pivoting (counterpart of
``faer_tpu/linalg/qr.py``).

faer ``qr_in_place`` (``qr/no_pivoting/factor.rs:258``) and its solve,
lstsq, inverse and reconstruct siblings. Packed layout = LAPACK ``geqrt``:
R in the upper triangle, the reflector tails below the diagonal, and one
compact-WY T factor per ``block``-wide panel, stacked and zero-padded to
(npanels, block, block).

The driver is the JAX package's (``_qr_in_place_impl``, ``qr.py:273-332``):
right-looking over a shrinking trail; each panel is halved recursively
(``_panel_qr_blocked_classic``) down to leaves, coupled, and the trail
updated, by compact-WY block applies (``ops/householder.py``). The dtype
picks the leaves, as the JAX package's ``panel_kernels_enabled`` does:
float32 leaves of ``base`` columns (``kernel_leaf``, 128) are one
``qr_panel`` kernel call each; float64 leaves of 32 columns are the
non-kernel ``_panel_qr`` (``qr.py:81-95``), a reflector a column. Left
out: the CholeskyQR2 panel (``_panel_qr_cholqr``, gated off at
``qr.py:221``).

The column-pivoted QR (``col_piv_qr_in_place``, ``qr.py:386-500``) has no
kernel in either package: LAPACK ``geqp3`` panels of 64 columns, the pivot
by ``torch.argmax`` of the downdated column norms on the card.

complex64 and complex128 run natively on the non-kernel leaves of 32
columns, as the JAX package keeps complex off its kernels
(``qr.py:233,253``): complex reflectors with real β and complex τ,
``A = Q R`` with ``Qᴴ A = R``, every adjoint conjugating.
"""
from __future__ import annotations

import torch

from faer_tpu_torch.core import dtypes
from faer_tpu_torch.core import perm as permod
from faer_tpu_torch.core.errors import ShapeError
from faer_tpu_torch.core.params import ColPivQrParams, QrParams
from faer_tpu_torch.ops.householder import (
    apply_block_on_left,
    apply_sequence_on_left,
    form_block_t,
    make_householder,
)
from faer_tpu_torch.ops.kernels.qr_panel import qr_panel
from faer_tpu_torch.ops.matmul import matmul
from faer_tpu_torch.ops.triangular_solve import solve_upper_triangular

_GENERIC_BASE = 32  # the float64 leaf width (``qr.py:284``)


def _extract_v(packed, bw: int):
    """Unit-lower-trapezoidal V from the first ``bw`` columns of a packed panel."""
    return torch.tril(packed[:, :bw], -1) + torch.eye(
        packed.shape[0], bw, dtype=packed.dtype, device=packed.device)


def _qr_block(kmax: int, params: QrParams) -> int:
    return params.block_size or (512 if kmax >= 2048 else
                                 256 if kmax >= 1024 else
                                 128 if kmax >= 512 else
                                 32 if kmax >= 64 else kmax)


def _masked_householder_col(a, taus, j: int):
    """One reflector step on the panel ``a`` in place (``qr.py:39-78``):
    H_j from rows ≥ j of column j, (β, v tail) stored back into the column,
    H_jᴴ = I − τ̄ v vᴴ applied to the columns past j (rows ≥ j, where v
    lives)."""
    vj, tau, beta = make_householder(a[j:, j])
    taus[j] = tau
    w = matmul(None, vj.conj()[None, :], a[j:, j + 1:])[0]  # vᴴ A
    a[j:, j + 1:] -= tau.conj() * vj[:, None] * w[None, :]
    a[j + 1:, j] = vj[1:]
    a[j, j] = beta


def _panel_qr(panel):
    """Unblocked Householder QR of an (m, b) panel (``qr.py:81-95``):
    returns ``(packed, taus)``."""
    m, b = panel.shape
    a = panel.clone(memory_format=torch.contiguous_format)
    taus = a.new_zeros((b,))
    for j in range(min(m, b)):
        _masked_householder_col(a, taus, j)
    return a, taus


def _panel_qr_blocked_classic(panel, base: int):
    """Panel QR by recursive column halving down to leaves (``qr_panel`` in
    float32, ``_panel_qr`` in float64); the halves are coupled by one
    compact-WY block apply."""
    m, b = panel.shape
    if b <= base or m <= base:
        if not dtypes.kernel_route(panel.dtype):
            return _panel_qr(panel)
        return qr_panel(panel)
    h = (b + 1) // 2
    left, taus1 = _panel_qr_blocked_classic(panel[:, :h], base)
    v1 = _extract_v(left, h)
    right = apply_block_on_left(v1, form_block_t(v1, taus1), panel[:, h:],
                                adjoint=True)
    bot, taus2 = _panel_qr_blocked_classic(right[h:], base)
    # in place into a fresh output where the JAX package concatenates
    out = panel.new_empty((m, b))
    out[:, :h] = left
    out[:h, h:] = right[:h]
    out[h:, h:] = bot
    return out, torch.cat([taus1, taus2])


def _qr_in_place_impl(a, block: int, base: int):
    """Right-looking over a shrinking trail (rows k:, columns k:). Each
    panel's column strip and its finished R12 rows are written once into a
    fresh output, which takes the place of the JAX package's strip
    assembly, the wide (n > min(m, n)) tail included."""
    m, n = a.shape
    kmax = min(m, n)
    out = a.new_zeros((m, n))
    t_stack = a.new_zeros((-(-kmax // block), block, block))
    trail = a
    for p, k in enumerate(range(0, kmax, block)):
        bw = min(block, kmax - k)
        panel, taus = _panel_qr_blocked_classic(trail[:, :bw], base)
        v = _extract_v(panel, bw)
        t = form_block_t(v, taus)
        t_stack[p, :bw, :bw] = t
        out[k:, k:k + bw] = panel
        if k + bw < n:
            right = apply_block_on_left(v, t, trail[:, bw:], adjoint=True)
            out[k:k + bw, k + bw:] = right[:bw]
            trail = right[bw:]
    return out, t_stack


def qr_in_place(a, params: QrParams | None = None):
    """Blocked Householder QR: returns ``(packed, t_stack, block)``.

    ``packed`` holds R (upper) and the reflector tails (strict lower);
    ``t_stack[p]`` is the compact-WY T of panel p, zero-padded to
    (block, block). float32 leaves are ``kernel_leaf`` wide (default 128,
    clamped to [128, 512]), as on the JAX package's kernel route; float64
    leaves are 32 wide, as on its non-kernel route.
    """
    if a.dim() != 2:
        raise ShapeError(f"qr_in_place: needs a matrix, got {tuple(a.shape)}")
    dtypes.require_field(a, "qr_in_place")
    # the kernels read rows with unit stride: a strided input is copied once
    a = a.contiguous()
    params = params or QrParams.auto(a.dtype, a.shape)
    block = _qr_block(min(a.shape), params)
    if dtypes.kernel_route(a.dtype):
        leaf = params.kernel_leaf if params.kernel_leaf is not None else 128
        base = min(max(128, -(-leaf // 128) * 128), 512)
    else:
        base = _GENERIC_BASE
    packed, t_stack = _qr_in_place_impl(a, block, base)
    return packed, t_stack, block


def qr_compute_q(packed, t_stack, block: int, *, thin: bool = True):
    """Q (m × min(m, n) if ``thin``, else m × m) from the packed factor."""
    m = packed.shape[0]
    k = min(packed.shape)
    eye = torch.eye(m, k if thin else m, dtype=packed.dtype, device=packed.device)
    return apply_sequence_on_left(packed, t_stack, eye, adjoint=False, block=block)


def qr_apply_q(packed, t_stack, block: int, b, *, adjoint: bool):
    """``Q b`` or ``Qᴴ b``."""
    return apply_sequence_on_left(packed, t_stack, b, adjoint=adjoint, block=block)


def qr_reconstruct(packed, t_stack, block: int):
    """A = Q R (faer ``qr/no_pivoting/reconstruct.rs``)."""
    m, n = packed.shape
    k = min(m, n)
    rfull = packed.new_zeros((m, n))
    rfull[:k] = torch.triu(packed[:k])
    return apply_sequence_on_left(packed, t_stack, rfull, adjoint=False, block=block)


def qr_solve_lstsq(packed, t_stack, block: int, b):
    """Least-squares solve through Qᴴ b and the R triangle (faer
    ``solvers.rs:639``); m ≥ n."""
    n = packed.shape[1]
    qtb = apply_sequence_on_left(packed, t_stack, b, adjoint=True, block=block)
    return solve_upper_triangular(packed[:n, :n], qtb[:n])


def qr_solve(packed, t_stack, block: int, b):
    """Square-system solve (m == n)."""
    return qr_solve_lstsq(packed, t_stack, block, b)


def qr_inverse(packed, t_stack, block: int):
    """A⁻¹ = R⁻¹ Qᴴ of a square factor."""
    n = packed.shape[1]
    eye = torch.eye(n, dtype=packed.dtype, device=packed.device)
    qt = apply_sequence_on_left(packed, t_stack, eye, adjoint=True, block=block)
    return solve_upper_triangular(packed[:n, :n], qt)


# ---------------------------------------------------------------------------
# column-pivoted QR (col_pivoting/factor.rs:345)
# ---------------------------------------------------------------------------

def col_piv_qr_in_place(a, params: ColPivQrParams | None = None):
    """Column-pivoted Householder QR: returns ``(packed, taus, col_perm)``
    with ``A[:, col_perm] = Q R`` (faer ``col_pivoting/factor.rs:345``).

    Blocked LAPACK ``geqp3`` (``qr.py:386-400``) when both min(m, n) and n
    exceed 64: within a panel of 64 each step makes one trailing product
    (the F update) and downdates the column norms with the pivot row; the
    rank-64 trailing update runs once a panel, then the trailing norms are
    recomputed exactly. Otherwise one reflector a step, every norm exact.
    """
    del params
    if a.dim() != 2:
        raise ShapeError(f"col_piv_qr_in_place: needs a matrix, got {tuple(a.shape)}")
    dtypes.require_field(a, "col_piv_qr_in_place")
    m, n = a.shape
    if min(m, n) <= 64 or n <= 64:
        return _col_piv_qr_unblocked(a)
    return _col_piv_qr_blocked(a, 64)


def _col_piv_qr_unblocked(a):
    """``qr.py:403-423``: per step the exact norms of the columns' rows ≥ j,
    the argmax over columns ≥ j, a column swap and one reflector."""
    m, n = a.shape
    kmax = min(m, n)
    a = a.clone(memory_format=torch.contiguous_format)
    taus = a.new_zeros((kmax,))
    perm = torch.arange(n, dtype=torch.long, device=a.device)
    for j in range(kmax):
        sq = dtypes.abs2(a[j:, j:]).sum(0)
        p = torch.argmax(sq) + j
        idx = permod.pair_index(a, j, p)
        rev = idx.flip(0)
        a[:, idx] = a[:, rev]
        perm[idx] = perm[rev]
        _masked_householder_col(a, taus, j)
    return a, taus, perm


def _col_piv_qr_blocked(a, block: int):
    """``qr.py:426-500``. Per step j: the pivot by the downdated norms, a
    column swap (of A, F's rows, the norms, the permutation), the virtual
    column c = (A − V Fᵀ) e_j, its reflector stored in place, F's column
    w = τ (vᵀ A − (vᵀ V) Fᵀ), and the norm downdate by the updated pivot
    row. V lives in rows ≥ j, so the products read those rows; F's rows
    for the columns at or past j are the ones any later step reads."""
    m, n = a.shape
    kmax = min(m, n)
    dev = a.device
    a = a.clone(memory_format=torch.contiguous_format)
    taus = a.new_zeros((kmax,))
    perm = torch.arange(n, dtype=torch.long, device=dev)
    norms = dtypes.abs2(a).sum(0)
    for k0 in range(0, kmax, block):
        bw = min(block, kmax - k0)
        v_p = a.new_zeros((m, bw))
        f_p = a.new_zeros((n, bw))
        for i in range(bw):
            j = k0 + i
            p = torch.argmax(norms[j:]) + j
            idx = permod.pair_index(a, j, p)
            rev = idx.flip(0)
            a[:, idx] = a[:, rev]
            f_p[idx] = f_p[rev]
            norms[idx] = norms[rev]
            perm[idx] = perm[rev]
            c = a[:, j] - matmul(None, v_p, f_p[j].conj())
            vj, tau, beta = make_householder(c[j:])
            c[j] = beta
            c[j + 1:] = vj[1:]
            a[:, j] = c
            taus[j] = tau
            vh = vj.conj()[None, :]
            wrow = (matmul(None, vh, a[j:, j:])[0]
                    - matmul(None, matmul(None, vh, v_p[j:]), f_p[j:].mH)[0])
            v_p[j:, i] = vj
            f_p[j:, i] = tau * wrow.conj()  # F[:, i] = wᴴ with w = τ̄ vᴴ A_virt
            arow = a[j, j + 1:] - matmul(None, v_p[j], f_p[j + 1:].mH)
            norms[j + 1:] = torch.clamp(norms[j + 1:] - dtypes.abs2(arow), min=0)
        end = k0 + bw
        if end < n:
            a[k0:, end:] -= matmul(None, v_p[k0:], f_p[end:].mH)
            # exact trailing norms: the downdate's drift stays within a panel
            norms[end:] = dtypes.abs2(a[end:, end:]).sum(0)
    return a, taus, perm


def col_piv_qr_t_stack(packed, taus, block: int):
    """The compact-WY T factor of each ``block``-wide panel of a packed
    column-pivoted QR, stacked and zero-padded (``qr.py:503-513``)."""
    kmax = min(packed.shape)
    npan = -(-kmax // block)
    t_stack = packed.new_zeros((npan, block, block))
    for p, k in enumerate(range(0, kmax, block)):
        bw = min(block, kmax - k)
        v = _extract_v(packed[k:, k:k + bw], bw)
        t_stack[p, :bw, :bw] = form_block_t(v, taus[k:k + bw])
    return t_stack


def col_piv_qr_solve_lstsq(packed, taus, perm, b, *, block: int = 32):
    """Least-squares solve from ``A[:, perm] = Q R``: Qᵀ b by panels of
    ``block`` reflectors, the R triangle, then the inverse permutation."""
    n = packed.shape[1]
    t_stack = col_piv_qr_t_stack(packed, taus, block)
    qtb = apply_sequence_on_left(packed, t_stack, b, adjoint=True, block=block)
    x = solve_upper_triangular(packed[:n, :n], qtb[:n])
    return permod.permute_rows_inverse(x, perm)


def col_piv_qr_reconstruct(packed, taus, perm, *, block: int = 32):
    m, n = packed.shape
    k = min(m, n)
    t_stack = col_piv_qr_t_stack(packed, taus, block)
    r = packed.new_zeros((m, n))
    r[:k] = torch.triu(packed[:k])
    qr_ = apply_sequence_on_left(packed, t_stack, r, adjoint=False, block=block)
    return permod.permute_cols_inverse(qr_, perm)
