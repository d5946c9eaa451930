"""LU factorizations (counterpart of ``faer_tpu/linalg/lu.py``): partial
pivoting, blocked, and full pivoting.

faer ``lu_in_place`` (``lu/partial_pivoting/factor.rs:234``). Three
partial-pivot drivers, chosen as the JAX package chooses them
(``lu.py:267-283``), the dtype first:

* float32 squares with ``n % 256 == 0`` and ``n ≥ 1024`` take the
  fused-panel two-level strip driver (``_lu_factor_v5``), one ``lu_panel``
  kernel call per panel;
* every other float32 matrix, square or not, takes the recursive driver
  (``_lu_factor_recursive``, ``lu.py:286-360``): panels of ``block``
  columns, each factored by halving down to ``lu_leaf`` kernel leaves
  (``_panel_lu_blocked``), U12 by one product against the unit-lower panel
  inverse, and a rank-``block`` trailing update;
* float64 takes the same recursive driver with the JAX package's
  non-kernel leaf ``_panel_lu`` (``lu.py:34-76``), a column a step with
  the pivot found on the card, at ``params.recursion_threshold`` (64).

A float32 leaf taller than ``_CALU_GROUP`` rows takes the tournament (CALU)
leaf ``_lu_leaf_calu`` (``lu.py:79-128``) instead of ``lu_leaf``: its row
groups of ``_CALU_GROUP`` are factored in one ``lu_panel_v2_batched``
launch, their stacked pivot candidates by ``lu_panel_v2``. As in the JAX
package the gate is a module constant, ``1 << 30`` (off for every shape a
card holds); set ``faer_tpu_torch.linalg.lu._CALU_GROUP`` to route tall
leaves through it.

Full pivoting (``full_piv_lu_in_place``, ``lu.py:381-491``) runs blocks of
256 steps, each a global argmax, a row and a column swap and a rank-1
update of the live trail, over a trail that shrinks a block at a time.
Permutations are int64 index tensors: ``A[perm] = L·U``.

complex64 and complex128 take the float64 route's non-kernel bodies
natively (the recursive driver over ``_panel_lu`` leaves, the pivot the
largest modulus, as in the reference), as the JAX package keeps complex
off its kernels; they launch no kernel. ``lu_solve_transpose`` solves
with Aᵀ (no conjugation), as the reference's does.
"""
from __future__ import annotations

import torch

from faer_tpu_torch.core import dtypes
from faer_tpu_torch.core import perm as permod
from faer_tpu_torch.core.errors import LuInfo, ShapeError
from faer_tpu_torch.core.params import FullPivLuParams, PartialPivLuParams
from faer_tpu_torch.ops.kernels.leaf import lu_leaf
from faer_tpu_torch.ops.kernels.lu_panel import lu_panel
from faer_tpu_torch.ops.kernels.lu_panel_v2 import lu_panel_v2, lu_panel_v2_batched
from faer_tpu_torch.ops.matmul import matmul
from faer_tpu_torch.ops.triangular import invert_lower_triangular, invert_upper_triangular
from faer_tpu_torch.ops.triangular_solve import (
    solve_lower_triangular_transpose,
    solve_unit_lower_triangular,
    solve_upper_triangular,
    solve_upper_triangular_transpose,
)


def _unit_lower(x):
    """Unit-lower triangle of the square ``x`` (its strict lower part + I)."""
    return torch.tril(x, -1) + torch.eye(x.shape[0], dtype=x.dtype,
                                         device=x.device)


def _lu_factor_v5(a, block: int, ob: int):
    """One fused panel kernel per panel plus two-level trailing updates over
    full-height column strips (``faer_tpu/linalg/lu.py:172-252``).

    Inside an outer ``ob``-wide block, a panel step is one ``lu_panel`` call
    followed by a strip-local gather, a unit-lower inverse (``trtri``) and
    two products. After the block, every later strip gets one gather, one
    product against the block's unit-lower inverse and one rank-``ob``
    update. Finished strips are never re-permuted in the loop: the later
    blocks' row permutations are composed backward and applied once at the
    end (``_compose_tails``).
    """
    m, n = a.shape
    dev = a.device
    starts = list(range(0, n, ob))
    strips = [a[:, k:k + ob] for k in starts]
    perm = torch.arange(m, dtype=torch.long, device=dev)
    nt = torch.zeros((), dtype=torch.int32, device=dev)
    ok = torch.ones((), dtype=torch.bool, device=dev)
    gperms = []
    for jj, kk in enumerate(starts):
        ow = strips[jj].shape[1]
        t = strips[jj][kk:]  # (m - kk, ow) active rows
        gperm = torch.arange(m - kk, dtype=torch.long, device=dev)
        for k in range(0, ow, block):
            bw = min(block, ow - k)
            packed, lperm, pnt, pok = lu_panel(t[k:, k:k + bw])
            nt = nt + pnt
            ok = ok & pok
            tp = t[k:].index_select(0, lperm)  # strip-local gather
            gperm = torch.cat([gperm[:k], gperm[k:][lperm]])
            top = [tp[:bw, :k], packed[:bw]]
            bot = [tp[bw:, :k], packed[bw:]]
            if k + bw < ow:
                l11inv = invert_lower_triangular(_unit_lower(packed[:bw, :bw]),
                                                 unit=True)
                u12 = matmul(None, l11inv, tp[:bw, k + bw:], precision="highest")
                top.append(u12)
                bot.append(tp[bw:, k + bw:] - matmul(None, packed[bw:], u12))
            t = torch.cat([t[:k], torch.cat(top, 1), torch.cat(bot, 1)], 0)
        strips[jj] = torch.cat([strips[jj][:kk], t], 0) if kk else t
        perm = torch.cat([perm[:kk], perm[kk:][gperm]])
        gperms.append(gperm)
        if jj + 1 < len(starts):
            l11o_inv = invert_lower_triangular(_unit_lower(t[:ow, :ow]),
                                               unit=True)
            for j in range(jj + 1, len(starts)):
                rj = strips[j][kk:].index_select(0, gperm)
                u12j = matmul(None, l11o_inv, rj[:ow], precision="highest")
                lowj = rj[ow:] - matmul(None, t[ow:, :ow], u12j)
                strips[j] = torch.cat([strips[j][:kk], u12j, lowj], 0)

    # later blocks' permutations, composed backward, applied once per strip
    tails = _compose_tails(gperms, [s.shape[1] for s in strips])
    for jj, kk in enumerate(starts):
        ow = strips[jj].shape[1]
        if tails[jj] is not None and m - kk > ow:
            idx = torch.cat([torch.arange(ow, dtype=torch.long, device=dev),
                             ow + tails[jj]])
            strips[jj] = torch.cat(
                [strips[jj][:kk], strips[jj][kk:].index_select(0, idx)], 0)
    out = strips[0] if len(strips) == 1 else torch.cat(strips, 1)
    return out, perm, LuInfo(transposition_count=nt, success=ok)


def _compose_tails(local_perms, widths):
    """Compose block-local permutations backward (``lu.py:363-378``):
    ``tails[j]`` maps the final trail order to the order before block j+1,
    so each finished strip is gathered exactly once."""
    tails = [None] * len(local_perms)
    tail_next = None
    for j in range(len(local_perms) - 1, -1, -1):
        lp = local_perms[j]
        if tail_next is None or lp.shape[0] <= widths[j]:
            t_j = lp
        else:
            t_j = torch.cat([lp[:widths[j]], lp[widths[j]:][tail_next]])
        tails[j] = tail_next
        tail_next = t_j
    return tails


# Leaves taller than this take the tournament leaf. The JAX package gates
# CALU off for every bench size (``lu.py:79-84``, "kept for m >> 4096"); so
# does the port: the constant is the same.
_CALU_GROUP = 1 << 30


def _lu_leaf_calu(panel, group: int = _CALU_GROUP):
    """Tournament (CALU) pivoting for a tall (m, b) leaf (``lu.py:87-128``).

    The rows, padded with zeros to ``ng · group``, form ``ng`` groups; each
    group's ``b`` pivot rows are its candidates, and the stacked (ng·b, b)
    candidates, re-factored, give the ``b`` winners: U₁₁ and the first rows
    of the permutation (winners in elimination order, then every other row
    in its order). L₂₁ is then one product of the other rows against U₁₁⁻¹.
    The groups' factors go through one ``lu_panel_v2_batched`` launch where
    the JAX package loops. A winner that is a padding row (only when a
    column is exactly zero) gets no rank, as ``.at[...].set(mode="drop")``
    gives it none there. Pivots differ from partial pivoting's, and |L| is
    not bounded by 1.
    """
    m, b = panel.shape
    dev = panel.device
    ng = -(-m // group)
    mp = ng * group
    padded = panel if mp == m else torch.cat([panel, panel.new_zeros((mp - m, b))])
    _, perm_g, _, _ = lu_panel_v2_batched(padded.view(ng, group, b))
    offsets = torch.arange(0, mp, group, dtype=torch.long, device=dev)
    cand = (perm_g[:, :b] + offsets[:, None]).reshape(-1)  # (ng·b,) row indices
    packed2, perm2, _, ok = lu_panel_v2(padded.index_select(0, cand))
    win = cand[perm2[:b]]  # the pivot rows, in elimination order
    big = m + b
    # one slot past the end takes the padding rows' ranks, then is dropped
    ranks = torch.full((m + 1,), big, dtype=torch.long, device=dev)
    ranks[torch.clamp(win, max=m)] = torch.arange(b, dtype=torch.long, device=dev)
    ranks = ranks[:m]
    ranks = torch.where(ranks < big, ranks,
                        b + torch.arange(m, dtype=torch.long, device=dev))
    perm = torch.argsort(ranks)
    u11inv = invert_upper_triangular(torch.triu(packed2[:b, :b]))
    l21 = matmul(None, panel.index_select(0, perm[b:]), u11inv, precision="highest")
    packed = torch.cat([packed2[:b], l21])
    return packed, perm, permod.perm_transposition_count(perm), ok


def _eliminate(a, j: int, ok):
    """Column j's multipliers below the pivot a[j, j] (a zero pivot divides
    by 1) and the rank-1 update of the live block, in place; returns ``ok``
    and the pivot's being nonzero."""
    pivot = a[j, j]
    ok = ok & (pivot != 0)
    mult = a[j + 1:, j] / torch.where(pivot == 0, torch.ones_like(pivot), pivot)
    a[j + 1:, j] = mult
    a[j + 1:, j + 1:].sub_(torch.outer(mult, a[j, j + 1:]))
    return ok


def _panel_lu(panel):
    """Unblocked partial-pivot LU of an (m, b) panel (``lu.py:34-76``):
    returns ``(packed, perm, nt, ok)``. A column a step: the pivot by
    ``torch.argmax`` of the column below, a row swap of the panel and the
    permutation, the multipliers and a rank-1 update of the live slice;
    ``nt`` counts the swaps made."""
    m, b = panel.shape
    a = panel.clone(memory_format=torch.contiguous_format)
    perm = torch.arange(m, dtype=torch.long, device=a.device)
    nt = torch.zeros((), dtype=torch.int32, device=a.device)
    ok = torch.ones((), dtype=torch.bool, device=a.device)
    for j in range(min(m, b)):
        p = torch.argmax(a[j:, j].abs()) + j
        idx = permod.pair_index(a, j, p)
        rev = idx.flip(0)
        a[idx] = a[rev]
        perm[idx] = perm[rev]
        nt = nt + (p != j).to(torch.int32)
        ok = _eliminate(a, j, ok)
    return a, perm, nt, ok


def _panel_lu_blocked(panel, base: int):
    """Panel LU by recursive column halving down to leaves of at most
    ``base`` columns (``lu.py:131-170``): ``lu_leaf`` kernel leaves in
    float32, or ``_lu_leaf_calu`` leaves where they are taller than
    ``_CALU_GROUP``; ``_panel_lu`` in float64. Returns ``(packed, perm,
    nt, ok)``. The halves are coupled by a unit-lower solve and one
    product."""
    m, b = panel.shape
    if b <= base:
        if not dtypes.kernel_route(panel.dtype):
            return _panel_lu(panel)
        if m > _CALU_GROUP:
            # the constant as it is now sizes the groups too (the JAX
            # package's default group is bound when its module loads)
            return _lu_leaf_calu(panel, _CALU_GROUP)
        return lu_leaf(panel)
    h = (b + 1) // 2
    left, perm1, nt1, ok1 = _panel_lu_blocked(panel[:, :h], base)
    right = panel[:, h:].index_select(0, perm1)
    u12 = solve_unit_lower_triangular(_unit_lower(left[:h, :h]), right[:h])
    bot, perm2, nt2, ok2 = _panel_lu_blocked(
        right[h:] - matmul(None, left[h:, :h], u12), base)
    # in place into a fresh output where the JAX package concatenates
    out = panel.new_empty((m, b))
    out[:h, :h] = left[:h]
    out[h:, :h] = left[h:].index_select(0, perm2)
    out[:h, h:] = u12
    out[h:, h:] = bot
    perm = torch.cat([perm1[:h], perm1[h:][perm2]])
    return out, perm, nt1 + nt2, ok1 & ok2


def _lu_factor_recursive(a, block: int, base: int):
    """Right-looking over a shrinking trail (``faer_tpu/linalg/lu.py:286-360``).

    Later panels' row permutations are composed backward
    (``_compose_tails``) so that each finished panel is gathered once. Each
    panel and its finished U12 rows are written once into a fresh output,
    which takes the place of the JAX package's strip assembly, the wide
    (n > m) tail included.
    """
    m, n = a.shape
    kmax = min(m, n)
    dev = a.device
    perm = torch.arange(m, dtype=torch.long, device=dev)
    nt = torch.zeros((), dtype=torch.int32, device=dev)
    ok = torch.ones((), dtype=torch.bool, device=dev)
    out = a.new_zeros((m, n))
    trail = a  # (m - k, n - k)
    panels, local_perms = [], []
    for k in range(0, kmax, block):
        bw = min(block, kmax - k)
        panel, lperm, pnt, pok = _panel_lu_blocked(trail[:, :bw], base)
        nt = nt + pnt
        ok = ok & pok
        perm = torch.cat([perm[:k], perm[k:][lperm]])
        local_perms.append(lperm)
        if k + bw < n:
            right = trail[:, bw:].index_select(0, lperm)
            l11inv = invert_lower_triangular(_unit_lower(panel[:bw, :bw]),
                                             unit=True, base=bw)
            u12 = matmul(None, l11inv, right[:bw], precision="highest")
            out[k:k + bw, k + bw:] = u12
            if m - k - bw > 0:
                trail = right[bw:] - matmul(None, panel[bw:, :bw], u12)
        panels.append(panel)
    tails = _compose_tails(local_perms, [p.shape[1] for p in panels])
    for panel, k, tail in zip(panels, range(0, kmax, block), tails):
        bw = panel.shape[1]
        out[k:k + bw, k:k + bw] = panel[:bw]
        if m - k > bw:
            below = panel[bw:] if tail is None else panel[bw:].index_select(0, tail)
            out[k + bw:, k:k + bw] = below
    return out, perm, LuInfo(transposition_count=nt, success=ok)


def lu_in_place(a, params: PartialPivLuParams | None = None):
    """Blocked partial-pivot LU of an (m, n) matrix: returns
    ``(lu, row_perm, LuInfo)``.

    ``lu`` packs unit-lower L (strict) and U; ``a[row_perm] = L @ U``.
    ``params`` sets the recursive driver's panel and leaf widths; the
    fused-panel route fixes its blocking (panels of 256, outer blocks of
    1024 for n ≥ 2048) as the JAX one does.
    """
    if a.dim() != 2:
        raise ShapeError(f"lu_in_place: needs a matrix, got {tuple(a.shape)}")
    dtypes.require_field(a, "lu_in_place")
    # the kernels read rows with unit stride: a strided input is copied once
    a = a.contiguous()
    params = params or PartialPivLuParams.auto(a.dtype, a.shape)
    m, n = a.shape
    kmax = min(m, n)
    block = params.block_size or (512 if kmax >= 2048 else
                                  256 if kmax >= 1024 else
                                  64 if kmax >= 128 else kmax)
    if not dtypes.kernel_route(a.dtype):
        return _lu_factor_recursive(a, block, min(params.recursion_threshold, block))
    if m == n and n % 256 == 0 and n >= 1024:
        return _lu_factor_v5(a, block=256, ob=1024 if n >= 2048 else 256)
    # kernel_leaf: None is unset; clamped to [128, 512], rounded up to 128
    leaf = params.kernel_leaf if params.kernel_leaf is not None else 256
    leaf = min(max(128, -(-leaf // 128) * 128), 512)
    return _lu_factor_recursive(a, block, min(leaf, block))


def _full_piv_block(trail, bw: int):
    """``bw`` steps of full pivoting on the (mk, nk) trail (``lu.py:
    381-416``): the argmax of |a| over the live block (row-major, the first
    of equal ones, as the JAX body's masked argmax), a row and a column
    swap, the multipliers and a rank-1 update of the live block. Returns
    ``(a, row_perm, col_perm, nt, ok)``; ``nt`` counts row and column
    swaps."""
    mk, nk = trail.shape
    a = trail.clone(memory_format=torch.contiguous_format)
    dev = a.device
    rperm = torch.arange(mk, dtype=torch.long, device=dev)
    cperm = torch.arange(nk, dtype=torch.long, device=dev)
    nt = torch.zeros((), dtype=torch.int32, device=dev)
    ok = torch.ones((), dtype=torch.bool, device=dev)
    for j in range(bw):
        flat = torch.argmax(a[j:, j:].abs())
        p = flat // (nk - j) + j
        q = flat % (nk - j) + j
        ri = permod.pair_index(a, j, p)
        rr = ri.flip(0)
        a[ri] = a[rr]
        rperm[ri] = rperm[rr]
        ci = permod.pair_index(a, j, q)
        cr = ci.flip(0)
        a[:, ci] = a[:, cr]
        cperm[ci] = cperm[cr]
        nt = nt + (p != j).to(torch.int32) + (q != j).to(torch.int32)
        ok = _eliminate(a, j, ok)
    return a, rperm, cperm, nt, ok


def full_piv_lu_in_place(a, params: FullPivLuParams | None = None):
    """Full-pivot LU: returns ``(lu, row_perm, col_perm, LuInfo)`` with
    ``A[row_perm][:, col_perm] = L·U`` (faer ``lu/full_pivoting/
    factor.rs:466``; ``lu.py:419-491``).

    Blocks of 256 steps over a shrinking trail (full pivoting updates the
    whole trail before each search, so the update cannot be deferred); the
    later blocks' row and column permutations are composed backward
    (``_compose_tails``) so that each finished L strip and U12 block is
    gathered once, then the packed factor is written once.
    """
    del params
    if a.dim() != 2:
        raise ShapeError(f"full_piv_lu_in_place: needs a matrix, got {tuple(a.shape)}")
    dtypes.require_field(a, "full_piv_lu_in_place")
    m, n = a.shape
    kmax = min(m, n)
    block = 256 if kmax > 256 else kmax
    dev = a.device
    rperm = torch.arange(m, dtype=torch.long, device=dev)
    cperm = torch.arange(n, dtype=torch.long, device=dev)
    nt = torch.zeros((), dtype=torch.int32, device=dev)
    ok = torch.ones((), dtype=torch.bool, device=dev)
    trail = a
    lrs, lcs, lstrips, u12s = [], [], [], []
    starts = list(range(0, kmax, block))
    for k in starts:
        bw = min(block, kmax - k)
        tp, lr, lc, bnt, bok = _full_piv_block(trail, bw)
        rperm = torch.cat([rperm[:k], rperm[k:][lr]])
        cperm = torch.cat([cperm[:k], cperm[k:][lc]])
        nt, ok = nt + bnt, ok & bok
        lrs.append(lr)
        lcs.append(lc)
        lstrips.append(tp[:, :bw])
        u12s.append(tp[:bw, bw:])
        trail = tp[bw:, bw:]
    widths = [s.shape[1] for s in lstrips]
    row_tails = _compose_tails(lrs, widths)
    col_tails = _compose_tails(lcs, widths)
    out = a.new_zeros((m, n))
    for j, k in enumerate(starts):
        bw = widths[j]
        strip, u12 = lstrips[j], u12s[j]
        out[k:k + bw, k:k + bw] = strip[:bw]
        if m - k > bw:
            below = strip[bw:]
            if row_tails[j] is not None:
                below = below.index_select(0, row_tails[j])
            out[k + bw:, k:k + bw] = below
        if u12.shape[1]:
            if col_tails[j] is not None:
                u12 = u12.index_select(1, col_tails[j])
            out[k:k + bw, k + bw:] = u12
    return out, rperm, cperm, LuInfo(transposition_count=nt, success=ok)


def full_piv_lu_solve(lu, row_perm, col_perm, b):
    """Solve A x = b from ``A[row_perm][:, col_perm] = L·U``."""
    x = lu_solve(lu, row_perm, b)
    return permod.permute_rows_inverse(x, col_perm)


def full_piv_lu_reconstruct(lu, row_perm, col_perm):
    return permod.permute_cols_inverse(lu_reconstruct(lu, row_perm), col_perm)


def lu_solve(lu, row_perm, b):
    """Solve A x = b given the packed partial-pivot LU."""
    pb = b.index_select(0, row_perm)
    y = solve_unit_lower_triangular(lu[:, :lu.shape[0]], pb)
    return solve_upper_triangular(lu[:lu.shape[1], :], y)


def lu_solve_transpose(lu, row_perm, b):
    """Solve Aᵀ x = b: with A[perm] = L·U, x = P⁻¹ L⁻ᵀ U⁻ᵀ b
    (``faer_tpu/linalg/lu.py:514-524``)."""
    y = solve_upper_triangular_transpose(lu, b)
    z = solve_lower_triangular_transpose(lu, y, unit=True)
    return permod.permute_rows_inverse(z, row_perm)


def lu_inverse(lu, row_perm):
    """A⁻¹ from the packed LU of a square matrix: ``lu_solve(lu, perm, I)``
    (faer ``inverse.rs``, ``lu.py:537-541``)."""
    n = lu.shape[0]
    return lu_solve(lu, row_perm, torch.eye(n, dtype=lu.dtype, device=lu.device))


def lu_reconstruct(lu, row_perm):
    """Rebuild A from the packed LU (faer ``reconstruct.rs``)."""
    m, n = lu.shape
    k = min(m, n)
    l = torch.tril(lu[:, :k], -1) + torch.eye(m, k, dtype=lu.dtype,
                                                device=lu.device)
    u = torch.triu(lu[:k, :])
    return permod.permute_rows_inverse(matmul(None, l, u), row_perm)


def lu_determinant(lu, row_perm, nt):
    """det(A) from the packed LU and the transposition count."""
    sign = 1.0 - 2.0 * (nt % 2).to(lu.dtype)
    return torch.prod(torch.diagonal(lu)) * sign
