"""LLT (Cholesky) factor and solve (counterpart of ``faer_tpu/linalg/cholesky.py``).

faer ``cholesky_in_place`` (``llt/factor.rs:67``) and ``llt/solve.rs:12``.
Two drivers, chosen as the JAX package's kernel route chooses them
(``cholesky.py:119-143``):

* f32 squares with ``n > block``, ``n % 128 == 0`` and ``block % 128 == 0``
  take the fused-panel two-level strip driver (``_llt_factor_v5``), one
  ``llt_panel`` kernel call per panel;
* every other f32 square takes the recursive driver
  (``_llt_factor_recursive``, ``cholesky.py:144-175``): panels of ``block``
  columns, each factored by halving down to ``llt_leaf`` kernel leaves
  (``_llt_panel_recursive``), with the panel TRSM as one product against the
  panel's triangular inverse and a rank-``block`` trailing update.

Other dtypes raise ``NotImplementedError`` (ROADMAP §1 item 5c).
"""
from __future__ import annotations

import torch

from faer_tpu_torch.core import dtypes
from faer_tpu_torch.core.errors import LltInfo, ShapeError
from faer_tpu_torch.core.params import LltParams, LltRegularization
from faer_tpu_torch.ops.kernels.leaf import llt_leaf
from faer_tpu_torch.ops.kernels.llt_panel import llt_panel
from faer_tpu_torch.ops.matmul import matmul
from faer_tpu_torch.ops.triangular import invert_lower_triangular
from faer_tpu_torch.ops.triangular_solve import (
    solve_lower_triangular,
    solve_lower_triangular_adjoint,
)


def llt_factor(a, *, reg: LltRegularization | None = None,
               params: LltParams | None = None):
    """Blocked LLT of the lower triangle of ``a``: returns ``(L, LltInfo)``."""
    if a.dim() != 2 or a.shape[0] != a.shape[1]:
        raise ShapeError(f"llt_factor: needs a square matrix, got {tuple(a.shape)}")
    dtypes.require_f32(a, "llt_factor")
    # the kernels read rows with unit stride: a strided input is copied once
    a = a.contiguous()
    params = params or LltParams.auto(a.dtype, a.shape)
    reg = reg or LltRegularization()
    n = a.shape[0]
    block = params.block_size or (256 if n >= 1024 else 64 if n >= 128 else n)
    if n > block and n % 128 == 0 and block % 128 == 0:
        return _llt_factor_v5(a, reg, block)
    # kernel_leaf: None is unset; clamped to [128, 512], rounded up to 128
    leaf = params.kernel_leaf if params.kernel_leaf is not None else 128
    leaf = min(max(128, -(-leaf // 128) * 128), 512)
    return _llt_factor_recursive(a, reg, block, min(leaf, block))


def _llt_panel_recursive(a, reg: LltRegularization, base: int):
    """LLT of a (b, b) block by halving down to ``llt_leaf`` leaves of at
    most ``base`` columns; returns ``(L, count, ok)``.

    Only the lower triangle of ``a`` is read, by the leaves as by the
    couplings, so no mirror is needed (the JAX package mirrors because its
    leaf kernel reads rows as columns).
    """
    b = a.shape[0]
    if b <= base:
        return llt_leaf(a, eps=reg.epsilon, delta=reg.delta)
    h = (b + 1) // 2
    d1, c1, o1 = _llt_panel_recursive(a[:h, :h], reg, base)
    # SPD: ‖L11⁻¹‖ ≤ √cond(A), so the coupling is one product against the
    # explicit inverse
    l21 = matmul(None, a[h:, :h], invert_lower_triangular(d1).mT)
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
    count = torch.zeros((), dtype=torch.int32, device=a.device)
    ok = torch.ones((), dtype=torch.bool, device=a.device)
    trail = a
    for k in range(0, n, block):
        bw = min(block, n - k)
        d, c, o = _llt_panel_recursive(trail[:bw, :bw], reg, base)
        count, ok = count + c, ok & o
        l[k:k + bw, k:k + bw] = torch.tril(d)
        if k + bw < n:
            l21 = matmul(None, trail[bw:, :bw], invert_lower_triangular(d).mT)
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
    count = torch.zeros((), dtype=torch.int32, device=a.device)
    ok = torch.ones((), dtype=torch.bool, device=a.device)
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
    """Solve L Lᴴ x = b (faer ``llt/solve.rs:12``)."""
    y = solve_lower_triangular(l, b)
    return solve_lower_triangular_adjoint(l, y)


def llt_inverse(l):
    """A⁻¹ from the LLT factor: ``llt_solve(L, I)``
    (``faer_tpu/linalg/cholesky.py:244-247``)."""
    return llt_solve(l, torch.eye(l.shape[0], dtype=l.dtype, device=l.device))


def llt_reconstruct(l):
    return matmul(None, l, l.mH)
