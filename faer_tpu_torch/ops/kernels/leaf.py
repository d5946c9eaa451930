"""Kernels 5 and 6: the leaves of the recursive LLT and LU drivers.

Counterparts of ``faer_tpu/ops/pallas/leaf_v4.py``:

* :func:`lu_leaf` of ``lu_panel_v4_pallas`` (``:228``, body ``:168``), the
  partial-pivot LU of an (m, b) leaf panel;
* :func:`llt_leaf` of ``llt_block_v4_pallas`` (``:132``, body ``:73``), the
  regularized LLT of a (b, b) diagonal block.

Each computes the same function as a fused panel kernel the port already
has: the v4 and v5 kernels differ only in their sub-block width (8 against
16 or 32), that is, in the order of rounding. So both launch the existing
CUDA code (``csrc/lu_panel_batched.cu``, ``csrc/llt_panel.cu`` with m = b), each
behind its own launch counter, and each plain version is the fused panel's
plain version at ``sb = 8``. ``llt_panel.cu`` factors 32-wide sub-blocks, so
a ragged leaf (b not a multiple of 32) is padded with an identity diagonal:
the Cholesky factor of blockdiag(A, I) is blockdiag(L, I).
"""
from __future__ import annotations

import torch

from faer_tpu_torch.core.config import count_launch
from faer_tpu_torch.core.errors import ShapeError
from faer_tpu_torch.ops.kernels import _build
from faer_tpu_torch.ops.kernels import llt_panel as _llt
from faer_tpu_torch.ops.kernels import lu_panel as _lu

LEAF_SUB_BLOCK = 8  # the v4 kernels' sub-block width


def llt_leaf_plain(block, *, eps: float = 0.0, delta: float = 0.0):
    """Plain PyTorch version of the LLT leaf: ``(L, count, ok)``."""
    return _llt.llt_panel_plain(block, eps=eps, delta=delta, sb=LEAF_SUB_BLOCK)


def llt_leaf(block, *, eps: float = 0.0, delta: float = 0.0):
    """Regularized LLT of a (b, b) float32 symmetric block, 1 ≤ b ≤ 512.

    Only the lower triangle is read. Returns ``(L, count, ok)``: L lower
    triangular, the dynamic-regularization count (int32) and whether every
    pivot was positive (bool). On a CUDA tensor the rows must be contiguous.
    """
    _build.check_f32_matrix(block, "llt_leaf")
    b = block.shape[0]
    if block.shape[1] != b or b < 1:
        raise ShapeError(f"llt_leaf: needs a square block, got {tuple(block.shape)}")
    if block.device.type == "cpu":
        return llt_leaf_plain(block, eps=eps, delta=delta)
    if b > _llt.MAX_B:
        raise ShapeError(f"llt_leaf: b must be ≤ {_llt.MAX_B}, got {b}")
    bp = -(-b // _llt.SUB_BLOCK) * _llt.SUB_BLOCK
    if bp == b:
        res = _llt.launch(block, eps, delta)
    else:
        padded = block.new_zeros((bp, bp))
        padded[:b, :b] = block
        padded.diagonal()[b:] = 1.0
        out, cnt, ok = _llt.launch(padded, eps, delta)
        # the padded pivots are exactly 1: positive, and counted only when
        # regularization replaces pivots ≤ delta with delta ≥ 1
        if eps > 0 and delta >= 1.0:
            cnt = cnt - (bp - b)
        res = out[:b, :b], cnt, ok
    count_launch("llt_leaf")
    return res


def lu_leaf_plain(panel):
    """Plain PyTorch version of the LU leaf: ``(packed, perm, nt, ok)``."""
    return _lu.lu_panel_plain(panel, sb=LEAF_SUB_BLOCK)


def lu_leaf(panel):
    """Partial-pivot LU of an (m, b) float32 leaf panel, m ≥ b ≥ 1, with the
    contract of ``lu_panel``. On a CUDA tensor the rows must be contiguous
    (any row stride)."""
    _build.check_panel(panel, "lu_leaf")
    if panel.device.type == "cpu":
        return lu_leaf_plain(panel)
    res = _lu.launch(panel)
    count_launch("lu_leaf")
    return res
