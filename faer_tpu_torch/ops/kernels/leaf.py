"""Kernels 5, 6 and 7: the v4 leaves.

Counterparts of ``faer_tpu/ops/pallas/leaf_v4.py``:

* :func:`lu_leaf` of ``lu_panel_v4_pallas`` (``:228``, body ``:168``), the
  partial-pivot LU of an (m, b) leaf panel;
* :func:`llt_leaf` of ``llt_block_v4_pallas`` (``:132``, body ``:73``), the
  regularized LLT of a (b, b) diagonal block;
* :func:`qr_leaf` of ``qr_panel_v4_pallas`` (``:351``, body ``:281``), the
  Householder QR of an (m, b) panel, which no driver calls (as in the JAX
  package: its callers are the panel-lab tools).

Each computes the same function as a kernel the port already has: the v4
and v5 kernels differ only in their sub-block width (8 against 16 or 32)
and their coupling dots, that is, in the order of rounding. So each
launches existing CUDA code behind its own launch counter: ``lu_leaf``
``csrc/lu_panel_batched.cu``, ``qr_leaf`` ``csrc/qr_panel.cu``, and
``llt_leaf`` the blocked diagonal-block kernel ``csrc/llt_block.cu``
(through ``llt_block.launch``, as ``llt_block`` and ``llt_block_v3`` do),
which takes any b up to 1024 as it is: no padding, no inverse. Each plain
version is the fused panel's plain version at the v4 sub-block width
(``sb = 8``; ``qr_leaf`` takes it as an argument, as its Pallas kernel
does).
"""
from __future__ import annotations

from faer_tpu_torch.core.config import count_launch
from faer_tpu_torch.ops.kernels import _build
from faer_tpu_torch.ops.kernels import llt_block as _blk
from faer_tpu_torch.ops.kernels import llt_panel as _llt
from faer_tpu_torch.ops.kernels import lu_panel as _lu
from faer_tpu_torch.ops.kernels import qr_panel as _qr

LEAF_SUB_BLOCK = 8  # the v4 kernels' sub-block width


def llt_leaf_plain(block, *, eps: float = 0.0, delta: float = 0.0):
    """Plain PyTorch version of the LLT leaf: ``(L, count, ok)``."""
    return _llt.llt_panel_plain(block, eps=eps, delta=delta, sb=LEAF_SUB_BLOCK)


def llt_leaf(block, *, eps: float = 0.0, delta: float = 0.0):
    """Regularized LLT of a (b, b) float32 symmetric block.

    Only the lower triangle is read. Returns ``(L, count, ok)``: L lower
    triangular, the dynamic-regularization count (int32) and whether every
    pivot was positive (bool). On a CUDA tensor b must be at most
    ``llt_block.MAX_B`` (1024) and the rows contiguous (any row stride).
    """
    _blk.check_block(block, "llt_leaf")
    if block.device.type == "cpu":
        return llt_leaf_plain(block, eps=eps, delta=delta)
    res = _blk.launch(block, eps, delta, "llt_leaf")
    count_launch("llt_leaf")
    return res


def lu_leaf_plain(panel):
    """Plain PyTorch version of the LU leaf: ``(packed, perm, nt, ok)``."""
    return _lu.lu_panel_plain(panel, sb=LEAF_SUB_BLOCK)


def lu_leaf(panel):
    """Partial-pivot LU of an (m, b) float32 leaf panel, m, b ≥ 1 (wide too),
    with the contract of ``lu_panel``. On a CUDA tensor the rows must be
    contiguous (any row stride)."""
    _build.check_panel(panel, "lu_leaf")
    if panel.device.type == "cpu":
        return lu_leaf_plain(panel)
    res = _lu.launch(panel)
    count_launch("lu_leaf")
    return res


def qr_leaf_plain(panel, *, sb: int = LEAF_SUB_BLOCK):
    """Plain PyTorch version of the QR leaf: ``(packed, taus)``."""
    return _qr.qr_panel_plain(panel, sb=sb)


def qr_leaf(panel, *, sb: int = LEAF_SUB_BLOCK, rch: int = 128):
    """Householder QR of an (m, b) float32 panel, m, b ≥ 1 (wide too), with
    the contract of ``qr_panel``.

    ``sb`` is the Pallas body's sub-block width (8 or 16 in the repository's
    tools): the plain version follows it; the CUDA kernel applies each
    reflector at once and has no sub-blocks. ``rch``, the Pallas body's
    row chunk of the deferred update, is accepted for the same signature and
    changes nothing on either route. On a CUDA tensor ``b`` must be at most
    4096 and the rows must be contiguous (any row stride).
    """
    _build.check_panel(panel, "qr_leaf")
    if sb < 1 or rch < 1:
        raise ValueError(f"qr_leaf: needs sb, rch ≥ 1, got sb={sb}, rch={rch}")
    if panel.device.type == "cpu":
        return qr_leaf_plain(panel, sb=sb)
    res = _qr.launch(panel)
    count_launch("qr_leaf")
    return res
