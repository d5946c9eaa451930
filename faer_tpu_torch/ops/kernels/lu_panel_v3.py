"""Kernel 13: ``lu_panel_v3``, the unrolled twin of ``lu_panel_v2``.

Counterpart of ``lu_panel_v3_pallas`` (``faer_tpu/ops/pallas/lu_panel_v3.py:125``,
body ``:51``). The v3 body is v2's with each 8-column sub-block unrolled in
Python for Mosaic: the same virtual pivots, the same masked multipliers and
the same deferred rank-8 coupling, so it computes the same function down to
the order of rounding. On Hopper the unrolling has nothing to buy, so
:func:`lu_panel_v3` launches row 12's kernel (``csrc/lu_panel_batched.cu``,
one panel) behind its own launch counter, as ``lu_leaf`` does, and its
plain version is ``lu_panel_plain`` at ``sb = 8``.
"""
from __future__ import annotations

from faer_tpu_torch.core.config import count_launch
from faer_tpu_torch.ops.kernels import _build
from faer_tpu_torch.ops.kernels.lu_panel import launch
from faer_tpu_torch.ops.kernels.lu_panel_v2 import lu_panel_v2_plain


def lu_panel_v3_plain(panel):
    """Plain PyTorch version of ``lu_panel_v3``: ``(packed, perm, nt, ok)``."""
    return lu_panel_v2_plain(panel)


def lu_panel_v3(panel):
    """Partial-pivot LU of an (m, b) float32 panel, m, b ≥ 1 (wide too), with
    the contract of ``lu_panel``. On a CUDA tensor the rows must be contiguous
    (any row stride)."""
    _build.check_panel(panel, "lu_panel_v3")
    if panel.device.type == "cpu":
        return lu_panel_v3_plain(panel)
    res = launch(panel)
    count_launch("lu_panel_v3")
    return res
