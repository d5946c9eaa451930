"""Kernel 15: ``qr_panel_v3``, the unrolled twin of ``qr_panel_v2``.

Counterpart of ``qr_panel_v3_pallas`` (``faer_tpu/ops/pallas/qr_panel_v3.py:127``,
body ``:41``). The v3 body is v2's with each 8-column sub-block unrolled in
Python for Mosaic and the eager reflector update restricted to the
sub-block's rows below the current one: the same reflectors and the same
deferred compact-WY coupling, so the same function down to the order of
rounding. On Hopper the unrolling has nothing to buy, so
:func:`qr_panel_v3` launches row 14's kernel (``csrc/qr_panel.cu``) behind
its own launch counter, as ``lu_panel_v3`` does, and its plain version is
``qr_panel_plain`` at ``sb = 8``, whose eager update already touches only
the later columns of the sub-block.
"""
from __future__ import annotations

from faer_tpu_torch.core.config import count_launch
from faer_tpu_torch.ops.kernels import _build
from faer_tpu_torch.ops.kernels.qr_panel import launch
from faer_tpu_torch.ops.kernels.qr_panel_v2 import qr_panel_v2_plain


def qr_panel_v3_plain(panel):
    """Plain PyTorch version of ``qr_panel_v3``: ``(packed, taus)``."""
    return qr_panel_v2_plain(panel)


def qr_panel_v3(panel):
    """Householder QR of an (m, b) float32 panel, m, b ≥ 1 (wide too), with
    the contract of ``qr_panel``. On a CUDA tensor ``b`` must be at most
    4096 and the rows must be contiguous (any row stride)."""
    _build.check_panel(panel, "qr_panel_v3")
    if panel.device.type == "cpu":
        return qr_panel_v3_plain(panel)
    res = launch(panel)
    count_launch("qr_panel_v3")
    return res
