"""Kernel 14: ``qr_panel_v2``, the transposed, sub-blocked QR panel.

Counterpart of ``qr_panel_v2_pallas`` (``faer_tpu/ops/pallas/qr_panel_v2.py:141``,
body ``:44``): the QR of an (m, b) f32 panel, ``(packed, taus)`` with the
contract of ``qr_panel``. The Pallas body factors 8-column sub-blocks by
rank-1 reflector steps and defers their coupling to the later columns to
one compact-WY block update, its T inverted by Neumann doubling, with
HIGHEST dots. That is the function of ``qr_panel`` in another order of
rounding, so :func:`qr_panel_v2` launches the same CUDA kernel
(``csrc/qr_panel.cu``) behind its own launch counter, as ``lu_panel_v2``
does for the LU panels, and :func:`qr_panel_v2_plain` is ``qr_panel_plain``
at the body's sub-block width of 8, in full FP32. Its T is the v4/v5
bodies' form, (I + diag(τ)·strict_upper(VVᵀ))⁻¹·diag(τ); v2 inverts the
transpose instead, the same matrix to rounding (``tests/test_torch_qr_panels.py``
holds the two within faer's 8·m·eps).
"""
from __future__ import annotations

from faer_tpu_torch.core.config import count_launch
from faer_tpu_torch.ops.kernels import _build
from faer_tpu_torch.ops.kernels.qr_panel import launch, qr_panel_plain

SUB_BLOCK = 8  # the Pallas body's sub-block width (``SB``)


def qr_panel_v2_plain(panel):
    """Plain PyTorch version of ``qr_panel_v2``: ``(packed, taus)``."""
    return qr_panel_plain(panel, sb=SUB_BLOCK)


def qr_panel_v2(panel):
    """Householder QR of an (m, b) float32 panel, m, b ≥ 1 (wide too), with
    the contract of ``qr_panel``. On a CUDA tensor ``b`` must be at most
    4096 and the rows must be contiguous (any row stride)."""
    _build.check_panel(panel, "qr_panel_v2")
    if panel.device.type == "cpu":
        return qr_panel_v2_plain(panel)
    res = launch(panel)
    count_launch("qr_panel_v2")
    return res
