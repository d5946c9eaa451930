"""Kernel 18: ``qr_panel_v1``, the first Householder QR panel.

Counterpart of ``qr_panel_pallas`` (``faer_tpu/ops/pallas/panel_kernels.py:224``,
body ``:185``): the QR of an (m, b) f32 panel, ``(packed, taus)`` with the
contract of ``qr_panel`` (kmax = min(m, b) reflectors with the LAPACK
``larfg`` signs, β on the diagonal, the tails below it, R above it, Qᵀ·A
right of column m when the panel is wide).

The Pallas body is a column loop: one reflector, then one rank-1 update of
every later column. That is the order in which the CUDA kernel
(``csrc/qr_panel.cu``) works, so :func:`qr_panel_v1` launches it behind its
own launch counter, as ``qr_panel`` does, and :func:`qr_panel_v1_plain` is
the Pallas body's column loop in full FP32.
"""
from __future__ import annotations

import torch

from faer_tpu_torch.core.config import count_launch
from faer_tpu_torch.ops.householder import rescale_of
from faer_tpu_torch.ops.kernels import _build
from faer_tpu_torch.ops.kernels.qr_panel import launch


def qr_panel_v1_plain(panel):
    """Plain PyTorch version of ``qr_panel_v1``: ``(packed, taus)``."""
    m, b = panel.shape
    kmax = min(m, b)
    a = panel.clone(memory_format=torch.contiguous_format)
    taus = panel.new_zeros(kmax)
    one = panel.new_ones(())
    for j in range(kmax):
        alpha0 = a[j, j].clone()
        tail = a[j + 1:, j].clone()
        # scaled by 2⁶⁴ where the squares lose bits (F2), else by 1
        scale = rescale_of(alpha0 * alpha0 + (tail * tail).sum())
        alpha, tail = alpha0 * scale, tail * scale
        tail_sq = (tail * tail).sum()
        norm = torch.sqrt(alpha * alpha + tail_sq)
        sign = torch.where(alpha >= 0, one, -one)
        beta = -sign * norm
        is_id = tail_sq == 0
        safe_s = torch.where(is_id, one, alpha - beta)
        safe_b = torch.where(is_id, one, beta)
        tau = torch.where(is_id, 0.0, (beta - alpha) / safe_b)
        v = torch.cat([one.reshape(1), torch.where(is_id, 0.0, tail / safe_s)])
        taus[j] = tau
        # H = I − τ v vᵀ on the later columns: w = vᵀA, then A − (τ v) wᵀ
        rest = a[j:, j + 1:]
        w = v @ rest
        a[j:, j + 1:] = rest - (tau * v)[:, None] * w[None, :]
        a[j, j] = torch.where(is_id, alpha0, beta / scale)
        a[j + 1:, j] = v[1:]
    return a, taus


def qr_panel_v1(panel):
    """Householder QR of an (m, b) float32 panel, m, b ≥ 1 (wide too), with
    the contract of ``qr_panel``. On a CUDA tensor ``b`` must be at most
    4096 and the rows must be contiguous (any row stride)."""
    _build.check_panel(panel, "qr_panel_v1")
    if panel.device.type == "cpu":
        return qr_panel_v1_plain(panel)
    res = launch(panel)
    count_launch("qr_panel_v1")
    return res
