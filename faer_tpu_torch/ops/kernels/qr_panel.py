"""Kernel 4: ``qr_panel``, the Householder QR of an (m, b) panel.

Counterpart of ``qr_panel_v5_pallas`` (``faer_tpu/ops/pallas/qr_panel_v5.py:144``,
body ``:73``). Returns ``(packed, taus)``: ``packed`` holds β on the
diagonal, the reflector tails strictly below it and the panel's R entries
above it; ``taus`` has one τ for each of the kmax = min(m, b) reflectors. A
wide panel (m < b) comes back whole, Qᵀ·A right of column m, as the Pallas
kernel returns it. Reflector j is ``H = I − τ v vᵀ``
with ``v[j] = 1`` and the LAPACK ``larfg`` signs: β = −sign(α)·‖x‖ with
sign(α) = +1 for α ≥ 0 (−0.0 included), τ = (β − α)/β, v = x/(α − β), and a
zero tail gives τ = 0, β = α, v = e_j.

The CUDA kernel (``csrc/qr_panel.cu``) is one cooperative grid with two
grid barriers per column that applies each reflector to all later columns
at once. :func:`qr_panel_plain` follows the Pallas body: transposed panel,
``sb``-column sub-blocks of rank-1 reflector steps, then the sub-block's
compact-WY T (Neumann inverse) and a deferred block update of the later
columns. The two orders of rounding differ; the function is the same.
:func:`launch` is the CUDA route that every QR panel wrapper of the port
takes (``qr_panel`` here, ``qr_panel_v1``, ``qr_panel_v2``, ``qr_panel_v3``
and ``qr_leaf``), each behind its own launch counter.
"""
from __future__ import annotations

import torch

from faer_tpu_torch.core.config import count_launch
from faer_tpu_torch.core.errors import ShapeError
from faer_tpu_torch.ops.kernels import _build
from faer_tpu_torch.ops.kernels.llt_panel import _neumann_unit_inv

MIN_ROWS_PER_CTA = 64
MAX_B = 4096  # the kernel's fixed shared memory, 9·b floats, must fit a CTA


def qr_panel_plain(panel, *, sb: int = 16):
    """Plain PyTorch version of the QR panel (same contract)."""
    m, b = panel.shape
    kmax = min(m, b)
    dev = panel.device
    # (b, m), rows = columns of the panel: a fresh copy, updated in place
    pt = panel.mT.clone(memory_format=torch.contiguous_format)
    lanes = torch.arange(m, device=dev)
    taus = panel.new_zeros(kmax)
    one = panel.new_ones(())
    for sb0 in range(0, kmax, sb):
        nj = min(sb, kmax - sb0)
        top = min(sb0 + sb, b)
        vmat = panel.new_zeros((sb, m))
        tau_v = panel.new_zeros(sb)
        for jl in range(nj):
            j = sb0 + jl
            colj = pt[j].clone()
            below = lanes > j
            alpha = colj[j]
            tail_sq = torch.where(below, colj * colj, 0.0).sum()
            norm = torch.sqrt(alpha * alpha + tail_sq)
            sign = torch.where(alpha >= 0, one, -one)
            beta = -sign * norm
            is_id = tail_sq == 0
            safe_s = torch.where(is_id, one, alpha - beta)
            safe_b = torch.where(is_id, one, beta)
            tau = torch.where(is_id, 0.0, (beta - alpha) / safe_b)
            beta = torch.where(is_id, alpha, beta)
            v = torch.where(below & ~is_id, colj * (1.0 / safe_s), 0.0)
            v[j] = 1.0
            taus[j] = tau
            tau_v[jl] = tau
            vmat[jl] = v
            pt[j] = torch.where(lanes == j, beta, torch.where(below, v, colj))
            if jl < nj - 1:
                rest = pt[j + 1:top]
                w = rest @ v
                pt[j + 1:top] = rest - (tau * w)[:, None] * v[None, :]
        sb_end = sb0 + sb
        if sb_end >= b:
            continue
        # the sub-block's compact-WY T: (I + diag(τ)·strict_upper(VVᵀ))⁻¹·diag(τ)
        live = (tau_v != 0).to(panel.dtype)
        tau_safe = torch.where(tau_v == 0, one, tau_v)
        r_up = torch.triu(vmat @ vmat.mT, 1) * tau_safe[:, None]
        t_mat = _neumann_unit_inv(r_up, sb) * tau_safe[None, :]
        t_mat = t_mat * live[None, :] * live[:, None]
        # deferred update of the later columns: A ← (I − V T Vᵀ)ᵀ A
        later = pt[sb_end:b]
        pt[sb_end:b] = later - ((later @ vmat.mT) @ t_mat) @ vmat
    return pt.mT.contiguous(), taus


def launch(panel):
    """``(packed, taus)`` of one CUDA (m, b) panel, in one launch of
    ``csrc/qr_panel.cu``. Counts nothing: each wrapper counts its own."""
    m, b = panel.shape
    if b > MAX_B:
        raise ShapeError(f"qr_panel: b must be ≤ {MAX_B}, got {b}")
    if panel.stride(1) != 1:
        raise ValueError("qr_panel: rows of the panel must be contiguous")
    dev = panel.device
    g, rpc = _build.grid(m, dev, MIN_ROWS_PER_CTA)
    packed = torch.empty((m, b), dtype=panel.dtype, device=dev)
    taus = torch.empty(min(m, b), dtype=panel.dtype, device=dev)
    part_sq = torch.empty(g, dtype=torch.float32, device=dev)
    part_w = torch.empty((g, b), dtype=torch.float32, device=dev)
    alpha = torch.empty(1, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):  # the C entry uses the current device
        code = _build.library().faer_qr_panel(
            panel.data_ptr(), panel.stride(0), packed.data_ptr(),
            taus.data_ptr(), part_sq.data_ptr(), part_w.data_ptr(),
            alpha.data_ptr(), m, b, g, rpc, _build.stream_of(panel))
    _build.check("qr_panel", code)
    return packed, taus


def qr_panel(panel):
    """Householder QR of an (m, b) float32 panel, m, b ≥ 1 (wide too).

    On a CUDA tensor ``b`` must be at most 4096 and rows must be contiguous
    (any row stride); ``m`` may be any size. The result is a new (m, b)
    tensor and a (min(m, b),) tensor of τ.
    """
    _build.check_panel(panel, "qr_panel")
    if panel.device.type == "cpu":
        return qr_panel_plain(panel)
    res = launch(panel)
    count_launch("qr_panel")
    return res
