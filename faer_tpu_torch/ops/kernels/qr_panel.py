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

The CUDA kernel (``csrc/qr_panel.cu``) applies each reflector to all
later columns at once and exchanges one set of shares a column between its
CTAs: ‖tail‖² and tailᵀ·A_tail together, with w = A[j, j+1:] +
s·(tailᵀ·A_tail), s = 1/(α − β). It takes one of two routes, which its C
entry alone decides from (m, b) and the card (:func:`route` asks it): a
thread-block cluster whose CTAs hold the rows in shared memory (one cluster
barrier a column), or a cooperative grid (one grid barrier a column).
:func:`qr_panel_onepass_plain` follows that order of operations, for the
tests and ``chip_smoke.py``; no wrapper runs it. :func:`qr_panel_plain`
follows the Pallas body: transposed panel, ``sb``-column sub-blocks of
rank-1 reflector steps, then the sub-block's compact-WY T (Neumann
inverse) and a deferred block update of the later columns. The orders of
rounding differ; the function is the same. :func:`launch` is the CUDA route
that every QR panel wrapper of the port takes (``qr_panel`` here,
``qr_panel_v1``, ``qr_panel_v2``, ``qr_panel_v3`` and ``qr_leaf``), each
behind its own launch counter.
"""
from __future__ import annotations

import ctypes

import torch

from faer_tpu_torch.core.config import count_launch
from faer_tpu_torch.core.errors import ShapeError
from faer_tpu_torch.ops.householder import rescale_of
from faer_tpu_torch.ops.kernels import _build
from faer_tpu_torch.ops.kernels.llt_panel import _neumann_unit_inv

MAX_B = 4096  # the grid route's fixed shared memory, 4·b + 2048 floats, must fit a CTA
ROUTES = {1: "cluster", 0: "grid"}  # faer_qr_panel_route's codes


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
            below = lanes > j
            # the column scaled by an exact power of two where its squares
            # lose bits (F2; ops/householder.py:rescale_of), else by 1
            sq0 = torch.where(below, pt[j] * pt[j], 0.0).sum()
            scale = rescale_of(pt[j, j] * pt[j, j] + sq0)
            colj = pt[j] * scale
            alpha = colj[j]
            tail_sq = torch.where(below, colj * colj, 0.0).sum()
            norm = torch.sqrt(alpha * alpha + tail_sq)
            sign = torch.where(alpha >= 0, one, -one)
            beta = -sign * norm
            is_id = tail_sq == 0
            safe_s = torch.where(is_id, one, alpha - beta)
            safe_b = torch.where(is_id, one, beta)
            tau = torch.where(is_id, 0.0, (beta - alpha) / safe_b)
            beta = torch.where(is_id, alpha, beta) / scale
            v = torch.where(below & ~is_id, colj * (1.0 / safe_s), 0.0)
            v[j] = 1.0
            taus[j] = tau
            tau_v[jl] = tau
            vmat[jl] = v
            pt[j] = torch.where(lanes == j, beta, torch.where(below, v, pt[j]))
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


def qr_panel_onepass_plain(panel):
    """Plain PyTorch version of the CUDA kernel's order (same contract): a
    column loop that forms ‖tail‖² and tailᵀ·A_tail together, then the
    fused w = A[j, j+1:] + s·(tailᵀ·A_tail) with s = 1/(α − β), and applies
    A[j:, j+1:] −= τ v wᵀ with v = [1; s·tail]. For the tests; no wrapper
    runs it."""
    m, b = panel.shape
    kmax = min(m, b)
    a = panel.clone(memory_format=torch.contiguous_format)
    taus = panel.new_zeros(kmax)
    one = panel.new_ones(())
    for j in range(kmax):
        alpha0 = a[j, j].clone()
        tail = a[j + 1:, j].clone()
        shares = tail @ a[j + 1:, j + 1:]  # tailᵀ·A_tail, with ‖tail‖² one pass
        # F2: where the column's squares lose bits the kernel forms the
        # reflector on the column scaled by 2⁶⁴ and, in two more exchanges,
        # w from v itself: w = A[j, j+1:] + vᵀ·A_tail
        scale = rescale_of(alpha0 * alpha0 + (tail * tail).sum())
        alpha, tail = alpha0 * scale, tail * scale
        tail_sq = (tail * tail).sum()
        norm = torch.sqrt(alpha * alpha + tail_sq)
        beta = torch.where(alpha >= 0, -norm, norm)
        is_id = tail_sq == 0
        tau = torch.where(is_id, 0.0, (beta - alpha) / torch.where(is_id, one, beta))
        s = torch.where(is_id, one, 1.0 / torch.where(is_id, one, alpha - beta))
        v = torch.where(is_id, 0.0, tail * s)
        w = torch.where(scale == 1, a[j, j + 1:] + s * shares,
                        a[j, j + 1:] + v @ a[j + 1:, j + 1:])
        a[j, j + 1:] -= tau * w
        a[j + 1:, j + 1:] -= (tau * v)[:, None] * w[None, :]
        a[j, j] = torch.where(is_id, alpha0, beta / scale)
        a[j + 1:, j] = v
        taus[j] = tau
    return a, taus


def route(m: int, b: int, device=None) -> tuple[str, int, int]:
    """``(route, CTAs, scratch floats)`` of an (m, b) panel on a CUDA card,
    as the kernel's C entry ``faer_qr_panel_route`` decides them from (m, b)
    and the card: ``"cluster"`` (the rows in the shared memory of one
    thread-block cluster) or ``"grid"`` (a cooperative grid). Loads the
    kernel library, which is built with ``nvcc`` at first use."""
    ctas, scratch = ctypes.c_int(), ctypes.c_longlong()
    with torch.cuda.device(device):  # the C entry reads the current device
        code = _build.library().faer_qr_panel_route(
            m, b, ctypes.byref(ctas), ctypes.byref(scratch))
    if code == -1:
        raise ShapeError(f"qr_panel: needs m ≥ 1 and 1 ≤ b ≤ {MAX_B}, got {(m, b)}")
    if code not in ROUTES:
        raise RuntimeError(f"qr_panel: the device query failed with CUDA error {-code - 2}")
    return ROUTES[code], ctas.value, scratch.value


def cluster_edge(b: int, device=None) -> int:
    """The largest m whose (m, b) panel :func:`route` sends to the cluster
    route on a CUDA card (bisection; 0 if none), for the card checks of
    both sides of the edge."""
    lo, hi = 1, 1 << 20  # cluster at lo, grid at hi
    if route(lo, b, device)[0] != "cluster":
        return 0
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if route(mid, b, device)[0] == "cluster" else (lo, mid)
    return lo


def launch(panel):
    """``(packed, taus)`` of one CUDA (m, b) panel, in one launch of
    ``csrc/qr_panel.cu``. Counts nothing: each wrapper counts its own."""
    m, b = panel.shape
    if b > MAX_B:
        raise ShapeError(f"qr_panel: b must be ≤ {MAX_B}, got {b}")
    if panel.stride(1) != 1:
        raise ValueError("qr_panel: rows of the panel must be contiguous")
    dev = panel.device
    _, _, nscratch = route(m, b, dev)
    packed = torch.empty((m, b), dtype=panel.dtype, device=dev)
    taus = torch.empty(min(m, b), dtype=panel.dtype, device=dev)
    scratch = torch.empty(max(nscratch, 1), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):  # the C entry uses the current device
        code = _build.library().faer_qr_panel(
            panel.data_ptr(), panel.stride(0), packed.data_ptr(), taus.data_ptr(),
            scratch.data_ptr(), nscratch, m, b, _build.stream_of(panel))
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
