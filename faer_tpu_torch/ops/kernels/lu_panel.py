"""Kernel 3: ``lu_panel``, the partial-pivot LU of an (m, b) panel.

Counterpart of ``lu_panel_v5_pallas`` (``faer_tpu/ops/pallas/lu_panel_v5.py:157``,
body ``:78``). Returns ``(packed, perm, nt, ok)``: ``packed`` holds unit-lower
L (strict) and U with ``panel[perm] = L·U``, ``perm`` is int64, ``nt`` the
minimal transposition count of ``perm`` (int32) and ``ok`` whether no pivot
was exactly zero.

Both versions produce the virtual-pivot panel (rows never swapped) and the
pivot row of each column; :func:`_assemble` then builds ``perm``, ``packed``
and ``nt`` exactly as the TPU wrapper does after its ``pallas_call``
(``lu_panel_v5.py:193-205``). Pivot ties go to the lowest row index, as in
``jax.lax.argmax``. The CUDA kernel (``csrc/lu_panel_batched.cu``) is one
cooperative grid with one grid barrier per column, over one panel or a
stack of them (:func:`launch_batched`); it serves every virtual-pivot LU
wrapper (``lu_panel``, ``lu_leaf``, ``lu_panel_v2``, ``lu_panel_v3``).
:func:`lu_panel_plain` follows the Pallas body: transposed panel,
``sb``-column sub-blocks of rank-1 steps, and Neumann-coupled deferred
updates across sub-blocks.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from faer_tpu_torch.core.config import count_launch
from faer_tpu_torch.core.perm import perm_transposition_count
from faer_tpu_torch.ops.kernels import _build
from faer_tpu_torch.ops.kernels.llt_panel import _neumann_unit_inv

MIN_ROWS_PER_CTA = 8


def _assemble(virt, pidx, ok):
    """perm, packed and nt from the virtual-pivot panel and the pivot rows:
    pivot rows first, in elimination order, then the rest in their order.
    ``virt`` (..., m, b) and ``pidx`` (..., kmax) may carry batch dims."""
    m = virt.shape[-2]
    kmax = pidx.shape[-1]
    dev = virt.device
    big = m + kmax
    ranks = torch.full((*virt.shape[:-2], m), big, dtype=torch.long, device=dev)
    steps = torch.arange(kmax, dtype=torch.long, device=dev).expand(pidx.shape)
    ranks.scatter_(-1, pidx.long(), steps)
    ranks = torch.where(ranks < big, ranks,
                        kmax + torch.arange(m, dtype=torch.long, device=dev))
    perm = torch.argsort(ranks, dim=-1)
    packed = torch.gather(virt, -2, perm.unsqueeze(-1).expand(virt.shape))
    return packed, perm, perm_transposition_count(perm), ok


def lu_panel_plain(panel, *, sb: int = 16):
    """Plain PyTorch version of the LU panel (same contract)."""
    m, b = panel.shape
    kmax = min(m, b)
    dev = panel.device
    # (b, m), rows = columns of the panel: a fresh copy, updated in place
    pt = panel.mT.clone(memory_format=torch.contiguous_format)
    lanes = torch.arange(m, device=dev)
    used = torch.zeros(m, dtype=panel.dtype, device=dev)
    ok = torch.ones((), dtype=torch.bool, device=dev)
    pidx = torch.empty(kmax, dtype=torch.long, device=dev)
    for sb0 in range(0, kmax, sb):
        nj = min(sb, kmax - sb0)
        mmat = panel.new_zeros((sb, m))
        smat = panel.new_zeros((sb, m))
        top = min(sb0 + sb, b)
        for jl in range(nj):
            r = sb0 + jl
            colj = pt[r].clone()
            mag = torch.where(used != 0, -torch.ones_like(colj), colj.abs())
            p = torch.argmax(mag)  # first maximal index: the lowest row
            onehot = (lanes == p).to(panel.dtype)
            pv = (onehot * colj).sum()
            ok = ok & (pv != 0)
            safe = torch.where(pv == 0, torch.ones_like(pv), pv)
            dead = (used + onehot) != 0
            mult = torch.where(dead, torch.zeros_like(colj), colj * (1.0 / safe))
            pt[r] = torch.where(dead, colj, mult)
            mmat[jl] = mult
            smat[jl] = onehot
            if jl < nj - 1:
                rest = pt[r + 1:top]
                uvals = rest @ onehot  # exact one-hot selection
                pt[r + 1:top] = rest - uvals[:, None] * mult[None, :]
            used = used + onehot
            pidx[r] = p
        sb_end = sb0 + sb
        if sb_end >= b:
            continue
        # deferred update of the later columns through the unit-lower coupling
        lsub = mmat @ smat.mT
        eye = torch.eye(sb, dtype=panel.dtype, device=dev)
        n_inv = _neumann_unit_inv(lsub.mT * (1.0 - eye), sb)
        chunk = pt[sb_end:b]
        yp = (chunk @ smat.mT) @ n_inv.mT
        pt[sb_end:b] = chunk - yp @ mmat
    return _assemble(pt.mT, pidx, ok)


@functools.lru_cache(maxsize=None)
def batched_grid(g: int, m: int, b: int, device) -> tuple[int, int]:
    """(CTAs a panel, rows per CTA) that ``faer_lu_panel_batched_grid``
    picks for g panels of (m, b) on ``device``'s card; asked once a shape."""
    ctas, rpc = ctypes.c_int(), ctypes.c_int()
    with torch.cuda.device(device):  # the C entry uses the current device
        _build.check("lu_panel", _build.library().faer_lu_panel_batched_grid(
            g, m, b, MIN_ROWS_PER_CTA, ctypes.byref(ctas), ctypes.byref(rpc)))
    return ctas.value, rpc.value


def _launch(panels):
    """Launch ``faer_lu_panel_batched`` on a CUDA (g, m, b) stack whose rows
    are contiguous (any row and panel strides), on the grid of
    :func:`batched_grid`: the virtual-pivot panels (g, m, b), the pivot rows
    of the min(m, b) steps (g, min(m, b)) and ``ok`` (g,) as int32. Raises
    when g panels cannot be co-resident even at one CTA each."""
    if panels.stride(2) != 1:
        raise ValueError("lu_panel: rows of the panels must be contiguous")
    g, m, b = panels.shape
    dev = panels.device
    ctas, rpc = batched_grid(g, m, b, dev)
    with torch.cuda.device(dev):  # the C entry uses the current device
        virt = torch.empty((g, m, b), dtype=panels.dtype, device=dev)
        pidx = torch.empty((g, b), dtype=torch.int32, device=dev)
        okf = torch.empty(g, dtype=torch.int32, device=dev)
        slots = 2 * g * ctas  # per panel and column parity, one per CTA
        cand_val = torch.empty(slots, dtype=torch.float32, device=dev)
        cand_idx = torch.empty(slots, dtype=torch.int32, device=dev)
        cand_row = torch.empty((slots, b), dtype=torch.float32, device=dev)
        code = _build.library().faer_lu_panel_batched(
            panels.data_ptr(), panels.stride(0), panels.stride(1),
            virt.data_ptr(), pidx.data_ptr(), okf.data_ptr(), cand_val.data_ptr(),
            cand_idx.data_ptr(), cand_row.data_ptr(), g, m, b, ctas, rpc,
            _build.stream_of(panels))
    _build.check("lu_panel", code)
    return virt, pidx[:, :min(m, b)], okf


def launch_batched(panels):
    """``(packed, perm, nt, ok)`` of each panel of a CUDA (g, m, b) stack,
    each with a leading dim of g, in one launch. Counts nothing: each
    wrapper that calls it counts its own launches."""
    virt, pidx, okf = _launch(panels)
    return _assemble(virt, pidx, okf != 0)


def launch(panel):
    """``(packed, perm, nt, ok)`` of one CUDA (m, b) panel, in one launch.
    Counts nothing."""
    virt, pidx, okf = _launch(panel.unsqueeze(0))
    return _assemble(virt[0], pidx[0], okf[0] != 0)


def lu_panel(panel):
    """Partial-pivot LU of an (m, b) float32 panel, m, b ≥ 1. A wide panel
    (m < b) takes m steps and comes back whole, U₁₂ = L₁₁⁻¹·A₁₂ right of
    column m, as the Pallas kernel returns it.

    On a CUDA tensor the rows must be contiguous (any row stride).
    """
    _build.check_panel(panel, "lu_panel")
    if panel.device.type == "cpu":
        return lu_panel_plain(panel)
    res = launch(panel)
    count_launch("lu_panel")
    return res
