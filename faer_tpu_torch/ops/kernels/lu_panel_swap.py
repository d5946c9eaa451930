"""Kernel 16: ``lu_panel_swap``, the LU panel that swaps rows.

Counterpart of the first-version ``lu_panel_pallas``
(``faer_tpu/ops/pallas/panel_kernels.py:81``, body ``:35``). Returns
``(packed, perm, nt, ok)`` with ``panel[perm] = L·U``, as the other LU
panels do, but it is another function of the panel than the virtual-pivot
kernels':

* rows are swapped physically, so each column's argmax sees the row order
  the earlier swaps left, and a pivot tie goes to the lowest *current*
  position ≥ j;
* each column is one rank-1 update of the whole trailing panel;
* ``perm`` is the identity with every swap applied;
* ``nt`` is the number of steps whose pivot was not already in place
  (``panel_kernels.py:58``), not the transposition count of ``perm``: the
  same parity, another number.

:func:`lu_panel_swap_plain` is a column loop with exactly these semantics
in f32, the twin of the JAX package's non-kernel ``_panel_lu``
(``faer_tpu/linalg/lu.py:34-76``). The CUDA kernel is ``csrc/lu_panel_swap.cu``:
one cooperative grid over row positions, one grid barrier per column.
"""
from __future__ import annotations

import torch

from faer_tpu_torch.core.config import count_launch
from faer_tpu_torch.ops.kernels import _build

MIN_ROWS_PER_CTA = 8


def lu_panel_swap_plain(panel):
    """Plain PyTorch version of ``lu_panel_swap`` (same contract)."""
    m, b = panel.shape
    kmax = min(m, b)
    dev = panel.device
    a = panel.clone(memory_format=torch.contiguous_format)
    perm = torch.arange(m, dtype=torch.long, device=dev)
    nt = torch.zeros((), dtype=torch.int32, device=dev)
    ok = torch.ones((), dtype=torch.bool, device=dev)
    for j in range(kmax):
        # first maximal position ≥ j: ties to the lowest current position
        p = j + torch.argmax(a[j:, j].abs())
        jp = torch.stack([p.new_tensor(j), p])
        pj = jp.flip(0)
        a[jp] = a[pj]
        perm[jp] = perm[pj]
        nt = nt + (p != j).to(torch.int32)
        pivot = a[j, j]
        ok = ok & (pivot != 0)
        safe = torch.where(pivot == 0, torch.ones_like(pivot), pivot)
        a[j + 1:, j] = a[j + 1:, j] / safe
        # the product rounded before the subtraction, as in the Pallas body
        a[j + 1:, j + 1:] -= a[j + 1:, j, None] * a[j, None, j + 1:]
    return a, perm, nt, ok


def lu_panel_swap(panel):
    """Partial-pivot LU with row swaps of an (m, b) float32 panel,
    m, b ≥ 1 (wide too: min(m, b) steps). On a CUDA tensor the rows must
    be contiguous (any row stride)."""
    _build.check_panel(panel, "lu_panel_swap")
    if panel.device.type == "cpu":
        return lu_panel_swap_plain(panel)
    if panel.stride(1) != 1:
        raise ValueError("lu_panel_swap: rows of the panel must be contiguous")
    m, b = panel.shape
    dev = panel.device
    g, rpc = _build.grid(m, dev, MIN_ROWS_PER_CTA)
    out = torch.empty((m, b), dtype=panel.dtype, device=dev)
    perm = torch.empty(m, dtype=torch.int32, device=dev)
    nt = torch.empty(1, dtype=torch.int32, device=dev)
    okf = torch.empty(1, dtype=torch.int32, device=dev)
    cand_val = torch.empty(2 * g, dtype=torch.float32, device=dev)
    cand_idx = torch.empty(2 * g, dtype=torch.int32, device=dev)
    cand_perm = torch.empty(2 * g, dtype=torch.int32, device=dev)
    cand_row = torch.empty((2 * g, b), dtype=torch.float32, device=dev)
    rowj = torch.empty((2, b), dtype=torch.float32, device=dev)
    rowj_perm = torch.empty(2, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):  # the C entry uses the current device
        code = _build.library().faer_lu_panel_swap(
            panel.data_ptr(), panel.stride(0), out.data_ptr(), perm.data_ptr(),
            nt.data_ptr(), okf.data_ptr(), cand_val.data_ptr(), cand_idx.data_ptr(),
            cand_perm.data_ptr(), cand_row.data_ptr(), rowj.data_ptr(),
            rowj_perm.data_ptr(), m, b, g, rpc, _build.stream_of(panel))
    _build.check("lu_panel_swap", code)
    count_launch("lu_panel_swap")
    return out, perm.long(), nt[0], okf[0] != 0
