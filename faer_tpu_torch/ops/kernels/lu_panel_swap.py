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
the rows held by the CTAs of one thread-block cluster (a cooperative grid
past its shared memory), one exchange a column, a swap done by relabelling
rows rather than moving them. It repeats the plain version's IEEE
operations one by one, so its results equal :func:`lu_panel_swap_plain`'s
to the bit on every route.
"""
from __future__ import annotations

import ctypes

import torch

from faer_tpu_torch.core.config import count_launch
from faer_tpu_torch.core.errors import ShapeError
from faer_tpu_torch.ops.kernels import _build

# faer_lu_panel_swap_route's codes: 2 is the grid route with the rows in
# global memory, for panels whose rows do not fit the CTAs' shared memory
ROUTES = {1: "cluster", 0: "grid", 2: "grid, rows in global memory"}


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


def route(m: int, b: int, device=None) -> tuple[str, int, int]:
    """``(route, CTAs, scratch floats)`` of an (m, b) panel on a CUDA card,
    as the kernel's C entry ``faer_lu_panel_swap_route`` decides them from
    (m, b) and the card (a key of ``ROUTES``' values). Loads the kernel
    library, which is built with ``nvcc`` at first use. Raises
    ``ShapeError`` for a shape no route takes."""
    ctas, scratch = ctypes.c_int(), ctypes.c_longlong()
    with torch.cuda.device(device):  # the C entry reads the current device
        code = _build.library().faer_lu_panel_swap_route(
            m, b, ctypes.byref(ctas), ctypes.byref(scratch))
    if code == -1:
        raise ShapeError(f"lu_panel_swap: no route takes {(m, b)} on this card")
    if code not in ROUTES:
        raise RuntimeError(f"lu_panel_swap: the device query failed with CUDA error {-code - 2}")
    return ROUTES[code], ctas.value, scratch.value


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
    _, _, nscratch = route(m, b, dev)
    out = torch.empty((m, b), dtype=panel.dtype, device=dev)
    perm = torch.empty(m, dtype=torch.long, device=dev)
    nt = torch.empty(1, dtype=torch.int32, device=dev)
    ok = torch.empty(1, dtype=torch.bool, device=dev)
    scratch = torch.empty(nscratch, dtype=torch.float32, device=dev) if nscratch else None
    with torch.cuda.device(dev):  # the C entry uses the current device
        code = _build.library().faer_lu_panel_swap(
            panel.data_ptr(), panel.stride(0), out.data_ptr(), perm.data_ptr(),
            nt.data_ptr(), ok.data_ptr(), None if scratch is None else scratch.data_ptr(),
            nscratch, m, b, _build.stream_of(panel))
    _build.check("lu_panel_swap", code)
    count_launch("lu_panel_swap")
    return out, perm, nt[0], ok[0]
