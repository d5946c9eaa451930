"""Kernels 17 and 19: the unblocked LLT of one (b, b) diagonal block.

Counterparts of ``faer_tpu/ops/pallas/panel_kernels.py``:

* :func:`llt_block` of ``llt_block_pallas`` (``:151``, body
  ``_llt_block_kernel`` ``:116``), a column loop: per column a pivot, the
  scaled column and a rank-1 update of the trailing block;
* :func:`llt_block_v3` of ``llt_block_v3_pallas`` (``:586``, body
  ``_llt_block_v3_kernel`` ``:530``), the same factor in 8-column
  sub-blocks: eager updates inside a sub-block, then one product per
  128-row chunk for the rest of the block.

Contract of both: a (b, b) float32 block, symmetric in full storage, any
b ≥ 1, returns ``(L, count, ok)`` with L lower triangular, the
dynamic-regularization count (int32) and whether every pivot was positive
(bool). Per pivot, as at ``:126-133`` and ``:556-563``: ``ok &= pj > 0``
before any replacement; with ``eps > 0`` a pivot ≤ ``delta`` becomes
``eps`` and is counted; with ``eps = 0`` a pivot ≤ 0 becomes 1. The Pallas
wrappers pad b to a multiple of 128 and loop over the valid columns only,
so the padding changes nothing; neither route here pads.

The plain versions follow the two bodies: v1 reads column j and row j of
the full storage (the two agree on a symmetric block); v3 works in
transposed storage (rows hold L's columns) and returns ``tril(out.T)``.
Both wrappers launch one CUDA kernel (``csrc/llt_block.cu``), one CTA per
block as the Pallas kernels are one program with no grid, templated on the
sub-block width: 1 for v1, 8 for v3. It reads the lower triangle only (the
contract's block is symmetric, so that is the bodies' column read).
"""
from __future__ import annotations

import torch

from faer_tpu_torch.core.config import count_launch
from faer_tpu_torch.core.errors import ShapeError
from faer_tpu_torch.ops.kernels import _build

MAX_B = 1024  # the largest block the CUDA route takes
V1_SUB_BLOCK, V3_SUB_BLOCK = 1, 8  # the kernel's template widths
V3_ROW_CHUNK = 128  # the v3 body's rows per cross-sub-block product
# a CTA's shared memory on the H100 (227 KiB); a block whose packed lower
# triangle fits there is staged in it, a larger one stays in global memory
SMEM_BYTES = 232448


def staged_in_shared_memory(b: int) -> bool:
    """Whether the kernel keeps a (b, b) block's packed lower triangle in
    shared memory (b ≤ 340), else in a global-memory scratch."""
    return b * (b + 1) // 2 * 4 <= SMEM_BYTES


def _pivot(pj, cnt, ok, eps: float, delta: float):
    """One pivot of the bodies: ``(pj, cnt, ok)`` after regularization."""
    f32 = dict(dtype=torch.float32, device=pj.device)
    needs = pj <= torch.tensor(delta, **f32)
    ok = ok & (pj > 0)
    if eps > 0:
        pj = torch.where(needs, torch.tensor(eps, **f32), pj)
        cnt = cnt + needs.to(torch.int32)
    else:
        pj = torch.where(pj <= 0, torch.ones((), **f32), pj)
    return pj, cnt, ok


def _init(block):
    dev = block.device
    return (block.clone(memory_format=torch.contiguous_format),
            torch.zeros((), dtype=torch.int32, device=dev),
            torch.ones((), dtype=torch.bool, device=dev))


def llt_block_plain(block, *, eps: float = 0.0, delta: float = 0.0):
    """Plain PyTorch version of ``llt_block``: the v1 column loop.

    The body's masks ``rows > j`` and ``lanes > j`` select the slices
    written here; outside them it subtracts 0, which changes no value.
    """
    b = block.shape[0]
    o, cnt, ok = _init(block)
    for j in range(b):
        pj, cnt, ok = _pivot(o[j, j].clone(), cnt, ok, eps, delta)
        piv = torch.sqrt(pj)
        col = o[j + 1:, j] / piv       # column j below the pivot
        col_t = o[j, j + 1:] / piv     # row j right of it (the same values)
        o[j + 1:, j + 1:] -= col[:, None] * col_t[None, :]
        o[j + 1:, j] = col
        o[j, j] = piv
    return torch.tril(o), cnt, ok


def llt_block_v3_plain(block, *, eps: float = 0.0, delta: float = 0.0):
    """Plain PyTorch version of ``llt_block_v3``: 8-column sub-blocks in
    transposed storage, eager updates inside a sub-block, the update of the
    rows below it as one product per 128-row chunk."""
    b = block.shape[0]
    sb = V3_SUB_BLOCK
    o, cnt, ok = _init(block)
    for sb0 in range(0, b, sb):
        nj = min(sb, b - sb0)
        for jl in range(nj):
            j = sb0 + jl
            pj, cnt, ok = _pivot(o[j, j].clone(), cnt, ok, eps, delta)
            piv = torch.sqrt(pj)
            o[j, j + 1:] /= piv  # lanes below j keep their values
            o[j, j] = piv
            if jl < nj - 1:
                col = o[j]
                uv = col[j + 1:sb0 + nj, None]  # L[c, j] of the sub-block's rows
                o[j + 1:sb0 + nj] -= uv * col[None, :]
        sb_end = sb0 + sb
        if sb_end >= b:
            continue
        m = o[sb0:sb_end]  # the sub-block's final columns of L
        for c0 in range(sb_end, b, V3_ROW_CHUNK):
            cw = min(V3_ROW_CHUNK, b - c0)
            o[c0:c0 + cw] -= m[:, c0:c0 + cw].mT @ m
    return torch.tril(o.mT), cnt, ok


def _check(block, name: str) -> None:
    _build.check_f32_matrix(block, name)
    b = block.shape[0]
    if block.shape[1] != b or b < 1:
        raise ShapeError(f"{name}: needs a square block, got {tuple(block.shape)}")


def _launch(block, sb: int, eps: float, delta: float, name: str):
    """Launch ``faer_llt_block`` at sub-block width ``sb`` on a CUDA block
    and return ``(L, count, ok)``."""
    b = block.shape[0]
    if b > MAX_B:
        raise ShapeError(f"{name}: b must be ≤ {MAX_B}, got {b}")
    if block.stride(1) != 1:
        raise ValueError(f"{name}: rows of the block must be contiguous")
    out = torch.empty((b, b), dtype=block.dtype, device=block.device)
    work = (None if staged_in_shared_memory(b)
            else torch.empty(b * b, dtype=block.dtype, device=block.device))
    cnt_ok = torch.empty(2, dtype=torch.int32, device=block.device)
    with torch.cuda.device(block.device):  # the C entry uses the current device
        code = _build.library().faer_llt_block(
            block.data_ptr(), block.stride(0), out.data_ptr(),
            None if work is None else work.data_ptr(), cnt_ok.data_ptr(), b, sb,
            float(eps), float(delta), int(eps > 0), _build.stream_of(block))
    _build.check(name, code)
    return out, cnt_ok[0], cnt_ok[1] != 0


def llt_block(block, *, eps: float = 0.0, delta: float = 0.0):
    """Unblocked LLT of a (b, b) float32 symmetric block, v1 order.

    Returns ``(L, count, ok)``. On a CUDA tensor b must be at most
    ``MAX_B`` and the rows contiguous (any row stride).
    """
    _check(block, "llt_block")
    if block.device.type == "cpu":
        return llt_block_plain(block, eps=eps, delta=delta)
    res = _launch(block, V1_SUB_BLOCK, eps, delta, "llt_block")
    count_launch("llt_block")
    return res


def llt_block_v3(block, *, eps: float = 0.0, delta: float = 0.0):
    """Unblocked LLT of a (b, b) float32 symmetric block, v3 order (8-column
    sub-blocks). Same contract and limits as :func:`llt_block`."""
    _check(block, "llt_block_v3")
    if block.device.type == "cpu":
        return llt_block_v3_plain(block, eps=eps, delta=delta)
    res = _launch(block, V3_SUB_BLOCK, eps, delta, "llt_block_v3")
    count_launch("llt_block_v3")
    return res
