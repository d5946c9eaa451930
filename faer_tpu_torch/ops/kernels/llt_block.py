"""Kernels 17 and 19 (and 6): the LLT of one (b, b) diagonal block.

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

On a CUDA tensor both wrappers, and ``leaf.llt_leaf`` (``llt_block_v4_pallas``,
the same function again), launch one blocked kernel,
``csrc/llt_block.cu``, through :func:`launch`, each behind its own launch
counter: one CTA a block, as the Pallas kernels are one program with no
grid, walking 32-column panels (a warp-register diagonal tile, a
substitution solve of the rows below it, a rank-32 update of the trailing
lower triangle). It reads the lower triangle only. Its order of rounding is
neither body's: :func:`llt_block_blocked_plain` follows it, for the tests;
no wrapper runs it. Blocks up to b = 337 stay in shared memory, larger ones
(to 1024) in an L2-resident copy in the output; the kernel's C entry alone
decides which, and :func:`route` asks it.
"""
from __future__ import annotations

import torch

from faer_tpu_torch.core.config import count_launch
from faer_tpu_torch.core.errors import ShapeError
from faer_tpu_torch.ops.kernels import _build

MAX_B = 1024  # the largest block the CUDA route takes
V3_SUB_BLOCK = 8  # the v3 body's sub-block width
V3_ROW_CHUNK = 128  # the v3 body's rows per cross-sub-block product
PANEL = 32  # the kernel's panel width


def route(b: int) -> str:
    """The kernel's route for a (b, b) block, as its C entry
    ``faer_llt_block_route`` decides it: ``"shared"`` (b ≤ 337) or ``"L2"``
    (338 ≤ b ≤ 1024), fixed by b. Loads the kernel library, which is built
    with ``nvcc`` at first use."""
    code = _build.library().faer_llt_block_route(b)
    if code < 0:
        raise ShapeError(f"llt_block: b must be in 1..{MAX_B}, got {b}")
    return "shared" if code else "L2"


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


def llt_block_blocked_plain(block, *, eps: float = 0.0, delta: float = 0.0,
                            nb: int = PANEL):
    """Plain PyTorch version of the CUDA kernel's order, for the tests: the
    lower triangle in ``nb``-column panels; the diagonal tile column by
    column, each column scaled by rs = 1/√pivot; the rows below it by
    substitution, x_j = a_j·rs_j then a_c −= x_j·L[c, j] for c > j; the
    trailing block minus P·Pᵀ."""
    b = block.shape[0]
    cnt = torch.zeros((), dtype=torch.int32, device=block.device)
    ok = torch.ones((), dtype=torch.bool, device=block.device)
    o = torch.tril(block)
    for k0 in range(0, b, nb):
        k1 = min(k0 + nb, b)
        d = o[k0:k1, k0:k1]
        rs = []
        for j in range(k1 - k0):
            pj, cnt, ok = _pivot(d[j, j].clone(), cnt, ok, eps, delta)
            rs.append(torch.rsqrt(pj))
            d[j, j] = pj * rs[j]
            d[j + 1:, j] *= rs[j]
            d[j + 1:, j + 1:] -= d[j + 1:, j, None] * d[None, j + 1:, j]
        if k1 == b:
            break
        x = o[k1:, k0:k1]
        for j in range(k1 - k0):
            x[:, j] *= rs[j]
            x[:, j + 1:] -= x[:, j, None] * d[None, j + 1:, j]
        o[k1:, k1:] -= x @ x.mT
    return torch.tril(o), cnt, ok


def check_block(block, name: str) -> None:
    """Raise unless ``block`` is a square float32 (b, b) tensor, b ≥ 1, on
    the CPU or a CUDA card."""
    _build.check_f32_matrix(block, name)
    b = block.shape[0]
    if block.shape[1] != b or b < 1:
        raise ShapeError(f"{name}: needs a square block, got {tuple(block.shape)}")


def launch(block, eps: float, delta: float, name: str):
    """Launch ``faer_llt_block`` on a CUDA block (b ≤ ``MAX_B``, contiguous
    rows, any row stride) and return ``(L, count, ok)``. The kernel writes
    the count and ok into one 8-byte buffer, returned as two views, so no
    second launch reads them. Counts nothing: each wrapper that calls it
    counts its own launches."""
    b = block.shape[0]
    if b > MAX_B:
        raise ShapeError(f"{name}: b must be ≤ {MAX_B}, got {b}")
    if block.stride(1) != 1:
        raise ValueError(f"{name}: rows of the block must be contiguous")
    out = torch.empty((b, b), dtype=block.dtype, device=block.device)
    tallies = torch.empty(8, dtype=torch.uint8, device=block.device)
    with torch.cuda.device(block.device):  # the C entry uses the current device
        code = _build.library().faer_llt_block(
            block.data_ptr(), block.stride(0), out.data_ptr(), tallies.data_ptr(),
            b, float(eps), float(delta), int(eps > 0), _build.stream_of(block))
    _build.check(name, code)
    return out, tallies[:4].view(torch.int32)[0], tallies[4:5].view(torch.bool)[0]


def llt_block(block, *, eps: float = 0.0, delta: float = 0.0):
    """LLT of a (b, b) float32 symmetric block; on the CPU in the v1 order.

    Returns ``(L, count, ok)``. On a CUDA tensor b must be at most
    ``MAX_B`` and the rows contiguous (any row stride).
    """
    check_block(block, "llt_block")
    if block.device.type == "cpu":
        return llt_block_plain(block, eps=eps, delta=delta)
    res = launch(block, eps, delta, "llt_block")
    count_launch("llt_block")
    return res


def llt_block_v3(block, *, eps: float = 0.0, delta: float = 0.0):
    """LLT of a (b, b) float32 symmetric block; on the CPU in the v3 order
    (8-column sub-blocks). Same contract and limits as :func:`llt_block`."""
    check_block(block, "llt_block_v3")
    if block.device.type == "cpu":
        return llt_block_v3_plain(block, eps=eps, delta=delta)
    res = launch(block, eps, delta, "llt_block_v3")
    count_launch("llt_block_v3")
    return res
