"""Kernel 2: ``llt_panel``, the fused LLT panel step of an (m, b) slab.

Counterpart of ``llt_panel_v5_pallas`` (``faer_tpu/ops/pallas/llt_panel_v5.py:176``,
body ``:97``). Returns ``(strip, count, ok)``: ``strip[:b] = L11`` (lower
triangular), ``strip[b:] = L21 = A21·L11⁻ᵀ``, the dynamic-regularization
count (int32) and whether every pivot was positive (bool).

The CUDA kernel (``csrc/llt_panel.cu``) is two launches behind one entry
point: a one-CTA factor of A11 that also forms inv(L11), then a tiled FP32
product for L21. :func:`llt_panel_plain` follows the Pallas body's math:
mirror, ``sb``-row register micro-steps, Neumann-coupled cross-sub-block
updates, and L21 against a 128-blocked Neumann inverse of L11ᵀ.
"""
from __future__ import annotations

import torch

from faer_tpu_torch.core.config import count_launch
from faer_tpu_torch.core.errors import ShapeError
from faer_tpu_torch.ops.kernels import _build

SUB_BLOCK = 32  # the CUDA kernel's factor sub-block; b must be a multiple
MAX_B = 512


def _neumann_unit_inv(r, nb: int):
    """(I + R)⁻¹ for strictly triangular R by log-depth doubling (nb ≤ 128)."""
    eye = torch.eye(nb, dtype=r.dtype, device=r.device)
    p = -r
    s = eye + p
    span = 2
    while span < nb:
        p = p @ p
        s = s + p @ s
        span *= 2
    return s


def _upper_inv_blocked(u, b: int):
    """U⁻¹ for an upper-triangular (b, b) U: Neumann doubling at ≤ 128, a
    recursive 2×2 combine above (``llt_panel_v5.py:74-94``)."""
    if b <= 128:
        u = torch.triu(u)
        d = torch.diagonal(u)[:, None]
        r_up = torch.triu(u, 1) / d
        return _neumann_unit_inv(r_up, b) / d.reshape(1, b)
    h = b // 2
    i1 = _upper_inv_blocked(u[:h, :h], h)
    i2 = _upper_inv_blocked(u[h:, h:], b - h)
    top = torch.cat([i1, -((i1 @ u[:h, h:]) @ i2)], dim=1)
    bot = torch.cat([u.new_zeros((b - h, h)), i2], dim=1)
    return torch.cat([top, bot], dim=0)


def llt_panel_plain(slab, *, eps: float = 0.0, delta: float = 0.0,
                    sb: int = 32):
    """Plain PyTorch version of the fused LLT panel (same contract)."""
    m, b = slab.shape
    dev = slab.device
    lanes = torch.arange(b, device=dev)[None, :]
    iu = torch.arange(b, device=dev)[:, None]
    cnt = torch.zeros((), dtype=torch.int32, device=dev)
    ok = torch.ones((), dtype=torch.bool, device=dev)
    dlow = slab[:b]
    # 1. mirror: d holds the diagonal block with ROWS = columns of L
    d = torch.where(iu >= lanes, dlow, dlow.mT)
    # 2. factor in sb-row strips of rank-1 micro-steps
    for sb0 in range(0, b, sb):
        nj = min(sb, b - sb0)
        subi = torch.arange(nj, device=dev)[:, None]
        strip = d[sb0:sb0 + nj]
        for jl in range(nj):
            j = sb0 + jl
            rowj = strip[jl:jl + 1]
            pj = rowj[0, j]
            needs = pj <= delta
            ok = ok & (pj > 0)
            if eps > 0:
                pj = torch.where(needs, torch.full_like(pj, eps), pj)
                cnt = cnt + needs.to(torch.int32)
            else:
                pj = torch.where(pj <= 0, torch.ones_like(pj), pj)
            rs = torch.rsqrt(pj)
            col = torch.where(lanes == j, pj * rs,
                              torch.where(lanes > j, rowj * rs, rowj))
            if jl < nj - 1:
                uv = strip[:, j:j + 1] * rs
                strip = torch.where(subi > jl, strip - uv * col,
                                    torch.where(subi == jl, col, strip))
            else:
                strip = torch.where(subi == jl, col, strip)
        d = torch.cat([d[:sb0], strip, d[sb0 + nj:]], dim=0)
        sb_end = sb0 + nj
        if sb_end >= b:
            continue
        # cross-sub-block Schur update: W = C·U11⁻¹; C −= W·M
        u11 = torch.triu(strip[:, sb0:sb_end])
        dd = torch.diagonal(u11)[:, None]
        uinv = _neumann_unit_inv(torch.triu(u11, 1) / dd, nj) / dd.reshape(1, nj)
        c = d[sb_end:]
        w = c[:, sb0:sb_end] @ uinv
        d = torch.cat([d[:sb_end], c - w @ strip], dim=0)
    # 3. L11 = (d rows)ᵀ, lower
    l11 = torch.tril(d.mT)
    if m == b:
        return l11, cnt, ok
    # 4. panel TRSM: L21 = A21 · (L11ᵀ)⁻¹
    l21 = slab[b:] @ _upper_inv_blocked(torch.triu(d), b)
    return torch.cat([l11, l21], dim=0), cnt, ok


def launch(slab, eps: float, delta: float):
    """Launch ``faer_llt_panel`` on a CUDA slab (b a multiple of 32, at most
    512, contiguous rows) and return ``(strip, count, ok)``. Counts nothing:
    each wrapper that calls it counts its own launches."""
    m, b = slab.shape
    if b % SUB_BLOCK or b > MAX_B:
        raise ShapeError(f"llt_panel: b must be a multiple of {SUB_BLOCK} "
                         f"and ≤ {MAX_B}, got {b}")
    if slab.stride(1) != 1:
        raise ValueError("llt_panel: rows of the slab must be contiguous")
    out = torch.empty((m, b), dtype=slab.dtype, device=slab.device)
    xinv = torch.empty((b, b), dtype=slab.dtype, device=slab.device)
    cnt_ok = torch.empty(2, dtype=torch.int32, device=slab.device)
    with torch.cuda.device(slab.device):  # the C entry uses the current device
        code = _build.library().faer_llt_panel(
            slab.data_ptr(), slab.stride(0), out.data_ptr(), xinv.data_ptr(),
            cnt_ok.data_ptr(), m, b, float(eps), float(delta),
            _build.stream_of(slab))
    _build.check("llt_panel", code)
    return out, cnt_ok[0], cnt_ok[1] != 0


def llt_panel(slab, *, eps: float = 0.0, delta: float = 0.0):
    """Fused LLT panel step of an (m, b) float32 slab, m ≥ b.

    Only the lower triangle of ``slab[:b]`` is read. On a CUDA tensor
    ``b`` must be a multiple of 32 and at most 512, and rows must be
    contiguous (any row stride); the result is a new (m, b) tensor.
    """
    _build.check_panel(slab, "llt_panel")
    if slab.device.type == "cpu":
        return llt_panel_plain(slab, eps=eps, delta=delta)
    res = launch(slab, eps, delta)
    count_launch("llt_panel")
    return res
