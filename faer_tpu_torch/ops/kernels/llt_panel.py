"""Kernel 2: ``llt_panel``, the fused LLT panel step of an (m, b) slab.

Counterpart of ``llt_panel_v5_pallas`` (``faer_tpu/ops/pallas/llt_panel_v5.py:176``,
body ``:97``). Returns ``(strip, count, ok)``: ``strip[:b] = L11`` (lower
triangular), ``strip[b:] = L21 = A21·L11⁻ᵀ``, the dynamic-regularization
count (int32) and whether every pivot was positive (bool).

The CUDA kernel (``csrc/llt_panel.cu``) is one launch with the slab's rows
dealt to many CTAs in 32-row groups. It walks the panel in 32-column
sub-blocks, left-looking: the owner of each 32 × 32 diagonal tile factors
it and publishes the tile's rows, and every CTA forms its rows' next 32
columns from them by an FFMA chain and a substitution, with no explicit
inverse. Its C entry alone decides the route from (m, b) and the card
(:func:`route` asks it): the rows in shared memory or in global memory.
:func:`llt_panel_blocked_plain` follows the kernel's order of operations,
for the tests and ``chip_smoke.py``; no wrapper runs it.
:func:`llt_panel_plain` follows the Pallas body's math (mirror, ``sb``-row
register micro-steps, Neumann-coupled cross-sub-block updates, and L21
against a 128-blocked Neumann inverse of L11ᵀ) and is the CPU route.
"""
from __future__ import annotations

import ctypes
import math

import torch

from faer_tpu_torch.core.config import count_launch
from faer_tpu_torch.core.errors import ShapeError
from faer_tpu_torch.ops.kernels import _build

SUB_BLOCK = 32  # the CUDA kernel's factor sub-block; b must be a multiple
MAX_B = 512
# faer_llt_panel_route's codes
ROUTES = {1: "rows in shared memory", 0: "rows in global memory"}


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


def _fma(a, b, c):
    """a·b + c rounded once to c's type, as ``__fmaf_rn`` rounds it in
    float32: a float32 product is exact in float64, so only a float64 sum
    that lands exactly halfway between two float32 values can round
    differently. A float64 slab (the tests' oracle) rounds as float64
    does."""
    return (a.double() * b.double() + c.double()).to(c.dtype)


def _products(x, lrows, brows):
    """x − lrows·brows[:, :d]ᵀ as the kernel forms it: one FMA a product,
    from x, over the columns c' = 0, 1, ..., d − 1 in order."""
    for cp in range(lrows.shape[1]):
        x = _fma(-lrows[:, cp:cp + 1], brows[None, :, cp], x)
    return x


def _factor_tile(s, eps: float, delta: float):
    """L of a (32, 32) tile (lower entries of ``s`` read), the reciprocal
    pivots, the count and ok, in the kernel's order: per pivot j the rule
    of ``llt_panel_v5.py:123-129``, r = 1/sqrt(pivot) rounded once, column j
    scaled by r, then the later columns minus its rank-1 product."""
    n = s.shape[0]
    x = torch.tril(s)
    lo = torch.zeros_like(x)
    rs = x.new_empty(n)
    cnt = torch.zeros((), dtype=torch.int32, device=s.device)
    ok = torch.ones((), dtype=torch.bool, device=s.device)
    for j in range(n):
        pj = x[j, j]
        needs = pj <= delta
        ok = ok & (pj > 0)
        if eps > 0:
            pj = torch.where(needs, torch.full_like(pj, eps), pj)
            cnt = cnt + needs.to(torch.int32)
        else:
            pj = torch.where(pj <= 0, torch.ones_like(pj), pj)
        # 1/sqrt(pivot) rounded once, as __frsqrt_rn: in float64, then to
        # the slab's type (a float64 result within an ulp of float64 lands
        # on the correctly rounded float32 one but in near-halfway cases)
        r = torch.reciprocal(torch.sqrt(pj.double())).to(pj.dtype)
        rs[j] = r
        col = x[j + 1:, j] * r
        lo[j, j] = pj * r
        lo[j + 1:, j] = col
        x[j + 1:, j + 1:] = _fma(-col[:, None], col[None, :], x[j + 1:, j + 1:])
    return lo, rs, cnt, ok


def _solve(x, lkk, rs):
    """x·L_kkᵀ = x by substitution in the kernel's order: x_j scaled by
    1/sqrt(pivot j), then subtracted from the later columns in order."""
    n = x.shape[1]
    x = x.clone()
    for j in range(n):
        xj = x[:, j] * rs[j]
        x[:, j] = xj
        if j + 1 < n:
            x[:, j + 1:] = _fma(-xj[:, None], lkk[None, j + 1:, j], x[:, j + 1:])
    return x


def llt_panel_blocked_plain(slab, *, eps: float = 0.0, delta: float = 0.0,
                            groups: int = 1):
    """Plain PyTorch version of the kernel's order (same contract), for the
    tests and ``chip_smoke.py``; no wrapper runs it.

    Left-looking in 32-column sub-blocks: the diagonal tile k's products
    (its lower entries of A minus its rows' earlier columns' products, one
    FMA each in column order) factored by :func:`_factor_tile`; then every
    row below it forms its column block k the same way and solves it
    against the tile (:func:`_solve`). The rows are split into ``groups``
    contiguous groups of whole 32-row tiles, as the kernel's CTAs hold
    them, each group forming its own rows; every operation is elementwise on
    a row, so the bits do not depend on ``groups`` (nor on rows past a
    prefix). Only the lower triangle of ``slab[:b]`` is read.
    """
    m, b = slab.shape
    if b % SUB_BLOCK or m < b:
        raise ShapeError(f"llt_panel_blocked_plain: needs b a multiple of {SUB_BLOCK} "
                         f"and m ≥ b, got {(m, b)}")
    out = slab.new_zeros((m, b))
    cnt = torch.zeros((), dtype=torch.int32, device=slab.device)
    ok = torch.ones((), dtype=torch.bool, device=slab.device)
    rpc = SUB_BLOCK * math.ceil(math.ceil(m / SUB_BLOCK) / groups)
    for k0 in range(0, b, SUB_BLOCK):
        k1 = k0 + SUB_BLOCK
        tile = out[k0:k1, :k0]
        s = _products(torch.tril(slab[k0:k1, k0:k1]), tile, tile)
        lkk, rs, c, o = _factor_tile(s, eps, delta)
        out[k0:k1, k0:k1] = lkk
        cnt, ok = cnt + c, ok & o
        for g0 in range(0, m, rpc):
            lo, hi = max(g0, k1), min(g0 + rpc, m)
            if lo < hi:
                x = _products(slab[lo:hi, k0:k1], out[lo:hi, :k0], tile)
                out[lo:hi, k0:k1] = _solve(x, lkk, rs)
    return out, cnt, ok


def _route_code(m: int, b: int, device) -> tuple[int, int, int, int]:
    """``faer_llt_panel_route``'s (code, CTAs, rows a CTA, scratch floats).
    Raises ``ShapeError`` for a shape no route takes."""
    ctas, rpc, scratch = ctypes.c_int(), ctypes.c_int(), ctypes.c_longlong()
    with torch.cuda.device(device):  # the C entry reads the current device
        code = _build.library().faer_llt_panel_route(
            m, b, ctypes.byref(ctas), ctypes.byref(rpc), ctypes.byref(scratch))
    if code == -1:
        raise ShapeError(f"llt_panel: b must be a multiple of {SUB_BLOCK} and ≤ {MAX_B}, "
                         f"and m ≥ b, got {(m, b)}")
    if code not in ROUTES:
        raise RuntimeError(f"llt_panel: the device query failed with CUDA error {-code - 2}")
    return code, ctas.value, rpc.value, scratch.value


def route(m: int, b: int, device=None) -> tuple[str, int, int]:
    """``(route, CTAs, rows a CTA)`` of an (m, b) slab on a CUDA card, as
    the kernel's C entry ``faer_llt_panel_route`` decides them from (m, b)
    and the card: ``"rows in shared memory"`` or ``"rows in global
    memory"``. Loads the kernel library, which is built with ``nvcc`` at
    first use. Raises ``ShapeError`` for a shape no route takes."""
    code, ctas, rpc, _ = _route_code(m, b, device)
    return ROUTES[code], ctas, rpc


def route_label(m: int, b: int, device=None) -> str:
    """:func:`route` as a phrase for the card checks' lines."""
    name, ctas, rpc = route(m, b, device)
    return f"{name}, {ctas} CTAs of {rpc} rows"


def shared_edge(b: int, device=None) -> int:
    """The largest m whose (m, b) slab :func:`route` keeps in shared memory
    on a CUDA card (bisection from m = b; b − 1 if none), for the card
    checks of both sides of the edge."""
    def holds(m):
        return route(m, b, device)[0] == "rows in shared memory"

    lo, hi = b, 1 << 24  # holds at lo, not at hi
    if not holds(lo):
        return b - 1
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if holds(mid) else (lo, mid)
    return lo


def launch(slab, eps: float, delta: float):
    """Launch ``faer_llt_panel`` on a CUDA slab (b a multiple of 32, at most
    512, rows contiguous, any row stride), on the route its C entry picks
    (:func:`route` tells which), and return ``(strip, count, ok)``. Counts
    nothing: each wrapper that calls it counts its own launches."""
    m, b = slab.shape
    if b % SUB_BLOCK or b > MAX_B:
        raise ShapeError(f"llt_panel: b must be a multiple of {SUB_BLOCK} "
                         f"and ≤ {MAX_B}, got {b}")
    if slab.stride(1) != 1:
        raise ValueError("llt_panel: rows of the slab must be contiguous")
    dev = slab.device
    # the kernel's global scratch (faer_llt_panel_route's count, which
    # depends on b alone and which the C entry checks): L11ᵀ, the
    # reciprocal pivots, and four ints a sub-block (flags, early flags and
    # the tiles' count and ok); no route query on the call's path
    nscratch = b * b + b + 4 * (b // SUB_BLOCK)
    out = torch.empty((m, b), dtype=slab.dtype, device=dev)
    scratch = torch.empty(nscratch, dtype=slab.dtype, device=dev)
    cnt_ok = torch.empty(2, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):  # the C entry uses the current device
        code = _build.library().faer_llt_panel(
            slab.data_ptr(), slab.stride(0), out.data_ptr(), scratch.data_ptr(), nscratch,
            cnt_ok.data_ptr(), m, b, float(eps), float(delta), _build.stream_of(slab))
    _build.check("llt_panel", code)
    return out, cnt_ok[0], cnt_ok[1] != 0


def llt_panel(slab, *, eps: float = 0.0, delta: float = 0.0):
    """Fused LLT panel step of an (m, b) float32 slab, m ≥ b.

    Only the lower triangle of ``slab[:b]`` is read. On a CUDA tensor
    ``b`` must be a multiple of 32 and at most 512, and rows must be
    contiguous (any row stride); the result is a new (m, b) tensor, from
    one kernel launch.
    """
    _build.check_panel(slab, "llt_panel")
    if slab.shape[0] < slab.shape[1]:  # the slab holds its (b, b) diagonal block
        raise ShapeError(f"llt_panel: needs m ≥ b, got {tuple(slab.shape)}")
    if slab.device.type == "cpu":
        return llt_panel_plain(slab, eps=eps, delta=delta)
    res = launch(slab, eps, delta)
    count_launch("llt_panel")
    return res
