"""Kernel 3: ``lu_panel``, the partial-pivot LU of an (m, b) panel.

Counterpart of ``lu_panel_v5_pallas`` (``faer_tpu/ops/pallas/lu_panel_v5.py:157``,
body ``:78``). Returns ``(packed, perm, nt, ok)``: ``packed`` holds unit-lower
L (strict) and U with ``panel[perm] = L·U``, ``perm`` is int64, ``nt`` the
minimal transposition count of ``perm`` (int32) and ``ok`` whether no pivot
was exactly zero. Pivot ties go to the lowest row index, as in
``jax.lax.argmax``; the kernel counts a NaN as +inf.

The CUDA kernel (``csrc/lu_panel_batched.cu``) serves every virtual-pivot
LU wrapper (``lu_panel``, ``lu_leaf``, ``lu_panel_v2``, ``lu_panel_v3``),
over one panel or a stack of them in one launch (:func:`launch_batched`).
It does rank-1 steps inside ``SUB_BLOCK``-column working blocks and one
deferred update of the later columns a sub-block, exchanges one candidate
a column between its CTAs, and writes ``packed`` and ``perm`` in packed
order itself. It takes one of two routes, which its C entry alone decides
from (g, m, b) and the card (:func:`route` asks it): one thread-block
cluster a panel, or one cooperative grid. :func:`lu_panel_blocked_plain`
follows the kernel's order of operations, for the tests and
``chip_smoke.py``; no wrapper runs it. :func:`lu_panel_plain` follows the
Pallas body (transposed panel, ``sb``-column sub-blocks of rank-1 steps,
Neumann-coupled deferred updates) and is every wrapper's CPU route; it
builds ``perm``, ``packed`` and ``nt`` with :func:`_assemble`, as the TPU
wrapper does after its ``pallas_call`` (``lu_panel_v5.py:193-205``).
"""
from __future__ import annotations

import ctypes
import math

import torch

from faer_tpu_torch.core.config import count_launch
from faer_tpu_torch.core.errors import ShapeError
from faer_tpu_torch.core.perm import perm_transposition_count
from faer_tpu_torch.ops.kernels import _build
from faer_tpu_torch.ops.kernels.llt_panel import _neumann_unit_inv

SUB_BLOCK = 32  # the kernel's working-block width, ``SB``
# faer_lu_panel_route's codes; 2 is the grid route with each CTA's working
# block in global memory, for panels whose working blocks do not fit the
# card's shared memory one CTA an SM
ROUTES = {1: "cluster", 0: "grid", 2: "grid"}


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


def _packed_order(virt, pidx):
    """``(packed, perm)`` of an (m, b) virtual-pivot panel as the kernel
    writes them: the pivot row of step k to row k, each unused row to row
    kmax plus the number of unused rows above it."""
    m = virt.shape[0]
    kmax = pidx.shape[0]
    dev = virt.device
    rows = torch.arange(m, dtype=torch.long, device=dev)
    unused = torch.ones(m, dtype=torch.bool, device=dev)
    unused[pidx] = False
    dst = torch.empty(m, dtype=torch.long, device=dev)
    dst[pidx] = torch.arange(kmax, dtype=torch.long, device=dev)
    dst = torch.where(unused, kmax + torch.cumsum(unused.long(), 0) - 1, dst)
    perm = torch.empty_like(rows).scatter_(0, dst, rows)
    return virt.index_select(0, perm), perm


def _fma(a, b, c):
    """a·b + c rounded once to c's type, as ``__fmaf_rn`` rounds it in
    float32: a float32 product is exact in float64, so only a float64 sum
    that lands exactly halfway between two float32 values can round
    differently. A float64 panel (the tests' oracle) rounds as float64
    does."""
    return (a.double() * b.double() + c.double()).to(c.dtype)


def lu_panel_blocked_plain(panel, *, sb: int = SUB_BLOCK, groups: int = 1):
    """Plain PyTorch version of the kernel's order (same contract), for the
    tests and ``chip_smoke.py``; no wrapper runs it. The factorization is
    :func:`_blocked_virtual`'s, written out as the kernel writes it."""
    v, pidx, ok = _blocked_virtual(panel, sb=sb, groups=groups)
    packed, perm = _packed_order(v, pidx)
    return packed, perm, perm_transposition_count(perm), ok


def _blocked_virtual(panel, *, sb: int, groups: int):
    """The virtual-pivot panel (rows in place), the pivot row of each step
    and ``ok``, in the kernel's order.

    Per ``sb``-column sub-block: rank-1 steps on the working columns only
    (multipliers ``V[i, r]·(1/pivot)``, then ``fma(−l_i, u_c, V[i, c])``);
    at its end U₁₂ = L₁₁⁻¹·T by unit-lower substitution (``fma``, lower
    index first) from the pivot rows' later entries T, the unused rows'
    later columns updated by ``fma(−l_ij, U₁₂[j], ·)`` for j ascending, and
    the pivot rows' later columns replaced by their U₁₂ rows. The rows are
    split into ``groups`` contiguous groups, as the kernel's CTAs hold
    them: each group's candidate, then the panel's pivot among them. Every
    operation is elementwise on a row, so the bits do not depend on
    ``groups``.
    """
    m, b = panel.shape
    kmax = min(m, b)
    dev = panel.device
    v = panel.clone(memory_format=torch.contiguous_format)
    rpc = math.ceil(m / groups)
    starts = torch.arange(0, groups * rpc, rpc, device=dev)
    alive = torch.ones(m, dtype=torch.bool, device=dev)
    pidx = torch.empty(kmax, dtype=torch.long, device=dev)
    ok = torch.ones((), dtype=torch.bool, device=dev)
    inf = torch.tensor(float("inf"), device=dev)
    for sb0 in range(0, kmax, sb):
        nj, sbw = min(sb, kmax - sb0), min(sb, b - sb0)
        w = v[:, sb0:sb0 + sbw]  # the working block, a view updated in place
        wpiv = panel.new_zeros((nj, sbw))
        for jl in range(nj):
            mag = w[:, jl].abs()
            mag = torch.where(torch.isnan(mag), inf, mag)
            mag = torch.where(alive, mag, -1.0)
            grouped = torch.full((groups * rpc,), -2.0, dtype=mag.dtype, device=dev)
            grouped[:m] = mag
            vals, local = grouped.view(groups, rpc).max(1)  # first maximal: the lowest row
            cand = starts + local
            p = cand[torch.argmax(vals)]
            piv = w.index_select(0, p.view(1))[0]
            pv = piv[jl]
            ok = ok & (pv != 0)
            inv = 1.0 / torch.where(pv == 0, torch.ones_like(pv), pv)
            alive = alive & (torch.arange(m, device=dev) != p)
            w[:, jl] = torch.where(alive, w[:, jl] * inv, w[:, jl])
            if jl + 1 < sbw:
                upd = _fma(-w[:, jl:jl + 1], piv[None, jl + 1:], w[:, jl + 1:])
                w[:, jl + 1:] = torch.where(alive[:, None], upd, w[:, jl + 1:])
            wpiv[jl] = piv
            pidx[sb0 + jl] = p
        tr0 = sb0 + sb
        if tr0 >= b:
            continue
        piv_rows = pidx[sb0:sb0 + nj]
        u = v[piv_rows, tr0:].clone()
        for k in range(nj):
            for j in range(k):
                u[k] = _fma(-wpiv[k, j], u[j], u[k])
        later = v[:, tr0:]
        for j in range(nj):
            later = torch.where(alive[:, None], _fma(-w[:, j:j + 1], u[j][None, :], later),
                                later)
        v[:, tr0:] = later
        v[piv_rows, tr0:] = u
    return v, pidx, ok


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


def _route_code(m: int, b: int, device, g: int) -> tuple[int, int, int]:
    """``faer_lu_panel_route``'s (code, CTAs a panel, scratch floats).
    Raises ``ShapeError`` for a shape no route takes."""
    ctas, scratch = ctypes.c_int(), ctypes.c_longlong()
    with torch.cuda.device(device):  # the C entry reads the current device
        code = _build.library().faer_lu_panel_route(
            g, m, b, ctypes.byref(ctas), ctypes.byref(scratch))
    if code == -1:
        raise ShapeError(f"lu_panel: no route takes {g} panel(s) of {(m, b)} on this card")
    if code not in ROUTES:
        raise RuntimeError(f"lu_panel: the device query failed with CUDA error {-code - 2}")
    return code, ctas.value, scratch.value


def route(m: int, b: int, device=None, g: int = 1) -> tuple[str, int, int]:
    """``(route, CTAs a panel, scratch floats)`` of g (m, b) panels on a
    CUDA card, as the kernel's C entry ``faer_lu_panel_route`` decides them
    from (g, m, b) and the card: ``"cluster"`` (one thread-block cluster a
    panel) or ``"grid"`` (one cooperative grid). Loads the kernel library,
    which is built with ``nvcc`` at first use. Raises ``ShapeError`` for a
    shape no route takes."""
    code, ctas, scratch = _route_code(m, b, device, g)
    return ROUTES[code], ctas, scratch


def route_label(m: int, b: int, device=None, g: int = 1) -> str:
    """:func:`route` as a phrase for the card checks' lines: the route, its
    CTAs a panel, and where the grid route keeps the working blocks when
    they are not in shared memory."""
    code, ctas, _ = _route_code(m, b, device, g)
    where = ", working blocks in global memory" if code == 2 else ""
    return f"{ROUTES[code]} route, {ctas} CTAs{where}"


def cluster_edge(b: int, device=None) -> int:
    """The largest m whose (m, b) panel :func:`route` sends to the cluster
    route on a CUDA card (bisection; 0 if none), for the card checks of
    both sides of the edge."""
    def holds(m):
        try:
            return route(m, b, device)[0] == "cluster"
        except ShapeError:
            return False

    lo, hi = 1, 1 << 20  # holds at lo, not at hi
    if not holds(lo):
        return 0
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if holds(mid) else (lo, mid)
    return lo


def launch_batched(panels):
    """``(packed, perm, nt, ok)`` of each panel of a CUDA (g, m, b) stack
    whose rows are contiguous (any row and panel strides), in one launch of
    ``faer_lu_panel_batched`` on the route of :func:`route`: (g, m, b),
    (g, m) int64, (g,) int32 and (g,) bool, all written by the kernel.
    Raises when the route cannot launch. Counts nothing: each wrapper that
    calls it counts its own launches."""
    if panels.stride(2) != 1:
        raise ValueError("lu_panel: rows of the panels must be contiguous")
    g, m, b = panels.shape
    dev = panels.device
    _, _, nscratch = route(m, b, dev, g)
    packed = torch.empty((g, m, b), dtype=panels.dtype, device=dev)
    perm = torch.empty((g, m), dtype=torch.long, device=dev)
    nt = torch.empty(g, dtype=torch.int32, device=dev)
    ok = torch.empty(g, dtype=torch.bool, device=dev)
    scratch = torch.empty(nscratch, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):  # the C entry uses the current device
        code = _build.library().faer_lu_panel_batched(
            panels.data_ptr(), panels.stride(0), panels.stride(1), packed.data_ptr(),
            perm.data_ptr(), nt.data_ptr(), ok.data_ptr(), scratch.data_ptr(), nscratch, g,
            m, b, _build.stream_of(panels))
    _build.check("lu_panel", code)
    return packed, perm, nt, ok


def launch(panel):
    """``(packed, perm, nt, ok)`` of one CUDA (m, b) panel, in one launch.
    Counts nothing."""
    return tuple(x[0] for x in launch_batched(panel.unsqueeze(0)))


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
