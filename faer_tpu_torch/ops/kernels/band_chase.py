"""Kernel 20: ``chase_probe``, serially dependent bulge-chase window steps.

Counterpart of ``chase_probe`` (``faer_tpu/ops/pallas/band_chase.py:89``,
body ``_chase_kernel`` ``:73``, step ``_window_step`` ``:39``), the probe
that measures what one window step of a band-to-tridiagonal chase costs,
which decides whether a two-stage reduction could replace the one-stage
one (``tools/torch_chase.py``).

Contract: ``band`` is a (g·4b, 2b) float32 strip; in each of its g strips
of 4b rows, step i works on the (2b, 2b) window at row offset
``(i mod 3)·b``; ``steps`` steps, each needing the one before (windows
overlap by b rows); returns the updated strip. Any other shape raises
``ShapeError``.

A step (:func:`_window_step`): the Householder v, τ that zeroes rows 2..b
of the window's column 0 (a zero tail, ``tail_sq ≤ 0``, gives τ = 0, the
identity), then u = τ·W v, γ = ½ τ vᵀu, w̃ = u − γ v and
W ← W − v w̃ᵀ − w̃ vᵀ. The strip is not symmetric, so the two-sided rank-2
step is not a similarity and the values grow with the steps.

The CUDA kernel (``csrc/band_chase.cu``) runs the step loop inside one
launch a call, as the Pallas kernel loops inside one program: one
thread-block cluster a strip, each CTA holding a run of the strip's columns
and its own copy of column 0; a step's one exchange is the partial sums of
W v, stored into every CTA and counted by its mbarrier. :func:`plan`
decides from b and the card alone how many CTAs hold a strip, how many
columns each, and where (``ROUTES``): in the CTAs' shared memory where a
cluster of them holds the strip, else in a global scratch copy. The
kernel's C entry takes the plan and refuses one the card cannot launch;
nothing falls back on the other route.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from faer_tpu_torch.core.config import count_launch
from faer_tpu_torch.core.errors import ShapeError
from faer_tpu_torch.ops.kernels import _build

MAX_B = 1024  # the largest b the CUDA route takes
N_WINDOWS = 3  # window offsets {0, b, 2b} in a strip of 4b rows
THREADS = 256  # a CTA of the kernel (csrc/band_chase.cu kThreads)
# the columns a CTA of a cluster is planned to hold, at most: at b = 128 on
# an H100, 32 (8 CTAs) take as long a step as 16 (16 CTAs, whose 8 strips
# at g = 8 need two waves) and less than 64 (tools/torch_profile.py chase)
COLS_PER_CTA = 32
# faer_chase_probe's route codes
ROUTES = {"cluster, strip in shared memory": 1, "cluster, strip in global memory": 2}
# an H100's facts (faer_chase_device): the dynamic shared memory a CTA of
# the kernel may take, and the largest cluster the card places at it
H100 = (232448, 16)


class Plan(NamedTuple):
    """A launch of the kernel: the route (a key of ``ROUTES``), the CTAs of
    a strip's cluster, the columns each CTA holds and the floats of global
    scratch of the whole call (the global route's copy of every strip)."""
    route: str
    ctas: int
    cw: int
    scratch: int


def _r4(x: int) -> int:
    return (x + 3) & ~3


def contributors(b: int, cw: int) -> int:
    """The CTAs of a strip's cluster that form partial sums of W v, ranks
    0..: those whose columns [j·cw, (j + 1)·cw) meet columns 1..b."""
    return b // cw + 1


def smem_bytes(b: int, cw: int, shared: bool) -> int:
    """A CTA's dynamic shared memory (``csrc/band_chase.cu``
    ``smem_floats``): its columns in rows of 4·odd floats on the shared
    route, v on them, the partial sums of W v of the contributors in two
    slots by parity, u and v on the window's 2b rows, the copy of column 0,
    and 12 + THREADS/32 floats of barriers and scalars."""
    ld = 4 * ((cw // 4) | 1)
    floats = ((4 * b * ld if shared else 0) + cw + (2 * contributors(b, cw) + 2) * _r4(2 * b)
              + 4 * b + 12 + THREADS // 32)
    return 4 * floats


def _split(b: int, ctas: int) -> tuple[int, int]:
    """(CTAs, columns a CTA) of the strip's 2b columns over at most
    ``ctas`` CTAs, columns a multiple of 4."""
    cw = _r4(math.ceil(2 * b / ctas))
    return math.ceil(2 * b / cw), cw


def plan(b: int, g: int = 1, smem_max: int = H100[0], max_cluster: int = H100[1]) -> Plan:
    """The kernel's launch for (b, g) on a card whose CTA takes
    ``smem_max`` bytes of shared memory in clusters of up to
    ``max_cluster`` CTAs: the strip in the shared memory of a cluster of
    ⌈2b / COLS_PER_CTA⌉ CTAs, widened until it fits; else, past every
    cluster's shared memory, the largest cluster on a global copy. Raises
    ``ShapeError`` if not even that fits."""
    if not 1 <= b <= MAX_B or g < 1:
        raise ShapeError(f"chase_probe: no plan for b={b}, g={g}")
    for k in range(min(max_cluster, math.ceil(2 * b / COLS_PER_CTA)), max_cluster + 1):
        ctas, cw = _split(b, k)
        if smem_bytes(b, cw, True) <= smem_max:
            return Plan("cluster, strip in shared memory", ctas, cw, 0)
    ctas, cw = _split(b, max_cluster)
    if smem_bytes(b, cw, False) > smem_max:
        raise ShapeError(f"chase_probe: b={b} fits no CTA's shared memory on this card")
    return Plan("cluster, strip in global memory", ctas, cw, g * 4 * b * ctas * cw)


def shared_edge(smem_max: int = H100[0], max_cluster: int = H100[1]) -> int:
    """The largest b whose strip a cluster holds in shared memory."""
    return max(b for b in range(1, MAX_B + 1)
               if plan(b, 1, smem_max, max_cluster).route == "cluster, strip in shared memory")


def device_facts(device=None) -> tuple[int, int]:
    """(shared-memory bytes a CTA may take, largest cluster) of the kernel on
    a CUDA card, from its C entry ``faer_chase_device`` (which queries each
    card once). Loads the kernel library, which is built with ``nvcc`` at
    first use."""
    smem, cluster = ctypes.c_int(), ctypes.c_int()
    with torch.cuda.device(device):  # the C entry reads the current device
        code = _build.library().faer_chase_device(ctypes.byref(smem), ctypes.byref(cluster))
    _build.check("chase_probe", code)
    return smem.value, cluster.value


def route(b: int, g: int = 1, device=None) -> Plan:
    """The plan of (b, g) on a CUDA card (:func:`plan` with the card's
    facts)."""
    return plan(b, g, *device_facts(device))


def _window_step(w):
    """One chase window step on a (2b, 2b) window (``band_chase.py:39-70``)."""
    tb = w.shape[0]
    b = tb // 2
    rows = torch.arange(tb, device=w.device)[:, None]
    one = w.new_ones(())
    sel = (rows >= 1) & (rows <= b)
    x = torch.where(sel, w[:, 0:1], 0.0)
    sq = (x * x).sum()
    alpha = x[1, 0]
    tail_sq = sq - alpha * alpha
    norm = torch.sqrt(sq)
    sign = torch.where(alpha >= 0, one, -one)
    beta = -sign * norm
    is_id = tail_sq <= 0.0
    safe_s = torch.where(is_id, one, alpha - beta)
    safe_b = torch.where(is_id, one, beta)
    tau = torch.where(is_id, 0.0 * one, (beta - alpha) / safe_b)
    v = torch.where(rows == 1, one, x * (1.0 / safe_s))
    v = torch.where(sel, v, 0.0)
    # u = τ·W v; w̃ = u − (τ/2)(vᵀu)·v
    u = (w @ v) * tau
    gamma = 0.5 * tau * (v * u).sum()
    wt = u - gamma * v
    return w - v * wt.reshape(1, tb) - wt * v.reshape(1, tb)


def chase_probe_plain(band, *, b: int, steps: int, g: int = 1):
    """Plain PyTorch version of ``chase_probe``: the step loop over
    :func:`_window_step` for each of the g strips in turn."""
    _check(band, b, steps, g)
    out = band.clone(memory_format=torch.contiguous_format)
    tb, r = 2 * b, 4 * b
    for gi in range(g):
        for i in range(steps):
            off = gi * r + (i % N_WINDOWS) * b
            out[off:off + tb] = _window_step(out[off:off + tb])
    return out


def _check(band, b: int, steps: int, g: int) -> None:
    _build.check_f32_matrix(band, "chase_probe")
    if b < 1 or steps < 0 or g < 1:
        raise ShapeError(f"chase_probe: needs b, g ≥ 1 and steps ≥ 0, got "
                         f"b={b}, steps={steps}, g={g}")
    if tuple(band.shape) != (g * 4 * b, 2 * b):
        raise ShapeError(f"chase_probe: needs a ({g * 4 * b}, {2 * b}) strip for "
                         f"b={b}, g={g}, got {tuple(band.shape)}")


def chase_probe(band, *, b: int, steps: int, g: int = 1):
    """Run ``steps`` serially dependent chase window steps on each of the g
    strips of ``band`` and return the updated (g·4b, 2b) strip. On a CUDA
    tensor b must be at most ``MAX_B``."""
    _check(band, b, steps, g)
    if band.device.type == "cpu":
        return chase_probe_plain(band, b=b, steps=steps, g=g)
    if b > MAX_B:
        raise ShapeError(f"chase_probe: b must be ≤ {MAX_B}, got {b}")
    band = band.contiguous()
    p = route(b, g, band.device)
    out = torch.empty_like(band)
    scratch = torch.empty(p.scratch, dtype=torch.float32, device=band.device) if p.scratch else None
    with torch.cuda.device(band.device):  # the C entry uses the current device
        code = _build.library().faer_chase_probe(
            band.data_ptr(), out.data_ptr(), None if scratch is None else scratch.data_ptr(),
            p.scratch, b, steps, g, p.ctas, p.cw, ROUTES[p.route], _build.stream_of(band))
    _build.check("chase_probe", code)
    count_launch("chase_probe")
    return out
