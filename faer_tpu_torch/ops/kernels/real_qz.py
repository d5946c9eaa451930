"""The ``real_qz`` kernel: the whole real double-shift QZ iteration of
``linalg/qz_real.py`` for a batch of Hessenberg/triangular pencils, one
CTA a problem, in one launch (``csrc/real_qz.cu``).

It replaces no Pallas kernel: the JAX package runs this iteration as one
XLA ``lax.while_loop`` (``faer_tpu/linalg/qz_real.py:56``), its chase a
masked ``fori_loop`` of 3×3 reflectors and 2×2 rotations. Driven from the
host in PyTorch, each chase step would be some thirty small launches and
each iteration's deflation test a host read, about 6·10⁵ chase steps at
n = 1024; here the iteration never leaves the card.

:func:`real_qz_batched` launches the kernel on a CUDA tensor, counted
under ``real_qz``, and raises where the kernel cannot take its inputs; on
a CPU tensor :func:`real_qz_batched_plain` runs
``linalg/qz_real.real_qz_iteration_plain`` on each problem in turn, which
rounds every operation as the kernel does, so S, T, Q, Z, the iteration
counts, the convergence flags and the chase steps agree to the bit. The
kernel holds Q and Z by columns (it is handed their transposes).
"""
from __future__ import annotations

import torch

from faer_tpu_torch.core.config import count_launch
from faer_tpu_torch.ops.kernels import _build
from faer_tpu_torch.ops.kernels.hess_tri import MAX_N, check_batch


def real_qz_batched_plain(h, t, q, z, sizes, *, max_sweeps_factor: int = 30):
    """Plain PyTorch version of :func:`real_qz_batched` (same contract):
    ``real_qz_iteration_plain`` on each problem in turn."""
    from faer_tpu_torch.linalg.qz_real import real_qz_iteration_plain

    out = [x.clone() for x in (h, t, q, z)]
    batch, nmax, _ = h.shape
    info = torch.zeros((batch, 3), dtype=torch.int32)
    for b, n in enumerate(sizes.tolist()):
        if not 1 <= n <= nmax:
            continue
        *mats, it, ok, steps = real_qz_iteration_plain(
            *(x[b, :n, :n] for x in (h, t, q, z)), max_sweeps_factor=max_sweeps_factor)
        for o, x in zip(out, mats):
            o[b, :n, :n] = x
        info[b] = torch.tensor([it, int(ok), steps], dtype=torch.int32)
    info = info.to(h.device)
    return (*out, info[:, 0], info[:, 1] != 0, info[:, 2])


def real_qz_batched(h, t, q, z, sizes, *, max_sweeps_factor: int = 30):
    """The real QZ iteration of B pencils in one launch.

    ``h``, ``t``, ``q``, ``z`` (B, nmax, nmax), float32 or float64, hold
    problem b in ``[b, :n, :n]``, n = ``sizes[b]`` (int32, on the card: the
    batch may be ragged): H upper Hessenberg, T upper triangular and the Q
    and Z whose columns absorb the left and right transforms; each runs
    ``real_qz_iteration``'s iteration of at most ``max_sweeps_factor``·n
    iterations. Returns ``(s, t, q, z, iterations, converged, steps)``: new
    tensors S (quasi-triangular, zeros below the subdiagonal), T (upper
    triangular), Q and Z with Q S Zᵀ and Q T Zᵀ those of the input, entries
    past each problem as given; int32 iterations, bool converged and int32
    chase steps (B,), on the device. A size outside [1, nmax] leaves its
    problem as it is, with 0 iterations and steps, not converged. One
    ``real_qz`` launch: the four matrices in shared memory while they fit
    (:func:`route`), else in global memory.
    """
    check_batch("real_qz_batched", (h, t, q, z), sizes)
    if int(max_sweeps_factor) < 0:
        raise ValueError("real_qz_batched: max_sweeps_factor must be ≥ 0")
    if h.device.type == "cpu":
        return real_qz_batched_plain(h, t, q, z, sizes, max_sweeps_factor=max_sweeps_factor)
    batch, nmax, _ = h.shape
    so, to = h.clone(), t.clone()
    qt, zt = q.transpose(1, 2).contiguous(), z.transpose(1, 2).contiguous()
    info = torch.empty((batch, 3), dtype=torch.int32, device=h.device)
    suffix = "_f64" if h.dtype == torch.float64 else ""
    with torch.cuda.device(h.device):  # the C entry launches on the current device
        code = getattr(_build.library(), "faer_real_qz_batched" + suffix)(
            so.data_ptr(), to.data_ptr(), qt.data_ptr(), zt.data_ptr(), sizes.data_ptr(),
            info.data_ptr(), batch, nmax, int(max_sweeps_factor), _build.stream_of(h))
    _build.check("real_qz_batched", code)
    count_launch("real_qz")
    return (so, to, qt.transpose(1, 2).contiguous(), zt.transpose(1, 2).contiguous(),
            info[:, 0], info[:, 1] != 0, info[:, 2])


def route(nmax: int, dtype=torch.float32) -> str:
    """Where the kernel keeps S, T, Q and Z for problems of up to ``nmax``
    in ``dtype``: "shared" or "global" memory (as ``csrc/real_qz.cu``
    decides it), or "refused". Needs the built library."""
    suffix = "_f64" if dtype == torch.float64 else ""
    code = getattr(_build.library(), "faer_real_qz_route" + suffix)(nmax)
    return {0: "shared", 1: "global"}.get(code, "refused")


def shared_edge(dtype=torch.float32) -> int:
    """The largest nmax whose matrices the kernel keeps in shared memory, by
    bisection over :func:`route`. Needs the built library."""
    return _build.shared_edge(route, dtype, MAX_N)
