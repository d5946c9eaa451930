"""The ``hess_tri`` kernel: the whole Givens chain of
``linalg/qz.hessenberg_triangular`` for a batch of pencils, one CTA a
problem, in one launch (``csrc/hess_tri.cu``).

It replaces no Pallas kernel: the JAX package runs the chain as two nested
XLA ``fori_loop``s (``faer_tpu/linalg/qz.py:45``), each pair a masked
rotation of whole rows and columns. Driven from the host in PyTorch, each
of the (n − 1)(n − 2)/2 pairs would be some fifteen small launches, about
10⁷ at n = 1024; here the chain never leaves the card.

:func:`hess_tri_batched` launches the kernel on a CUDA tensor, counted
under ``hess_tri``, and raises where the kernel cannot take its inputs; on
a CPU tensor :func:`hess_tri_batched_plain` runs
``linalg/qz.hessenberg_triangular_plain`` on each problem in turn, which
rounds every operation as the kernel does, so H, R, Q and Z agree to the
bit. The kernel holds Q and Z by columns (it is handed their transposes),
so that each rotation of their columns is a coalesced pass over two rows.
"""
from __future__ import annotations

import torch

from faer_tpu_torch.core.config import count_launch
from faer_tpu_torch.core.errors import ShapeError
from faer_tpu_torch.ops.kernels import _build

MAX_N = 8192  # the largest problem the kernel takes (kMaxN)


def hess_tri_batched_plain(h, r, q, z, sizes):
    """Plain PyTorch version of :func:`hess_tri_batched` (same contract):
    ``hessenberg_triangular_plain`` on each problem in turn."""
    from faer_tpu_torch.linalg.qz import hessenberg_triangular_plain

    out = [x.clone() for x in (h, r, q, z)]
    nmax = h.shape[1]
    for b, n in enumerate(sizes.tolist()):
        if not 1 <= n <= nmax:
            continue
        res = hessenberg_triangular_plain(*(x[b, :n, :n] for x in (h, r, q, z)))
        for o, x in zip(out, res):
            o[b, :n, :n] = x
    return tuple(out)


def check_batch(name: str, mats, sizes) -> None:
    """Raise unless ``mats`` are (B, nmax, nmax) float32 or float64 tensors
    of one dtype, shape and device (CPU or CUDA), contiguous, and ``sizes``
    an int32 (B,) tensor beside them."""
    x = mats[0]
    if x.dtype not in (torch.float32, torch.float64) or any(m.dtype != x.dtype for m in mats):
        raise TypeError(f"{name}: needs float32 or float64 matrices of one dtype, got "
                        f"{[m.dtype for m in mats]}")
    if x.dim() != 3 or x.shape[1] != x.shape[2] or not 1 <= x.shape[1] <= MAX_N \
            or x.shape[0] < 1:
        raise ShapeError(f"{name}: needs (B, nmax, nmax) with B ≥ 1 and 1 ≤ nmax ≤ "
                         f"{MAX_N}, got {tuple(x.shape)}")
    if any(m.shape != x.shape for m in mats):
        raise ShapeError(f"{name}: needs matrices of one shape, got "
                         f"{[tuple(m.shape) for m in mats]}")
    if sizes.dtype != torch.int32 or tuple(sizes.shape) != (x.shape[0],):
        raise TypeError(f"{name}: sizes must be int32 ({x.shape[0]},)")
    if any(m.device != x.device for m in mats) or sizes.device != x.device:
        raise ValueError(f"{name}: the matrices and sizes must be on one device")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {x.device}")
    if not all(m.is_contiguous() for m in (*mats, sizes)):
        raise ValueError(f"{name}: the matrices and sizes must be contiguous")


def hess_tri_batched(h, r, q, z, sizes):
    """The Hessenberg–triangular Givens chain of B pencils in one launch.

    ``h``, ``r``, ``q``, ``z`` (B, nmax, nmax), float32 or float64, hold
    problem b in ``[b, :n, :n]``, n = ``sizes[b]`` (int32, on the card: the
    batch may be ragged): H (any square matrix), R (upper triangular) and
    the Q and Z whose columns absorb the left and right rotations. Returns
    new ``(h, r, q, z)``: H upper Hessenberg and R upper triangular, both
    exactly, with Q H Zᵀ and Q R Zᵀ those of the input; entries past each
    problem as given. A size outside [1, nmax] leaves its problem as it is.
    One ``hess_tri`` launch: the four matrices in shared memory while they
    fit (:func:`route`), else in global memory.
    """
    check_batch("hess_tri_batched", (h, r, q, z), sizes)
    if h.device.type == "cpu":
        return hess_tri_batched_plain(h, r, q, z, sizes)
    batch, nmax, _ = h.shape
    ho, ro = h.clone(), r.clone()
    qt, zt = q.transpose(1, 2).contiguous(), z.transpose(1, 2).contiguous()
    suffix = "_f64" if h.dtype == torch.float64 else ""
    with torch.cuda.device(h.device):  # the C entry launches on the current device
        code = getattr(_build.library(), "faer_hess_tri_batched" + suffix)(
            ho.data_ptr(), ro.data_ptr(), qt.data_ptr(), zt.data_ptr(), sizes.data_ptr(),
            batch, nmax, _build.stream_of(h))
    _build.check("hess_tri_batched", code)
    count_launch("hess_tri")
    return ho, ro, qt.transpose(1, 2).contiguous(), zt.transpose(1, 2).contiguous()


def route(nmax: int, dtype=torch.float32) -> str:
    """Where the kernel keeps H, R, Q and Z for problems of up to ``nmax``
    in ``dtype``: "shared" or "global" memory (as ``csrc/hess_tri.cu``
    decides it), or "refused". Needs the built library."""
    suffix = "_f64" if dtype == torch.float64 else ""
    code = getattr(_build.library(), "faer_hess_tri_route" + suffix)(nmax)
    return {0: "shared", 1: "global"}.get(code, "refused")


def shared_edge(dtype=torch.float32) -> int:
    """The largest nmax whose matrices the kernel keeps in shared memory, by
    bisection over :func:`route`. Needs the built library."""
    return _build.shared_edge(route, dtype, MAX_N)
