"""The ``complex_schur`` kernel: the whole single-shift complex Schur
iteration of ``linalg/complex_schur.py`` for a batch of Hessenberg
problems, one CTA a problem, in one launch (``csrc/complex_schur.cu``).

It replaces no Pallas kernel: the JAX package runs this iteration as one
XLA ``lax.while_loop`` (``faer_tpu/linalg/evd.py:277``), its chase a
``fori_loop`` of complex Givens rotations. Driven from the host in
PyTorch, each chase step would be a dozen small launches and each
iteration's deflation test a host read, some 10⁵ launches for one AED
window of the multishift driver; here the iteration never leaves the card.

:func:`complex_schur_batched` launches the kernel on a CUDA tensor, counted
under ``complex_schur``, and raises where the kernel cannot take its
inputs; on a CPU tensor :func:`complex_schur_batched_plain` runs
``linalg/complex_schur.complex_schur_plain`` on each problem in turn, which
rounds every operation as the kernel does, so T, Q, the iteration counts,
the convergence flags and the chase steps agree to the bit.
"""
from __future__ import annotations

import torch

from faer_tpu_torch.core.config import count_launch
from faer_tpu_torch.core.errors import ShapeError
from faer_tpu_torch.ops.kernels import _build

MAX_N = 8192  # the largest problem the kernel takes (kMaxN)


def complex_schur_batched_plain(h, q, sizes, *, max_sweeps_factor: int = 30):
    """Plain PyTorch version of :func:`complex_schur_batched` (same
    contract): ``complex_schur_plain`` on each problem in turn."""
    from faer_tpu_torch.linalg.complex_schur import complex_schur_plain

    t, qo = h.clone(), q.clone()
    batch, nmax, _ = h.shape
    info = torch.zeros((batch, 3), dtype=torch.int32)
    for b, n in enumerate(sizes.tolist()):
        if not 1 <= n <= nmax:
            continue
        tb, qb, it, ok, steps = complex_schur_plain(h[b, :n, :n], q[b, :n, :n],
                                                    max_sweeps_factor=max_sweeps_factor)
        t[b, :n, :n], qo[b, :n, :n] = tb, qb
        info[b] = torch.tensor([it, int(ok), steps], dtype=torch.int32)
    info = info.to(h.device)
    return t, qo, info[:, 0], info[:, 1] != 0, info[:, 2]


def _check(h, q, sizes, max_sweeps_factor) -> None:
    name = "complex_schur_batched"
    if h.dtype not in (torch.complex64, torch.complex128) or q.dtype != h.dtype:
        raise TypeError(f"{name}: h and q must be complex64 or complex128 (one dtype), "
                        f"got {h.dtype}, {q.dtype}")
    if h.dim() != 3 or h.shape[1] != h.shape[2] or not 1 <= h.shape[1] <= MAX_N \
            or h.shape[0] < 1:
        raise ShapeError(f"{name}: needs h (B, nmax, nmax) with B ≥ 1 and 1 ≤ nmax ≤ "
                         f"{MAX_N}, got {tuple(h.shape)}")
    if q.shape != h.shape:
        raise ShapeError(f"{name}: needs q of h's shape {tuple(h.shape)}, "
                         f"got {tuple(q.shape)}")
    if sizes.dtype != torch.int32 or tuple(sizes.shape) != (h.shape[0],):
        raise TypeError(f"{name}: sizes must be int32 ({h.shape[0]},)")
    if int(max_sweeps_factor) < 0:
        raise ValueError(f"{name}: max_sweeps_factor must be ≥ 0")
    if q.device != h.device or sizes.device != h.device:
        raise ValueError(f"{name}: h, q and sizes must be on one device")
    if h.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {h.device}")
    if not all(x.is_contiguous() for x in (h, q, sizes)):
        raise ValueError(f"{name}: h, q and sizes must be contiguous")


def complex_schur_batched(h, q, sizes, *, max_sweeps_factor: int = 30):
    """The complex Schur iteration of B Hessenberg problems in one launch.

    ``h`` and ``q`` (B, nmax, nmax), complex64 or complex128, hold problem b
    in ``h[b, :n, :n]`` (upper Hessenberg) and ``q[b, :n, :n]`` (the matrix
    whose columns absorb the similarity), n = ``sizes[b]`` (int32, on the
    card: the batch may be ragged); each runs ``complex_schur``'s iteration
    of at most ``max_sweeps_factor``·n iterations. Returns ``(t, q,
    iterations, converged, steps)``: new tensors T (upper triangular once
    converged) and Q with A = Q T Qᴴ for A = q h qᴴ, entries past each
    problem as given; int32 iterations, bool converged and int32 chase
    steps (the rotations of every sweep) (B,), on the device. A size
    outside [1, nmax] leaves its problem as it is, with 0 iterations and
    steps, not converged. One ``complex_schur`` launch: H and Q in shared
    memory while they fit (:func:`route`), else in global memory.
    """
    _check(h, q, sizes, max_sweeps_factor)
    if h.device.type == "cpu":
        return complex_schur_batched_plain(h, q, sizes, max_sweeps_factor=max_sweeps_factor)
    batch, nmax, _ = h.shape
    t, qo = h.clone(), q.clone()
    info = torch.empty((batch, 3), dtype=torch.int32, device=h.device)
    suffix = "_c128" if h.dtype == torch.complex128 else ""
    with torch.cuda.device(h.device):  # the C entry launches on the current device
        code = getattr(_build.library(), "faer_complex_schur_batched" + suffix)(
            t.data_ptr(), qo.data_ptr(), sizes.data_ptr(), info.data_ptr(), batch, nmax,
            int(max_sweeps_factor), _build.stream_of(h))
    _build.check("complex_schur_batched", code)
    count_launch("complex_schur")
    return t, qo, info[:, 0], info[:, 1] != 0, info[:, 2]


def route(nmax: int, dtype=torch.complex64) -> str:
    """Where the kernel keeps H and Q for problems of up to ``nmax`` in
    ``dtype``: "shared" or "global" memory (as ``csrc/complex_schur.cu``
    decides it), or "refused". Needs the built library."""
    suffix = "_c128" if dtype == torch.complex128 else ""
    code = getattr(_build.library(), "faer_complex_schur_route" + suffix)(nmax)
    return {0: "shared", 1: "global"}.get(code, "refused")


def shared_edge(dtype=torch.complex64) -> int:
    """The largest nmax whose H and Q the kernel keeps in shared memory, by
    bisection over :func:`route`. Needs the built library."""
    return _build.shared_edge(route, dtype, MAX_N)
