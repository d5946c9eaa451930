"""The ``complex_hess_tri`` and ``complex_qz`` kernels: the complex
Hessenberg–triangular Givens chain and the whole single-shift complex QZ
iteration of ``linalg/complex_qz.py`` for a batch of pencils, one CTA a
problem, one launch each (``csrc/complex_hess_tri.cu``,
``csrc/complex_qz.cu``).

They replace no Pallas kernel: the JAX package runs the chain as two
nested XLA ``fori_loop``s (``faer_tpu/linalg/qz.py:45``) and the iteration
as one ``lax.while_loop`` (``faer_tpu/linalg/qz.py:111``), each step a
masked rotation of whole rows and columns. Driven from the host in
PyTorch, each Givens pair or chase step would be some two dozen small
launches and each iteration's deflation test a host read; here the chain
and the iteration never leave the card. The multishift driver
(``linalg/qz_multishift.py``) runs each AED window's QZ by one
``complex_qz`` launch and the window's return to Hessenberg–triangular
form by one ``complex_hess_tri`` launch on its kept block.

On a CUDA tensor each wrapper launches its kernel, counted under its name,
and raises where the kernel cannot take its inputs; on a CPU tensor its
plain version runs the twin on each problem in turn, which rounds every
operation as the kernel does, so the matrices, the iteration counts, the
convergence flags and the chase steps agree to the bit. The kernels hold
Q and Z by columns (they are handed their transposes), so that each
rotation of their columns is a coalesced pass over two rows.
"""
from __future__ import annotations

import torch

from faer_tpu_torch.core.config import count_launch
from faer_tpu_torch.core.errors import ShapeError
from faer_tpu_torch.ops.kernels import _build

MAX_N = 8192  # the largest problem the kernels take (kMaxN)


def _check(name: str, mats, sizes, max_sweeps_factor: int = 0) -> None:
    """Raise unless ``mats`` are (B, nmax, nmax) complex64 or complex128
    tensors of one dtype, shape and device (CPU or CUDA), contiguous, and
    ``sizes`` an int32 (B,) tensor beside them."""
    x = mats[0]
    if x.dtype not in (torch.complex64, torch.complex128) or any(m.dtype != x.dtype
                                                                  for m in mats):
        raise TypeError(f"{name}: needs complex64 or complex128 matrices of one dtype, got "
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
    if int(max_sweeps_factor) < 0:
        raise ValueError(f"{name}: max_sweeps_factor must be ≥ 0")
    if any(m.device != x.device for m in mats) or sizes.device != x.device:
        raise ValueError(f"{name}: the matrices and sizes must be on one device")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {x.device}")
    if not all(m.is_contiguous() for m in (*mats, sizes)):
        raise ValueError(f"{name}: the matrices and sizes must be contiguous")


def _suffix(dtype) -> str:
    return "_c128" if dtype == torch.complex128 else ""


def complex_hess_tri_batched_plain(h, r, q, z, sizes):
    """Plain PyTorch version of :func:`complex_hess_tri_batched` (same
    contract): ``complex_qz.hessenberg_triangular_plain`` on each problem
    in turn."""
    from faer_tpu_torch.linalg.complex_qz import hessenberg_triangular_plain

    out = [x.clone() for x in (h, r, q, z)]
    nmax = h.shape[1]
    for b, n in enumerate(sizes.tolist()):
        if not 1 <= n <= nmax:
            continue
        res = hessenberg_triangular_plain(*(x[b, :n, :n] for x in (h, r, q, z)))
        for o, x in zip(out, res):
            o[b, :n, :n] = x
    return tuple(out)


def complex_hess_tri_batched(h, r, q, z, sizes):
    """The complex Hessenberg–triangular Givens chain of B pencils in one
    launch.

    ``h``, ``r``, ``q``, ``z`` (B, nmax, nmax), complex64 or complex128,
    hold problem b in ``[b, :n, :n]``, n = ``sizes[b]`` (int32, on the
    card: the batch may be ragged): H (any square matrix), R (upper
    triangular) and the Q and Z whose columns absorb the left and right
    rotations. Returns new ``(h, r, q, z)``: H upper Hessenberg and R upper
    triangular, both exactly, with Q H Zᴴ and Q R Zᴴ those of the input;
    entries past each problem as given. A size outside [1, nmax] leaves its
    problem as it is. One ``complex_hess_tri`` launch: the four matrices in
    shared memory while they fit (:func:`route`), else in global memory.
    """
    _check("complex_hess_tri_batched", (h, r, q, z), sizes)
    if h.device.type == "cpu":
        return complex_hess_tri_batched_plain(h, r, q, z, sizes)
    batch, nmax, _ = h.shape
    ho, ro = h.clone(), r.clone()
    qt, zt = q.transpose(1, 2).contiguous(), z.transpose(1, 2).contiguous()
    with torch.cuda.device(h.device):  # the C entry launches on the current device
        code = getattr(_build.library(), "faer_complex_hess_tri_batched" + _suffix(h.dtype))(
            ho.data_ptr(), ro.data_ptr(), qt.data_ptr(), zt.data_ptr(), sizes.data_ptr(),
            batch, nmax, _build.stream_of(h))
    _build.check("complex_hess_tri_batched", code)
    count_launch("complex_hess_tri")
    return ho, ro, qt.transpose(1, 2).contiguous(), zt.transpose(1, 2).contiguous()


def complex_qz_batched_plain(h, t, q, z, sizes, *, max_sweeps_factor: int = 30):
    """Plain PyTorch version of :func:`complex_qz_batched` (same contract):
    ``complex_qz.qz_iteration_plain`` on each problem in turn."""
    from faer_tpu_torch.linalg.complex_qz import qz_iteration_plain

    out = [x.clone() for x in (h, t, q, z)]
    batch, nmax, _ = h.shape
    info = torch.zeros((batch, 3), dtype=torch.int32)
    for b, n in enumerate(sizes.tolist()):
        if not 1 <= n <= nmax:
            continue
        *mats, it, ok, steps = qz_iteration_plain(
            *(x[b, :n, :n] for x in (h, t, q, z)), max_sweeps_factor=max_sweeps_factor)
        for o, x in zip(out, mats):
            o[b, :n, :n] = x
        info[b] = torch.tensor([it, int(ok), steps], dtype=torch.int32)
    info = info.to(h.device)
    return (*out, info[:, 0], info[:, 1] != 0, info[:, 2])


def complex_qz_batched(h, t, q, z, sizes, *, max_sweeps_factor: int = 30):
    """The complex QZ iteration of B pencils in one launch.

    ``h``, ``t``, ``q``, ``z`` (B, nmax, nmax), complex64 or complex128,
    hold problem b in ``[b, :n, :n]``, n = ``sizes[b]`` (int32, on the
    card: the batch may be ragged): H upper Hessenberg, T upper triangular
    and the Q and Z whose columns absorb the left and right rotations; each
    runs ``qz_iteration``'s iteration of at most ``max_sweeps_factor``·n
    iterations. Returns ``(s, t, q, z, iterations, converged, steps)``: new
    tensors S and T (upper triangular once converged), Q and Z with
    Q S Zᴴ and Q T Zᴴ those of the input, entries past each problem as
    given; int32 iterations, bool converged and int32 chase steps (B,), on
    the device. A size outside [1, nmax] leaves its problem as it is, with
    0 iterations and steps, not converged. One ``complex_qz`` launch: the
    four matrices in shared memory while they fit (:func:`route`), else in
    global memory.
    """
    _check("complex_qz_batched", (h, t, q, z), sizes, max_sweeps_factor)
    if h.device.type == "cpu":
        return complex_qz_batched_plain(h, t, q, z, sizes, max_sweeps_factor=max_sweeps_factor)
    batch, nmax, _ = h.shape
    so, to = h.clone(), t.clone()
    qt, zt = q.transpose(1, 2).contiguous(), z.transpose(1, 2).contiguous()
    info = torch.empty((batch, 3), dtype=torch.int32, device=h.device)
    with torch.cuda.device(h.device):  # the C entry launches on the current device
        code = getattr(_build.library(), "faer_complex_qz_batched" + _suffix(h.dtype))(
            so.data_ptr(), to.data_ptr(), qt.data_ptr(), zt.data_ptr(), sizes.data_ptr(),
            info.data_ptr(), batch, nmax, int(max_sweeps_factor), _build.stream_of(h))
    _build.check("complex_qz_batched", code)
    count_launch("complex_qz")
    return (so, to, qt.transpose(1, 2).contiguous(), zt.transpose(1, 2).contiguous(),
            info[:, 0], info[:, 1] != 0, info[:, 2])


def route(kernel: str, nmax: int, dtype=torch.complex64) -> str:
    """Where ``kernel`` ("complex_hess_tri" or "complex_qz") keeps its four
    matrices for problems of up to ``nmax`` in ``dtype``: "shared" or
    "global" memory (as its source decides it), or "refused". Needs the
    built library."""
    code = getattr(_build.library(), f"faer_{kernel}_route" + _suffix(dtype))(nmax)
    return {0: "shared", 1: "global"}.get(code, "refused")


def shared_edge(kernel: str, dtype=torch.complex64) -> int:
    """The largest nmax whose matrices ``kernel`` keeps in shared memory,
    by bisection over :func:`route`. Needs the built library."""
    return _build.shared_edge(lambda n, dt: route(kernel, n, dt), dtype, MAX_N)
