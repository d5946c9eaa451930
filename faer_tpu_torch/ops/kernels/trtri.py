"""Kernel 1: ``trtri``, inverses of (n ≤ 128) lower-triangular blocks.

Counterpart of ``trtri_pallas`` (``faer_tpu/ops/pallas/panel_kernels.py:302``,
body ``:255``). The CUDA kernel (``csrc/trtri.cu``) inverts one block a CTA:
its 16 × 16 diagonal sub-blocks by substitution, then log₂(p/16) levels of
the 2 × 2 combine X₂₁ = −(X₂₂·L₂₁)·X₁₁ of ``ops/triangular.py``, p the
block's side padded with the identity to 16·2ᵏ. :func:`trtri` launches it
for one block; :func:`trtri_batched` for many diagonal blocks of one matrix,
read through its strides, up to :data:`MAX_BATCH` a launch.

:func:`trtri_plain` follows the Pallas body's math (Neumann doubling plus
one Newton–Schulz step) in FP32: it is what the wrappers run on a CPU
tensor, and :func:`trtri_batched_plain` runs it block by block.
:func:`trtri_blocked_plain` follows the kernel's order, for the tests; no
wrapper runs it.
"""
from __future__ import annotations

import ctypes

import torch

from faer_tpu_torch.core.config import count_launch
from faer_tpu_torch.core.errors import ShapeError
from faer_tpu_torch.ops.kernels import _build

MAX_N = 128
MAX_BATCH = 64  # blocks a launch takes, passed by value in its parameters
SUB = 16  # the blocked twin's sub-block side, kSub of csrc/trtri.cu


def trtri_plain(t, *, unit: bool = False):
    """inv(L) for the lower triangle of ``t`` (diagonal taken as 1 if ``unit``)."""
    t = t.contiguous()  # the same bits whatever the layout of the view
    n = t.shape[0]
    eye = torch.eye(n, dtype=t.dtype, device=t.device)
    strict = torch.tril(t, -1)
    if unit:
        dinv = torch.ones((n, 1), dtype=t.dtype, device=t.device)
    else:
        dinv = 1.0 / torch.diagonal(t)[:, None]
    p = -(strict * dinv)  # rows scaled: L = D (I + M)
    s = eye + p
    span = 2
    while span < n:
        p = p @ p
        s = s + p @ s
        span *= 2
    s = s * dinv.reshape(1, n)  # cols scaled
    # Newton–Schulz: squares the Neumann sum's residual
    tt = strict + (eye if unit else eye / dinv)
    s = s + s @ (eye - tt @ s)
    return torch.tril(s)


def padded(n: int) -> int:
    """The side :func:`trtri_blocked_plain` pads an (n, n) block to,
    16·2ᵏ ≥ n: a mirror of ``padded`` in ``csrc/trtri.cu``, which alone
    decides the kernel's side."""
    p = SUB
    while p < n:
        p *= 2
    return p


def trtri_blocked_plain(t, *, unit: bool = False):
    """inv(L) in the kernel's order: L padded with the identity to
    :func:`padded` (n), its 16 × 16 diagonal sub-blocks inverted by forward
    substitution row by row (each row times 1/L_ii), then each level's
    pairs combined as
    X₂₁ = −(X₂₂·L₂₁)·X₁₁. FP32 throughout."""
    n = t.shape[0]
    p = padded(n)
    dev, dt = t.device, t.dtype
    lo = torch.eye(p, dtype=dt, device=dev)
    lo[:n, :n] = torch.tril(t, -1) + (torch.eye(n, dtype=dt, device=dev) if unit
                                      else torch.diag(torch.diagonal(t)))
    starts = range(0, p, SUB)
    lb = torch.stack([lo[o:o + SUB, o:o + SUB] for o in starts])  # (p/16, 16, 16)
    xb = torch.zeros_like(lb)
    eye = torch.eye(SUB, dtype=dt, device=dev)
    dinv = 1.0 / torch.diagonal(lb, dim1=1, dim2=2)  # (p/16, 16)
    for i in range(SUB):  # row i of every sub-block's inverse, all columns
        s = eye[i] - (lb[:, i:i + 1, :i] @ xb[:, :i, :])[:, 0]
        xb[:, i] = torch.where(torch.arange(SUB, device=dev) <= i,
                               s * dinv[:, i:i + 1], 0.0)
    x = torch.zeros_like(lo)
    for k, o in enumerate(starts):
        x[o:o + SUB, o:o + SUB] = xb[k]
    w = SUB
    while w < p:
        for o in range(0, p, 2 * w):
            x22 = x[o + w:o + 2 * w, o + w:o + 2 * w]
            x[o + w:o + 2 * w, o:o + w] = -((x22 @ lo[o + w:o + 2 * w, o:o + w])
                                            @ x[o:o + w, o:o + w])
        w *= 2
    return x[:n, :n].clone()


def _check_blocks(t, blocks, name: str) -> None:
    _build.check_f32_matrix(t, name)
    if not blocks:
        raise ShapeError(f"{name}: needs at least one block")
    side = min(t.shape)
    for off, size in blocks:
        if not (1 <= size <= MAX_N and off >= 0 and off + size <= side):
            raise ShapeError(f"{name}: block ({off}, {size}) is not a diagonal "
                             f"block of side ≤ {MAX_N} of {tuple(t.shape)}")


def _launch(t, blocks, out, out_n: int, unit: bool) -> None:
    """One kernel launch over ``blocks`` (≤ MAX_BATCH) into ``out``'s slots."""
    flat = (ctypes.c_int * (2 * len(blocks)))(*(v for blk in blocks for v in blk))
    with torch.cuda.device(t.device):  # the C entry launches on the current device
        code = _build.library().faer_trtri_batched(
            t.data_ptr(), t.stride(0), t.stride(1), flat, len(blocks),
            out.data_ptr(), out_n, int(unit), _build.stream_of(t))
    _build.check("trtri", code)
    count_launch("trtri")


def trtri(t, *, unit: bool = False):
    """inv(L) of an (n, n) float32 lower-triangular block, n ≤ 128.

    Only the lower triangle of ``t`` is read (and not its diagonal if
    ``unit``); the result is a contiguous lower-triangular (n, n). ``t``
    may be any strided view, a transposed one included.
    """
    _build.check_f32_matrix(t, "trtri")
    n = t.shape[0]
    if t.shape[1] != n or not 1 <= n <= MAX_N:
        raise ShapeError(f"trtri: needs a square block of side ≤ {MAX_N}, "
                         f"got {tuple(t.shape)}")
    if t.device.type == "cpu":
        return trtri_plain(t, unit=unit)
    out = t.new_empty((n, n))
    _launch(t, [(0, n)], out, n, unit)
    return out


def trtri_batched_plain(t, blocks, *, unit: bool = False):
    """:func:`trtri_plain` of each diagonal block ``t[o:o+s, o:o+s]`` of
    ``blocks`` ((o, s) pairs), in a zero (len(blocks), 128, 128) output."""
    out = t.new_zeros((len(blocks), MAX_N, MAX_N))
    for i, (off, size) in enumerate(blocks):
        out[i, :size, :size] = trtri_plain(t[off:off + size, off:off + size], unit=unit)
    return out


def trtri_batched(t, blocks, *, unit: bool = False):
    """inv of each diagonal block ``t[o:o+s, o:o+s]`` of ``blocks``, a list of
    (offset o, size s ≤ 128) pairs: a (len(blocks), 128, 128) float32 tensor,
    slot i holding block i's lower-triangular inverse in its leading s × s
    and zeros past it. ``t`` is read through its strides (an upper triangle
    is passed as the lower triangle of its ``.mT`` view, no copy); one launch
    per :data:`MAX_BATCH` blocks."""
    blocks = [(int(o), int(s)) for o, s in blocks]
    _check_blocks(t, blocks, "trtri_batched")
    if t.device.type == "cpu":
        return trtri_batched_plain(t, blocks, unit=unit)
    out = t.new_empty((len(blocks), MAX_N, MAX_N))
    for c0 in range(0, len(blocks), MAX_BATCH):
        _launch(t, blocks[c0:c0 + MAX_BATCH], out[c0:], MAX_N, unit)
    return out
