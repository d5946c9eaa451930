"""Kernel 8: ``tile_matmul``, C = A·B accumulated in f32.

Counterpart of ``pallas_matmul`` (``faer_tpu/ops/pallas/matmul_kernel.py:92``,
bodies ``_mm_padded :59`` and ``_mm_kernel :20``). The CUDA source
``csrc/matmul.cu`` (over ``csrc/hopper.cuh``) has one design a mode: bf16
operands on TMA + ``wgmma``; f32 operands in ``"high"`` (bf16x3) split into
bf16 hi/lo scratch by a staging pass, then the same mainloop with three
products; f32 in ``"highest"`` (FP32) on a pipelined FFMA kernel. Thin
products that cannot fill the card cut k into slices whose f32 partials a
second kernel sums in a fixed order. :func:`plan_tile_matmul` chooses the
route, tile, slices and how each operand is read, from the shape, strides
and alignment alone, before anything launches; the C entry checks the plan
against the operands and refuses one that does not fit. There is no
fallback. :func:`tile_matmul_plain` computes the same function in PyTorch:
``"highest"`` as one FP32 product, ``"high"`` as the explicit bf16 split
``ah·bh + ah·bl + al·bh`` of three FP32 products of bf16-valued operands,
each of them exact; :func:`splitk_plain` and :func:`stage_plain` model the
split-k sum and the staging pass.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from faer_tpu_torch.core.config import check_f32_policy, config, count_launch
from faer_tpu_torch.core.errors import ShapeError
from faer_tpu_torch.ops.kernels import _build

_MODES = {"highest": 0, "high": 1}
_BF16_MODE = 2
_DTYPES = (torch.float32, torch.bfloat16)
# how an operand is read (csrc/matmul.cu enum Read): a TMA box of its
# K-major or MN-major layout; staged into K-major bf16 scratch ("pack" copies
# a bf16 operand, "split" splits an f32 one into hi and lo); cp.async copies
# of 16 bytes along m (n), or of 4 bytes walking k or m (n)
_READS = {"tma_k": 0, "tma_mn": 1, "pack": 2, "split": 2, "cp16_mn": 3, "cp4_k": 4,
          "cp4_mn": 5}
# per route: output tile (rows, cols), k depth of a stage, CTAs an SM
_ROUTES = {"ffma": ((128, 128), 32, 2), "wgmma": ((128, 256), 64, 1),
           "wgmma3": ((128, 128), 64, 1)}
MIN_SLICE_STAGES = 4  # a k slice is at least this many stages deep
H100_SMS = 132


@dataclass(frozen=True)
class TilePlan:
    """How :func:`tile_matmul` computes one product: ``route`` ``"ffma"``
    (FP32), ``"wgmma"`` (bf16) or ``"wgmma3"`` (bf16x3); the output ``tile``;
    ``bk``, the k depth of a stage; ``split``, the k slices (1: none); and
    how A and B are read (a key of ``_READS``)."""
    route: str
    tile: tuple[int, int]
    bk: int
    split: int
    a: str
    b: str


def _tma_read(ptr, s_r, s_k, rows, k):
    """``"tma_k"``, ``"tma_mn"`` or ``"pack"`` for a bf16 operand of
    ``rows`` × ``k`` (rows: m of A, n of B), element (r, j) at
    ``ptr + 2 (r s_r + j s_k)``: a TMA box needs a 16-byte-aligned base, a
    unit stride and a 16-byte multiple as the other, covering its dimension."""
    if ptr % 16 == 0:
        if s_k == 1 and s_r % 8 == 0 and s_r >= k:
            return "tma_k"
        if s_r == 1 and s_k % 8 == 0 and s_k >= rows:
            return "tma_mn"
    return "pack"


def _cp_read(ptr, s_r, s_k):
    """``"cp16_mn"``, ``"cp4_k"`` or ``"cp4_mn"`` for an f32 operand: 16-byte
    copies where the unit stride runs along m (n) from an aligned base, else
    4-byte copies walking the smaller stride."""
    if s_r == 1 and s_k % 4 == 0 and ptr % 16 == 0:
        return "cp16_mn"
    return "cp4_k" if s_k <= s_r else "cp4_mn"


def plan_tile_matmul(m, n, k, dtype, mode, a_strides, b_strides, a_ptr, b_ptr,
                     sms=H100_SMS) -> TilePlan:
    """The plan of an (m, k)·(k, n) product of ``dtype`` operands in
    ``mode`` (``"highest"``, ``"high"``; bf16 operands take one pass
    whatever the mode), with element strides ``a_strides`` = (sam, sak),
    ``b_strides`` = (sbk, sbn) and data pointers ``a_ptr``, ``b_ptr``, on
    a card of ``sms`` SMs. k is cut into slices when the output tiles fill
    at most half the card's CTA slots and each slice keeps at least
    ``MIN_SLICE_STAGES`` stages; the slices are as even as the stages allow
    and none is empty."""
    sam, sak = a_strides
    sbk, sbn = b_strides
    if dtype == torch.bfloat16:
        route = "wgmma"
        ra, rb = _tma_read(a_ptr, sam, sak, m, k), _tma_read(b_ptr, sbn, sbk, n, k)
    elif mode == "high":
        route, ra, rb = "wgmma3", "split", "split"
    elif mode == "highest":
        route = "ffma"
        ra, rb = _cp_read(a_ptr, sam, sak), _cp_read(b_ptr, sbn, sbk)
    else:
        raise ValueError(f"plan_tile_matmul: unknown mode {mode!r}")
    (bm, bn), bk, per_sm = _ROUTES[route]
    tiles = -(-m // bm) * -(-n // bn)
    stages = -(-k // bk)
    split = max(1, min(sms * per_sm // tiles, stages // MIN_SLICE_STAGES))
    if split > 1:
        split = -(-stages // -(-stages // split))  # no empty slice
    return TilePlan(route, (bm, bn), bk, split, ra, rb)


def split_bf16(x):
    """``(hi, lo)`` as f32 tensors of bf16 values: ``hi = bf16(x)``,
    ``lo = bf16(x − hi)``, as ``_mm_kernel`` splits its operands."""
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def _f32_product(a, b):
    """A·B of f32 tensors in the precision of ``config.f32_precision``."""
    if a.is_cuda:
        check_f32_policy()
    if config.tile_precision() == "highest":
        return torch.matmul(a, b)
    ah, al = split_bf16(a)
    bh, bl = split_bf16(b)
    return torch.matmul(ah, bh) + torch.matmul(ah, bl) + torch.matmul(al, bh)


def _check(a, b, out_dtype):
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ShapeError(f"tile_matmul: needs (m, k)·(k, n), got "
                         f"{tuple(a.shape)}·{tuple(b.shape)}")
    if a.dtype != b.dtype or a.dtype not in _DTYPES:
        raise TypeError(f"tile_matmul: needs two float32 or two bfloat16 "
                        f"operands, got {a.dtype} and {b.dtype}")
    if out_dtype not in _DTYPES:
        raise TypeError(f"tile_matmul: out_dtype must be float32 or bfloat16, "
                        f"got {out_dtype}")
    if a.device != b.device or a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"tile_matmul: operands on {a.device} and {b.device}")


def tile_matmul_plain(a, b, *, out_dtype=None):
    """The function :func:`tile_matmul` computes, in PyTorch."""
    out_dtype = out_dtype or a.dtype
    _check(a, b, out_dtype)
    if a.dtype == torch.bfloat16:  # exact products, f32 sums
        if a.is_cuda:
            check_f32_policy()
        prod = torch.matmul(a.float(), b.float())
    else:
        prod = _f32_product(a, b)
    return prod.to(out_dtype)


def stage_plain(x, *, split: bool, ldk: int | None = None):
    """What the staging pass writes for an (r, k) operand ``x`` (B enters
    as ``b.mT``): ``hi = bf16(x)`` and, if ``split``, ``lo = bf16(x − hi)``,
    each an (r, ldk) bf16 array, K-major (``ldk`` ≥ k, a multiple of 8; the
    kernel leaves columns past k unwritten, here zeros)."""
    r, k = x.shape
    ldk = ldk or _ldk(k)
    hi = torch.zeros((r, ldk), dtype=torch.bfloat16, device=x.device)
    hi[:, :k] = x.to(torch.bfloat16)
    if not split:
        return hi, None
    lo = torch.zeros_like(hi)
    lo[:, :k] = (x.float() - hi[:, :k].float()).to(torch.bfloat16)
    return hi, lo


def splitk_plain(a, b, split: int, bk: int, *, out_dtype=None):
    """:func:`tile_matmul_plain` in the kernel's split-k order: the f32
    product of each k slice (``ceil(ceil(k / bk) / split)`` stages of ``bk``
    each), the partials summed in slice order 0..split−1."""
    out_dtype = out_dtype or a.dtype
    k = a.shape[1]
    width = -(-(-(-k // bk)) // split) * bk
    total = None
    for k0 in range(0, max(k, 1), width):
        part = tile_matmul_plain(a[:, k0:k0 + width], b[k0:k0 + width],
                                 out_dtype=torch.float32)
        total = part if total is None else total + part
    return total.to(out_dtype)


def _ldk(k: int) -> int:
    """The leading dimension of the K-major staging scratch: k rounded up to
    8 bf16 (16 bytes, as TMA wants its row strides)."""
    return max(8, -(-k // 8) * 8)


_sm_counts: dict[int, int] = {}


def _sms(device) -> int:
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _sm_counts:
        _sm_counts[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _sm_counts[idx]


def tile_matmul(a, b, *, out_dtype=None):
    """C = A·B of 2-D f32 or bf16 operands, f32 accumulation; the result in
    ``out_dtype`` (default: the operands' dtype). f32 operands multiply in
    ``config.f32_precision``: ``"highest"`` (FP32) or ``"high"`` (bf16x3).
    One launch count a call, whatever kernels the plan runs."""
    out_dtype = out_dtype or a.dtype
    _check(a, b, out_dtype)
    if a.device.type == "cpu":
        return tile_matmul_plain(a, b, out_dtype=out_dtype)
    mode = _BF16_MODE if a.dtype == torch.bfloat16 else _MODES[config.tile_precision()]
    m, k = a.shape
    n = b.shape[1]
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    if m == 0 or n == 0:
        return out
    plan = plan_tile_matmul(m, n, k, a.dtype, config.tile_precision(), a.stride(),
                            b.stride(), a.data_ptr(), b.data_ptr(), _sms(a.device))
    ldk = _ldk(k)
    # one allocation for the staging scratch (hi, lo of A, then of B) and
    # the split-k workspace, each piece 256-byte aligned
    sizes = [m * ldk * 2 * (plan.a in ("pack", "split")), m * ldk * 2 * (plan.a == "split"),
             n * ldk * 2 * (plan.b in ("pack", "split")), n * ldk * 2 * (plan.b == "split"),
             plan.split * m * n * 4 * (plan.split > 1)]
    offsets, total = [], 0
    for size in sizes:
        offsets.append(total if size else None)
        total += -(-size // 256) * 256
    # held to the end of the call; freed after it, stream-ordered behind the launches
    scratch = torch.empty(total, dtype=torch.uint8, device=a.device) if total else None
    ah, al, bh, bl, work = (None if o is None else scratch.data_ptr() + o for o in offsets)
    with torch.cuda.device(a.device):  # the C entry launches on the current device
        code = _build.library().faer_tile_matmul(
            a.data_ptr(), a.stride(0), a.stride(1), b.data_ptr(), b.stride(0),
            b.stride(1), out.data_ptr(), m, n, k, mode,
            int(out_dtype == torch.bfloat16), _READS[plan.a], _READS[plan.b],
            plan.split, work, ah, al, bh, bl, ldk,
            _build.stream_of(a))
    _build.check("tile_matmul", code)
    count_launch("matmul")
    return out
