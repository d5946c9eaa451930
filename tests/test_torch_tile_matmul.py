"""The plan and the plain models of the redesigned ``tile_matmul`` on the CPU.

``plan_tile_matmul`` decides, before anything launches, the route (TMA +
``wgmma`` for bf16 and bf16x3, FFMA for FP32), the k slices and how each
operand is read; the C entry refuses a plan that does not fit its
operands, so these choices are what the card runs. ``splitk_plain`` is the
kernel's split-k order (slices summed 0..s−1) and ``stage_plain`` the
staging pass; both are held to the plain version and to ``split_bf16``.
The kernels themselves run in ``tests/test_torch_gpu.py`` and
``chip_smoke.py``. Tolerance: 16·eps of max‖a_i‖·max‖b_j‖, the limit of an
FP32 sum taken in another order (``chip_smoke.F32_TOL``).
"""
import numpy as np
import pytest
import torch

from faer_tpu_torch.core.config import config
from faer_tpu_torch.ops.kernels.matmul import (
    H100_SMS, MIN_SLICE_STAGES, plan_tile_matmul, split_bf16, splitk_plain, stage_plain,
    tile_matmul, tile_matmul_plain)

EPS32 = float(np.finfo(np.float32).eps)
F32_TOL = 16 * EPS32
N = 4096
F32, BF16 = torch.float32, torch.bfloat16


def _plan(m, k, n, dtype, mode, a_strides, b_strides, a_ptr=0, b_ptr=0):
    return plan_tile_matmul(m, n, k, dtype, mode, a_strides, b_strides, a_ptr, b_ptr)


@pytest.mark.parametrize("dtype,mode,route", [(F32, "highest", "ffma"),
                                              (F32, "high", "wgmma3"),
                                              (BF16, "highest", "wgmma"),
                                              (BF16, "high", "wgmma")])
def test_plan_4096_takes_no_split(dtype, mode, route):
    """A 4096³ product fills the card with output tiles: one CTA a tile
    walks all of k."""
    p = _plan(N, N, N, dtype, mode, (N, 1), (N, 1))
    assert p.route == route and p.split == 1


@pytest.mark.parametrize("dtype,mode,want", [(F32, "highest", (8, 32)),
                                             (F32, "high", (4, 16)),
                                             (BF16, "highest", (8, 16))])
def test_plan_thin_facade_shapes_split_k(dtype, mode, want):
    """The facade's Householder Vᵀ·B, (128, 4096)·(4096, 3968), and Vᵀ·b
    for 8 right-hand sides, each with a ``.mT`` lhs, cut k: 31 (16) and 1
    output tiles cannot fill 132 SMs."""
    vtb = _plan(128, N, N - 128, dtype, mode, (1, 128), (N - 128, 1))
    vtr = _plan(128, N, 8, dtype, mode, (1, 128), (8, 1))
    assert (vtb.split, vtr.split) == want
    for p in (vtb, vtr):
        stages = -(-N // p.bk)
        # no empty slice, none shorter than MIN_SLICE_STAGES
        assert -(-stages // p.split) * (p.split - 1) < stages
        assert stages // p.split >= MIN_SLICE_STAGES


def test_plan_split_only_when_the_tiles_leave_sms_idle():
    """k is cut only while the tiles fill at most half of the CTA slots."""
    for m, n in ((1024, 1024), (2048, 2048), (4096, 2048)):
        p = _plan(m, 16384, n, F32, "highest", (16384, 1), (n, 1))
        tiles = (m // 128) * (n // 128)
        assert (p.split > 1) == (2 * tiles <= 2 * H100_SMS)
    assert _plan(128, 64, 128, F32, "highest", (64, 1), (128, 1)).split == 1  # short k


@pytest.mark.parametrize("a_strides,b_strides,want", [
    ((N, 1), (N, 1), ("tma_k", "tma_mn")),      # nn
    ((1, N), (N, 1), ("tma_mn", "tma_mn")),     # tn
    ((N, 1), (1, N), ("tma_k", "tma_k")),       # nt
    ((1, N), (1, N), ("tma_mn", "tma_k")),      # tt
    ((4100, 1), (N, 1), ("pack", "tma_mn")),    # a row stride not 16-byte aligned
    ((N, 2), (N, 1), ("pack", "tma_mn")),       # no unit stride
])
def test_plan_bf16_reads(a_strides, b_strides, want):
    p = _plan(N, N, N, BF16, "highest", a_strides, b_strides)
    assert (p.a, p.b) == want


def test_plan_misaligned_operands_take_the_named_routes():
    """A view one element past an aligned base: bf16 packs into aligned
    scratch, bf16x3 splits (as always), FP32 copies 4 bytes at a time."""
    for a_ptr, b_ptr in ((2, 0), (0, 2)):
        p = _plan(N, N, N, BF16, "highest", (N, 1), (N, 1), a_ptr, b_ptr)
        assert (p.a == "pack") == (a_ptr == 2) and (p.b == "pack") == (b_ptr == 2)
    hi = _plan(N, N, N, F32, "high", (N, 1), (N, 1), 4, 4)
    assert (hi.a, hi.b) == ("split", "split")
    aligned = _plan(N, N, N, F32, "highest", (1, N), (N, 1))
    assert (aligned.a, aligned.b) == ("cp16_mn", "cp16_mn")
    off = _plan(N, N, N, F32, "highest", (1, N), (N, 1), 4, 4)
    assert (off.a, off.b) == ("cp4_mn", "cp4_mn")
    # K-major operands are copied 4 bytes at a time, walking k
    kmaj = _plan(N, N, N, F32, "highest", (N, 1), (1, N))
    assert (kmaj.a, kmaj.b) == ("cp4_k", "cp4_k")
    assert _plan(N, N, N, F32, "highest", (1, 4098), (N, 1)).a == "cp4_mn"  # k stride % 4
    with pytest.raises(ValueError):
        _plan(N, N, N, F32, "fast", (N, 1), (N, 1))


@pytest.mark.parametrize("split,bk", [(1, 32), (3, 32), (8, 32), (4, 64), (16, 64)])
@pytest.mark.parametrize("precision", ["highest", "high"])
def test_splitk_plain_matches_plain(monkeypatch, split, bk, precision):
    """The slices' f32 partials summed in order 0..s−1 equal the one-pass
    plain product within 16·eps of max‖a_i‖·max‖b_j‖ (another order of the
    same sums), in both f32 modes and for bf16 operands."""
    monkeypatch.setattr(config, "f32_precision", precision)
    rng = np.random.default_rng(split * 7 + bk)
    a = torch.from_numpy(rng.standard_normal((96, 1000)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((1000, 40)).astype(np.float32))
    for x, y in ((a, b), (a.bfloat16(), b.bfloat16())):
        scale = (x.float().norm(dim=1).max() * y.float().norm(dim=0).max()).item()
        got = splitk_plain(x, y, split, bk, out_dtype=F32)
        want = tile_matmul_plain(x, y, out_dtype=F32)
        assert (got - want).abs().max().item() <= F32_TOL * scale


def test_splitk_plain_sums_slices_in_order():
    """Slice z covers k in [z·w, (z+1)·w), w = ceil(ceil(k/bk)/split)·bk:
    with a one-hot k the sum is exactly the one slice's product."""
    a = torch.zeros(4, 200)
    b = torch.zeros(200, 3)
    a[:, 150], b[150] = 2.0, 3.0
    assert torch.equal(splitk_plain(a, b, 4, 32), torch.full((4, 3), 6.0))
    # split 7 over 7 stages of 32 leaves a ragged last slice of 8
    assert torch.equal(splitk_plain(a, b, 7, 32), torch.full((4, 3), 6.0))


@pytest.mark.parametrize("shape,transposed", [((70, 300), False), ((70, 300), True),
                                              ((5, 3), False), ((129, 1), True)])
def test_stage_plain_equals_split_bf16_bit_for_bit(shape, transposed):
    """The staging pass's plain version: hi and lo are ``split_bf16``'s, bit
    for bit, in K-major scratch whose leading dimension is k rounded up to
    8; a bf16 operand's pack is the operand itself."""
    rng = np.random.default_rng(sum(shape))
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * 1e3)
    if transposed:
        x = x.T.contiguous().mT
    r, k = x.shape
    hi, lo = stage_plain(x, split=True)
    want_hi, want_lo = split_bf16(x)
    assert hi.shape == lo.shape == (r, max(8, -(-k // 8) * 8)) and hi.dtype == BF16
    assert torch.equal(hi[:, :k].float().view(torch.int32), want_hi.view(torch.int32))
    assert torch.equal(lo[:, :k].float().view(torch.int32), want_lo.view(torch.int32))
    packed, none = stage_plain(x.bfloat16(), split=False)
    assert none is None and torch.equal(packed[:, :k], x.bfloat16())


def test_cpu_wrapper_runs_the_plain_version():
    """On CPU tensors ``tile_matmul`` runs its plain version, whatever the
    plan would be on the card."""
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.standard_normal((128, 512)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((512, 8)).astype(np.float32))
    assert torch.equal(tile_matmul(a.mT.contiguous().mT, b), tile_matmul_plain(a, b))
