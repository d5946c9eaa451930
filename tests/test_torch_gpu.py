"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here needs a CUDA card (marker ``gpu``) and skips without one;
whether a card is present is decided inside the ``cuda`` fixture, never at
import. Run them on the card with

    python -m pytest tests/test_torch_gpu.py -q --noconftest

(``--noconftest``: ``tests/conftest.py`` imports JAX, which a machine that
runs only the port need not have.)

Shapes are small (the main-path shapes are checked by ``chip_smoke.py``),
except for the LU panels of the CALU leaf, which run at its shapes.
Tolerances: 8·n·eps_f32 relative to the largest entry, times the block's
2-norm condition number for ``trtri`` (a forward error); residuals for LU
leaves on Gaussian panels, whose pivots may differ under rounding; for the
tile kernels 16·eps (FP32 sums) or 2e-5 (bf16x3) of max‖a_i‖·max‖b_j‖.
"""
import numpy as np
import pytest
import torch

from faer_tpu_torch.core.config import launch_counts, reset_launch_counts

pytestmark = pytest.mark.gpu

EPS32 = float(np.finfo(np.float32).eps)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _rel(got, want):
    return ((got - want).abs().max() / want.abs().max()).item()


@pytest.mark.parametrize("n,unit", [(32, False), (100, False), (128, True),
                                    (100, True)])
def test_trtri_kernel(cuda, n, unit):
    from faer_tpu_torch.ops.kernels.trtri import trtri, trtri_plain

    gen = torch.Generator(device=cuda).manual_seed(n)
    g = torch.randn(n, n, generator=gen, device=cuda)
    if unit:
        # strict entries N(0, 1/n) keep κ O(1); the stored diagonal in [2, 3]
        # must be ignored
        lo = torch.tril(g / n ** 0.5, -1) + torch.diag(
            2 + torch.rand(n, generator=gen, device=cuda))
    else:
        lo = torch.linalg.cholesky(g @ g.T / n + torch.eye(n, device=cuda))
    # garbage above the diagonal: never read
    t = (lo + torch.triu(torch.randn(n, n, generator=gen, device=cuda), 1)).contiguous()
    reset_launch_counts()
    got = trtri(t, unit=unit)
    torch.cuda.synchronize()
    assert launch_counts()["trtri"] == 1
    assert bool((torch.triu(got, 1) == 0).all())
    want = trtri_plain(t, unit=unit)
    lo64 = torch.tril(t.double(), -1) + (
        torch.eye(n, dtype=torch.float64, device=cuda) if unit
        else torch.diag(torch.diagonal(t).double()))
    tol = 8 * n * EPS32 * torch.linalg.cond(lo64).item()
    assert _rel(got, want) <= tol
    assert _rel(got.double(), torch.linalg.inv(lo64)) <= tol


@pytest.mark.parametrize("m,b", [(160, 32), (256, 64), (640, 128)])
def test_llt_panel_kernel(cuda, m, b):
    from faer_tpu_torch.ops.kernels.llt_panel import llt_panel, llt_panel_plain

    gen = torch.Generator(device=cuda).manual_seed(m)
    g = torch.randn(m, m, generator=gen, device=cuda)
    slab = (g @ g.T / m + torch.eye(m, device=cuda))[:, :b].contiguous()
    reset_launch_counts()
    s1, c1, o1 = llt_panel(slab)
    torch.cuda.synchronize()
    assert launch_counts()["llt_panel"] == 1
    s2, c2, o2 = llt_panel_plain(slab)
    assert bool(o1) and bool(o2) and int(c1) == int(c2) == 0
    assert _rel(s1, s2) <= 8 * b * EPS32


@pytest.mark.parametrize("m,b", [(160, 32), (256, 64)])
def test_llt_panel_kernel_regularized(cuda, m, b):
    """Dynamic regularization (eps > 0): A = L Lᵀ + D where L has zero
    diagonal entries at a few columns and D puts -1e-3 there, so those
    pivots are clearly negative under any rounding. Each is counted, makes
    ok false, and is replaced by eps; every other pivot is ≥ 1."""
    from faer_tpu_torch.ops.kernels.llt_panel import llt_panel, llt_panel_plain

    gen = torch.Generator(device=cuda).manual_seed(m + 1)
    lo = torch.tril(torch.randn(m, m, generator=gen, device=cuda) / m ** 0.5, -1)
    diag = 1 + torch.rand(m, generator=gen, device=cuda)
    bad = torch.tensor([3, b // 2, b - 1], device=cuda)
    diag[bad] = 0.0
    lo = lo + torch.diag(diag)
    a = lo @ lo.T
    a[bad, bad] -= 1e-3
    slab = a[:, :b].contiguous()
    reset_launch_counts()
    s1, c1, o1 = llt_panel(slab, eps=1.0, delta=1e-2)
    torch.cuda.synchronize()
    assert launch_counts()["llt_panel"] == 1
    s2, c2, o2 = llt_panel_plain(slab, eps=1.0, delta=1e-2)
    assert int(c1) == int(c2) == 3 and not bool(o1) and not bool(o2)
    assert _rel(s1, s2) <= 8 * b * EPS32


@pytest.mark.parametrize("m,b", [(160, 32), (256, 64), (1000, 128), (40000, 256)])
def test_lu_panel_kernel(cuda, m, b):
    """(40000, 256): the rows (40 MiB) exceed the card's shared memory, so
    the kernel keeps them in global memory."""
    from faer_tpu_torch.ops.kernels.lu_panel import lu_panel, lu_panel_plain

    gen = torch.Generator(device=cuda).manual_seed(m)
    lo = torch.tril((torch.rand(m, b, generator=gen, device=cuda) - 0.5) / b ** 0.5, -1)
    lo = lo + torch.eye(m, b, device=cuda)
    up = torch.triu(torch.randn(b, b, generator=gen, device=cuda), 1) / b ** 0.5
    up = up + torch.diag(1 + torch.rand(b, generator=gen, device=cuda))
    p = torch.randperm(m, generator=gen, device=cuda)
    a = torch.empty(m, b, device=cuda)
    a[p] = lo @ up
    reset_launch_counts()
    k1, p1, n1, o1 = lu_panel(a)
    torch.cuda.synchronize()
    assert launch_counts()["lu_panel"] == 1
    k2, p2, n2, o2 = lu_panel_plain(a)
    assert torch.equal(p1, p2) and torch.equal(p1[:b], p[:b])
    assert int(n1) == int(n2) and bool(o1) and bool(o2)
    assert _rel(k1, k2) <= 8 * m * EPS32


@pytest.mark.parametrize("m,b,zero_col", [(160, 32, None), (1000, 128, None),
                                           (200, 44, 5), (60000, 128, None),
                                           (16384, 512, None)])
def test_qr_panel_kernel(cuda, m, b, zero_col):
    """(60000, 128) and (16384, 512): a CTA's rows (455 × 129 × 4 B and
    125 × 513 × 4 B) exceed its 227 KiB of shared memory, so the kernel keeps
    them in global memory."""
    from faer_tpu_torch.ops.householder import apply_block_on_left, form_block_t
    from faer_tpu_torch.ops.kernels.qr_panel import qr_panel, qr_panel_plain

    gen = torch.Generator(device=cuda).manual_seed(m + b)
    a = torch.randn(m, b, generator=gen, device=cuda)
    if zero_col is not None:
        a[:, zero_col] = 0.0
    reset_launch_counts()
    k1, t1 = qr_panel(a)
    torch.cuda.synchronize()
    assert launch_counts()["qr_panel"] == 1
    k2, t2 = qr_panel_plain(a)
    k3, t3 = torch.geqrf(a)
    # Gaussian panels with m ≥ 4b have κ ≤ 3: R and the reflector tails V
    # each within 8·m·eps relative to their own largest entry
    tol = 8 * m * EPS32
    r1, v1 = torch.triu(k1[:b]), torch.tril(k1, -1)
    for k, t in ((k2, t2), (k3, t3)):
        assert _rel(r1, torch.triu(k[:b])) <= tol
        assert _rel(v1, torch.tril(k, -1)) <= tol
        assert (t1 - t).abs().max().item() <= tol
    # Q = I − V T Vᵀ orthogonal and Q·R = A, to 8·m·eps
    v = v1 + torch.eye(m, b, device=cuda)
    q = apply_block_on_left(v, form_block_t(v, t1), torch.eye(m, b, device=cuda),
                            adjoint=False)
    assert (q.T @ q - torch.eye(b, device=cuda)).abs().max().item() <= tol
    assert ((q @ r1 - a).norm() / a.norm()).item() <= tol
    if zero_col is not None:
        assert t1[zero_col].item() == 0.0
        assert bool((k1[zero_col:, zero_col] == 0).all())


@pytest.mark.parametrize("b,reg", [(128, None), (80, None), (44, (1.0, 2.0))])
def test_llt_leaf_kernel(cuda, b, reg):
    """``reg``: eps > 0 with delta ≥ 1, so every real pivot below 2 and
    none of the identity padding's is counted."""
    from faer_tpu_torch.ops.kernels.leaf import llt_leaf, llt_leaf_plain

    gen = torch.Generator(device=cuda).manual_seed(b)
    g = torch.randn(b, b, generator=gen, device=cuda)
    a = g @ g.T / b + torch.eye(b, device=cuda)
    eps, delta = reg or (0.0, 0.0)
    reset_launch_counts()
    l1, c1, o1 = llt_leaf(a, eps=eps, delta=delta)
    torch.cuda.synchronize()
    assert launch_counts()["llt_leaf"] == 1 and launch_counts()["llt_panel"] == 0
    l2, c2, o2 = llt_leaf_plain(a, eps=eps, delta=delta)
    assert l1.shape == (b, b) and int(c1) == int(c2) and bool(o1) and bool(o2)
    if reg:
        assert 0 < int(c1) <= b
    assert _rel(l1, l2) <= 8 * b * EPS32


@pytest.mark.parametrize("m,b", [(1000, 64), (300, 44), (44, 44)])
def test_lu_leaf_kernel(cuda, m, b):
    from faer_tpu_torch.ops.kernels.leaf import lu_leaf, lu_leaf_plain

    gen = torch.Generator(device=cuda).manual_seed(m + b)
    a = torch.randn(m, b, generator=gen, device=cuda)
    reset_launch_counts()
    k1, p1, n1, o1 = lu_leaf(a)
    torch.cuda.synchronize()
    assert launch_counts()["lu_leaf"] == 1 and launch_counts()["lu_panel"] == 0
    k2, p2, n2, o2 = lu_leaf_plain(a)
    # residual of the kernel's factor, and the parity of nt against the plain
    lo = torch.tril(k1, -1) + torch.eye(m, b, device=cuda)
    res = (lo @ torch.triu(k1[:b]) - a[p1]).norm() / a.norm()
    assert res.item() <= 8 * m * EPS32
    assert int(n1) % 2 == int(n2) % 2 and bool(o1) and bool(o2)


def _separated_panel(m, b, gen, cuda):
    """P·L·U with |L| ≤ 1/(2√b) below a unit diagonal: the pivot order is
    the same under any rounding (as in chip_smoke.py)."""
    lo = torch.tril((torch.rand(m, b, generator=gen, device=cuda) - 0.5) / b ** 0.5, -1)
    lo = lo + torch.eye(m, b, device=cuda)
    up = torch.triu(torch.randn(b, b, generator=gen, device=cuda), 1) / b ** 0.5
    up = up + torch.diag(1 + torch.rand(b, generator=gen, device=cuda))
    p = torch.randperm(m, generator=gen, device=cuda)
    a = torch.empty(m, b, device=cuda)
    a[p] = lo @ up
    return a, p


def _lu_rec(a, packed, perm):
    """‖A[perm] − L·U‖ / ‖A‖ of a packed (m, b) panel factor."""
    m, b = a.shape
    lo = torch.tril(packed, -1) + torch.eye(m, b, device=a.device)
    return ((lo @ torch.triu(packed[:b]) - a[perm]).norm() / a.norm()).item()


@pytest.mark.parametrize("name", ["lu_panel_v2", "lu_panel_v3", "lu_panel_swap"])
@pytest.mark.parametrize("m,b", [(4096, 256), (4096, 128), (1000, 100), (40000, 256)])
def test_lu_panel_v2_v3_swap_kernels(cuda, name, m, b):
    """Against the plain version on separated pivots: perm, nt and ok
    exactly, packed within 8·m·eps of its largest entry. (40000, 256): the
    rows (40 MiB) exceed the card's shared memory, so they stay in global
    memory."""
    import importlib

    mod = importlib.import_module(f"faer_tpu_torch.ops.kernels.{name}")
    kern, plain = getattr(mod, name), getattr(mod, f"{name}_plain")
    gen = torch.Generator(device=cuda).manual_seed(m + b)
    a, p = _separated_panel(m, b, gen, cuda)
    reset_launch_counts()
    k1, p1, n1, o1 = kern(a)
    torch.cuda.synchronize()
    assert launch_counts()[name] == 1
    assert sum(launch_counts().values()) == 1
    k2, p2, n2, o2 = plain(a)
    assert torch.equal(p1, p2) and torch.equal(p1[:b], p[:b])
    assert int(n1) == int(n2) and bool(o1) and bool(o2)
    assert _rel(k1, k2) <= 8 * m * EPS32
    assert _lu_rec(a, k1, p1) <= 8 * m * EPS32


@pytest.mark.parametrize("g,m,b", [(16, 4096, 256), (5, 1000, 100), (3, 256, 256)])
def test_lu_panel_v2_batched_kernel(cuda, g, m, b):
    """One launch for the stack; each panel equals ``lu_panel_v2`` on it to
    the bit (the same kernel, whatever the CTAs per panel: every row is
    updated by the same operations, and the pivot search is exact) and its
    plain version within 8·m·eps."""
    from faer_tpu_torch.ops.kernels.lu_panel_v2 import (
        lu_panel_v2, lu_panel_v2_batched, lu_panel_v2_plain)

    gen = torch.Generator(device=cuda).manual_seed(g * m + b)
    stack = torch.stack([_separated_panel(m, b, gen, cuda)[0] for _ in range(g)])
    reset_launch_counts()
    got = lu_panel_v2_batched(stack)
    torch.cuda.synchronize()
    assert launch_counts()["lu_panel_v2"] == 1
    for q in range(g):
        for x, y in zip(got, lu_panel_v2(stack[q])):
            assert torch.equal(x[q], y)
        k2, p2, n2, o2 = lu_panel_v2_plain(stack[q])
        assert torch.equal(got[1][q], p2) and int(got[2][q]) == int(n2)
        assert bool(got[3][q]) and bool(o2)
        assert _rel(got[0][q], k2) <= 8 * m * EPS32


def test_lu_in_place_through_calu_on_card(cuda, monkeypatch):
    """The gate at 512 sends each of a (3000, 256) matrix's four 64-wide
    leaves (2808–3000 rows) through the tournament: 6 groups in one batched
    launch, then the stacked candidates; no lu_leaf launch."""
    from faer_tpu_torch import lu_in_place
    from faer_tpu_torch.linalg import lu as tlu

    monkeypatch.setattr(tlu, "_CALU_GROUP", 512)
    gen = torch.Generator(device=cuda).manual_seed(3)
    a = torch.randn(3000, 256, generator=gen, device=cuda)
    reset_launch_counts()
    lu, perm, info = lu_in_place(a)
    torch.cuda.synchronize()
    counts = launch_counts()
    assert counts["lu_panel_v2"] == 8 and counts["lu_leaf"] == 0
    assert bool(info.success)
    assert _lu_rec(a, lu, perm) <= 8 * 3000 * EPS32


def test_lu_panel_v2_batched_raises_past_co_residency(cuda):
    from faer_tpu_torch.ops.kernels.lu_panel_v2 import lu_panel_v2_batched

    with pytest.raises(RuntimeError, match="co-resident"):
        lu_panel_v2_batched(torch.ones(4000, 64, 64, device=cuda))


def test_qr_in_place_on_card(cuda):
    from faer_tpu_torch import qr_compute_q, qr_in_place, qr_reconstruct

    n = 1024
    gen = torch.Generator(device=cuda).manual_seed(n)
    a = torch.randn(n, n, generator=gen, device=cuda)
    reset_launch_counts()
    pk, ts, blk = qr_in_place(a)
    torch.cuda.synchronize()
    # block 256, leaves of 128: one qr_panel launch per 128 columns
    assert blk == 256 and launch_counts()["qr_panel"] == n // 128
    rec = (qr_reconstruct(pk, ts, blk) - a).norm() / a.norm()
    q = qr_compute_q(pk, ts, blk)
    orth = (q.T @ q - torch.eye(n, device=cuda)).abs().max()
    assert rec.item() <= 8 * n * EPS32 and orth.item() <= 8 * n * EPS32


def test_qr_in_place_wide_leaves_on_card(cuda):
    """kernel_leaf = 512 at 16384 × 2048: block 512, one 512-wide leaf per
    panel, each with more rows per CTA than shared memory holds."""
    from faer_tpu_torch import QrParams, qr_in_place, qr_solve_lstsq

    m, n = 16384, 2048
    gen = torch.Generator(device=cuda).manual_seed(m)
    a = torch.randn(m, n, generator=gen, device=cuda)
    b = torch.randn(m, 4, generator=gen, device=cuda)
    reset_launch_counts()
    pk, ts, blk = qr_in_place(a, QrParams(kernel_leaf=512))
    torch.cuda.synchronize()
    assert blk == 512 and launch_counts()["qr_panel"] == n // 512
    r = b - a @ qr_solve_lstsq(pk, ts, blk, b)
    orth = (a.T @ r).norm() / (a.norm() * r.norm())
    assert orth.item() <= 8 * m * EPS32


def test_factors_of_transposed_inputs_on_card(cuda):
    """A strided (transposed) input gives the same factor as its contiguous
    copy, on the fused and the recursive routes."""
    from faer_tpu_torch import llt_factor, lu_in_place, qr_in_place

    gen = torch.Generator(device=cuda).manual_seed(7)
    for n in (1024, 1000):
        g = torch.randn(n, n, generator=gen, device=cuda)
        spd = g @ g.T / n + torch.eye(n, device=cuda)
        gt = g.T.contiguous()
        for fn, x in ((llt_factor, spd), (lu_in_place, gt), (qr_in_place, gt)):
            got, want = fn(x.mT), fn(x.mT.contiguous())
            assert _rel(got[0], want[0]) <= 8 * n * EPS32, (fn.__name__, n)


def _sweep_case(n, l, m, bidiag, cuda):
    from faer_tpu_torch.linalg.bidiag_svd import _shift
    from faer_tpu_torch.linalg.tridiag_evd import _wilkinson_shift

    gen = torch.Generator(device=cuda).manual_seed(n + l)
    d = torch.randn(n, generator=gen, device=cuda) + (2.0 if bidiag else 0.0)
    e = torch.randn(n - 1, generator=gen, device=cuda)
    mu = _shift(d, e, m) if bidiag else _wilkinson_shift(d[m - 1], e[m - 1], d[m])
    return d, e, torch.tensor([l, m], dtype=torch.int32, device=cuda), mu.reshape(1)


@pytest.mark.parametrize("name", ["tridiag_sweep", "bidiag_sweep"])
@pytest.mark.parametrize("n,l,m", [(2, 0, 1), (64, 0, 63), (64, 5, 60), (384, 7, 370),
                                   (8192, 3, 600), (8192, 7000, 8191), (40, 9, 9),
                                   (40, 3, 40)])
def test_sweep_kernel(cuda, name, n, l, m):
    """Against the plain version, which rounds alike: equal to the bit. At
    n = 8192, d and e exceed the kernel's 48 KB of shared memory and stay in
    global memory; (9, 9) is an empty block and (3, 40) runs past n − 1:
    both are the identity sweep."""
    from faer_tpu_torch.ops.kernels import sweep

    args = _sweep_case(n, l, min(m, n - 1), name == "bidiag_sweep", cuda)
    args = (*args[:2], torch.tensor([l, m], dtype=torch.int32, device=cuda), args[3])
    reset_launch_counts()
    got = getattr(sweep, name)(*args)
    torch.cuda.synchronize()
    assert launch_counts()[name] == 1
    want = getattr(sweep, f"{name}_plain")(*args)
    assert len(got) == len(want) == (4 if name == "tridiag_sweep" else 6)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    for r, ident in zip(got[2:], (1.0, 0.0) * 2):
        assert bool((r[:l] == ident).all()) and bool((r[m:] == ident).all())
    if m > n - 1:
        assert torch.equal(got[0], args[0]) and bool((got[2] == 1).all())


def test_spectral_on_card(cuda):
    """The EVD and the SVD on the card through their sweep kernels: the D&C
    route (n = 600, leaves of 75 and less) and the direct QR route (n = 100)."""
    from faer_tpu_torch import self_adjoint_evd, svd

    gen = torch.Generator(device=cuda).manual_seed(11)
    for n in (600, 100):
        g = torch.randn(n, n, generator=gen, device=cuda)
        a = (g + g.T) / 2
        tol = 8 * n * EPS32
        eye = torch.eye(n, device=cuda)
        reset_launch_counts()
        w, v, info = self_adjoint_evd(a)
        torch.cuda.synchronize()
        assert launch_counts()["tridiag_sweep"] > 0 and bool(info.converged)
        assert ((a @ v - v * w).norm() / a.norm()).item() <= tol
        assert (v.T @ v - eye).abs().max().item() <= tol
        w64 = torch.linalg.eigvalsh(a.double())
        assert ((w.double() - w64).abs().max() / w64.abs().max()).item() <= tol
        reset_launch_counts()
        u, s, vs, info = svd(g)
        torch.cuda.synchronize()
        assert launch_counts()["bidiag_sweep"] > 0 and bool(info.converged)
        assert (((u * s) @ vs.T - g).norm() / g.norm()).item() <= tol
        assert (u.T @ u - eye).abs().max().item() <= tol
        assert (vs.T @ vs - eye).abs().max().item() <= tol
        s64 = torch.linalg.svdvals(g.double())
        assert ((s.double() - s64).abs().max() / s64[0]).item() <= tol


def test_wrapper_raises_instead_of_falling_back(cuda):
    from faer_tpu_torch.ops.kernels.llt_panel import llt_panel

    with pytest.raises(ValueError):
        llt_panel(torch.zeros(64, 48, device=cuda))  # b not a multiple of 32


# tile kernels' limits relative to max‖a_i‖·max‖b_j‖: an FP32 result differs
# from the plain one only in the order of its sums; bf16x3 drops al·bl and
# rounds the low halves, ≤ 3·2⁻¹⁸ of each |a_i b_i|, where one bf16 pass
# errs ~2⁻⁹ of each
F32_TOL = 16 * EPS32
BF16X3_TOL = 2e-5


def _row_col_scale(a, b):
    """max_i ‖a_i‖₂ · max_j ‖b_j‖₂: bounds |(|A||B|)_ij| by Cauchy–Schwarz."""
    return (a.float().norm(dim=1).max() * b.float().norm(dim=0).max()).item()


@pytest.mark.parametrize("precision", ["highest", "high"])
@pytest.mark.parametrize("layout", ["nn", "tn", "nt", "tt"])
@pytest.mark.parametrize("m,k,n", [(256, 128, 256), (300, 200, 260), (1, 33, 7),
                                   (129, 1, 130)])
def test_tile_matmul_kernel(cuda, monkeypatch, precision, layout, m, k, n):
    """f32 in both modes, with transposed (strided) operands and ragged
    edges: against the plain version and f64 within 16·eps of
    max‖a_i‖·max‖b_j‖ ("highest") or within 2e-5 ("high", bf16x3)."""
    from faer_tpu_torch.core.config import config
    from faer_tpu_torch.ops.kernels.matmul import tile_matmul, tile_matmul_plain

    monkeypatch.setattr(config, "f32_precision", precision)
    gen = torch.Generator(device=cuda).manual_seed(m * 7 + k * 3 + n)
    a = torch.randn(m, k, generator=gen, device=cuda)
    b = torch.randn(k, n, generator=gen, device=cuda)
    if layout[0] == "t":
        a = a.T.contiguous().mT
    if layout[1] == "t":
        b = b.T.contiguous().mT
    reset_launch_counts()
    got = tile_matmul(a, b)
    torch.cuda.synchronize()
    assert launch_counts()["matmul"] == 1
    assert got.dtype == torch.float32 and tuple(got.shape) == (m, n)
    scale = _row_col_scale(a, b)
    tol = BF16X3_TOL if precision == "high" else F32_TOL
    assert (got - tile_matmul_plain(a, b)).abs().max().item() <= tol * scale
    want64 = a.double() @ b.double()
    assert (got.double() - want64).abs().max().item() <= tol * scale


@pytest.mark.parametrize("out", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", [(256, 128, 256), (300, 200, 260)])
def test_tile_matmul_kernel_bf16(cuda, out, m, k, n):
    """bf16 operands, one pass, f32 sums: against the plain version within
    16·eps of max‖a_i‖·max‖b_j‖, past one bf16 rounding of each entry for
    a bf16 result."""
    from faer_tpu_torch.ops.kernels.matmul import tile_matmul, tile_matmul_plain

    gen = torch.Generator(device=cuda).manual_seed(m + n)
    a = torch.randn(m, k, generator=gen, device=cuda).bfloat16()
    b = torch.randn(k, n, generator=gen, device=cuda).bfloat16().T.contiguous().mT
    got = tile_matmul(a, b, out_dtype=out)
    want = tile_matmul_plain(a, b, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert got.dtype == out
    diff = (got.float() - want).abs()
    if out == torch.bfloat16:
        diff = (diff - 2.0 ** -8 * want.abs()).clamp_min(0)
    assert diff.max().item() <= F32_TOL * _row_col_scale(a, b)


@pytest.mark.parametrize("precision", ["highest", "high"])
@pytest.mark.parametrize("m,k", [(256, 128), (300, 200), (129, 1), (520, 64)])
def test_syrk_lower_sub_kernel(cuda, monkeypatch, precision, m, k):
    """The lower triangle against the plain version within 16·eps
    ("highest") or 2e-5 ("high") of max‖a_i‖²; above the diagonal C's
    values, exactly."""
    from faer_tpu_torch.core.config import config
    from faer_tpu_torch.ops.kernels.syrk import syrk_lower_sub, syrk_lower_sub_plain

    monkeypatch.setattr(config, "f32_precision", precision)
    gen = torch.Generator(device=cuda).manual_seed(m + k)
    c = torch.randn(m, m, generator=gen, device=cuda)
    a = torch.randn(k, m, generator=gen, device=cuda).mT  # strided
    reset_launch_counts()
    got = syrk_lower_sub(c, a)
    torch.cuda.synchronize()
    assert launch_counts()["syrk"] == 1
    want = syrk_lower_sub_plain(c, a)
    scale = a.norm(dim=1).max().item() ** 2
    tol = BF16X3_TOL if precision == "high" else F32_TOL
    assert (torch.tril(got - want)).abs().max().item() <= tol * scale
    assert torch.equal(torch.triu(got, 1), torch.triu(c, 1))


def test_tile_wrappers_raise_instead_of_falling_back(cuda):
    from faer_tpu_torch.ops.kernels.matmul import tile_matmul
    from faer_tpu_torch.ops.kernels.syrk import syrk_lower_sub

    x = torch.zeros(8, 8, device=cuda)
    with pytest.raises(TypeError):
        tile_matmul(x.double(), x.double())
    with pytest.raises(TypeError):
        tile_matmul(x, x.bfloat16())
    with pytest.raises(ValueError):
        tile_matmul(x, x.cpu())
    with pytest.raises(TypeError):
        syrk_lower_sub(x.double(), x.double())


def test_facade_on_card_with_tile_switch(cuda, monkeypatch):
    """``Mat`` and the solvers on the card with the tile GEMM switch on:
    the products above 128³ take ``tile_matmul``, residuals within 8·n·eps;
    with the switch off no product does."""
    from faer_tpu_torch import Mat
    from faer_tpu_torch.core.config import config

    n = 512
    gen = torch.Generator(device=cuda).manual_seed(5)
    g = torch.randn(n, n, generator=gen, device=cuda)
    spd = g @ g.T / n + torch.eye(n, device=cuda)
    b = torch.randn(n, 64, generator=gen, device=cuda)
    tol = 8 * n * EPS32

    def rel_res(a, x):
        return ((a @ x - b).norm() / (a.norm() * x.norm())).item()

    for on in (True, False):
        monkeypatch.setattr(config, "use_tile_matmul", on)
        reset_launch_counts()
        prod = (Mat(g) @ Mat(b)).a
        x1 = Mat(spd).llt().solve(b)
        x2 = Mat(g).partial_piv_lu().solve(b)
        x3 = Mat(g).qr().solve_lstsq(b)
        torch.cuda.synchronize()
        launches = launch_counts()["matmul"]
        assert (launches > 0) if on else (launches == 0)
        assert ((prod - g @ b).abs().max() / (g.abs().max() * b.abs().max())).item() <= tol
        assert max(rel_res(spd, x1), rel_res(g, x2), rel_res(g, x3)) <= tol
