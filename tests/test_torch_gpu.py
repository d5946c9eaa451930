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
import os

import numpy as np
import pytest
import torch

from faer_tpu_torch.core.config import launch_counts, reset_launch_counts

pytestmark = pytest.mark.gpu

EPS32 = float(np.finfo(np.float32).eps)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _rel(got, want):
    return ((got - want).abs().max() / want.abs().max()).item()


def _lower_with_junk(n, unit, gen, cuda):
    """A lower triangle with garbage above the diagonal, which is never read.
    Unit: strict entries N(0, 1/n) keep κ O(1), and the stored diagonal in
    [2, 3] must be ignored; else the Cholesky factor of g gᵀ/n + I."""
    g = torch.randn(n, n, generator=gen, device=cuda)
    if unit:
        lo = torch.tril(g / n ** 0.5, -1) + torch.diag(
            2 + torch.rand(n, generator=gen, device=cuda))
    else:
        lo = torch.linalg.cholesky(g @ g.T / n + torch.eye(n, device=cuda))
    return lo + torch.triu(torch.randn(n, n, generator=gen, device=cuda), 1)


def _structured64(t, unit):
    """The f64 lower-triangular matrix that ``trtri`` inverts for ``t``."""
    return torch.tril(t.double(), -1) + (
        torch.eye(t.shape[0], dtype=torch.float64, device=t.device) if unit
        else torch.diag(torch.diagonal(t).double()))


@pytest.mark.parametrize("n,unit", [(32, False), (100, False), (128, True),
                                    (100, True), (1, False), (16, True), (17, False),
                                    (128, False)])
def test_trtri_kernel(cuda, n, unit):
    from faer_tpu_torch.ops.kernels.trtri import trtri, trtri_plain

    t = _lower_with_junk(n, unit, torch.Generator(device=cuda).manual_seed(n), cuda)
    reset_launch_counts()
    got = trtri(t, unit=unit)
    torch.cuda.synchronize()
    assert launch_counts()["trtri"] == 1
    assert bool((torch.triu(got, 1) == 0).all())
    want = trtri_plain(t, unit=unit)
    lo64 = _structured64(t, unit)
    tol = 8 * n * EPS32 * torch.linalg.cond(lo64).item()
    assert _rel(got, want) <= tol
    assert _rel(got.double(), torch.linalg.inv(lo64)) <= tol


def _trtri_views(lo, gen):
    """The same lower triangle contiguous, as an (n, n) view with row stride
    n + 3, and as the ``.mT`` view of its contiguous transpose."""
    n = lo.shape[0]
    buf = torch.randn(n + 3, n + 3, generator=gen, device=lo.device)
    buf[:n, :n] = lo
    return {"contiguous": lo.contiguous(), "row stride n+3": buf[:n, :n],
            "transposed": lo.mT.contiguous().mT}


@pytest.mark.parametrize("unit", [False, True])
@pytest.mark.parametrize("n,plan", [(300, "leaves"), (1000, "diagonal blocks"),
                                    (4000, "diagonal blocks"), (8300, "leaves")])
def test_trtri_batched_kernel(cuda, n, plan, unit):
    """One CTA a block over views of one matrix: each slot within
    8·s·eps·κ₂ of ``trtri_batched_plain`` and of the kernel's own order
    (``trtri_blocked_plain``), zero past its size, the same whatever the
    view, and bit for bit a single launch on that block. 8300's 128 leaves
    take two launches."""
    from faer_tpu_torch.ops.kernels.trtri import (
        MAX_BATCH, trtri, trtri_batched, trtri_batched_plain, trtri_blocked_plain)
    from faer_tpu_torch.ops.triangular import leaf_plan

    gen = torch.Generator(device=cuda).manual_seed(n + unit)
    lo = _lower_with_junk(n, unit, gen, cuda)
    blocks = (leaf_plan(n) if plan == "leaves" else
              [(o, min(128, n - o)) for o in range(0, n, 128)])
    views = _trtri_views(lo, gen)
    ref = None
    for name, t in views.items():
        reset_launch_counts()
        got = trtri_batched(t, blocks, unit=unit)
        torch.cuda.synchronize()
        assert launch_counts()["trtri"] == -(-len(blocks) // MAX_BATCH)
        if ref is None:
            ref = got
            want = trtri_batched_plain(t, blocks, unit=unit)
            for i, (o, s) in enumerate(blocks):
                blk = t[o:o + s, o:o + s]
                tol = 8 * s * EPS32 * torch.linalg.cond(_structured64(blk, unit)).item()
                assert _rel(got[i, :s, :s], want[i, :s, :s]) <= tol
                assert _rel(got[i, :s, :s], trtri_blocked_plain(blk, unit=unit)) <= tol
                assert not got[i, s:].any() and not got[i, :, s:].any()
                if i in (0, len(blocks) - 1):  # the first and the (ragged) last
                    assert torch.equal(got[i, :s, :s], trtri(blk, unit=unit))
        assert torch.equal(got, ref), name


@pytest.mark.parametrize("name", ["solve_lower_triangular", "solve_upper_triangular",
                                  "solve_lower_triangular_transpose"])
def test_triangular_solve_launches_trtri_once(cuda, name):
    """A 1000-row solve (8 blocks, the last of 104 rows), 8 rhs: exactly one
    ``trtri`` launch, residual within 8·n·eps."""
    from faer_tpu_torch.ops import triangular_solve as tts

    n = 1000
    gen = torch.Generator(device=cuda).manual_seed(5)
    lo = _lower_with_junk(n, False, gen, cuda)
    t = lo if "lower" in name else lo.mT.contiguous()
    b = torch.randn(n, 8, generator=gen, device=cuda)
    reset_launch_counts()
    x = getattr(tts, name)(t, b)
    torch.cuda.synchronize()
    assert launch_counts()["trtri"] == 1
    tri = torch.tril(lo) if "lower" in name else torch.triu(t)
    if "transpose" in name:
        tri = tri.mT
    res = ((tri @ x - b).norm() / (tri.norm() * x.norm())).item()
    assert res <= 8 * n * EPS32


def _llt_checks(slab, eps=0.0, delta=0.0, bad=0):
    """One ``llt_panel`` launch on ``slab`` against ``llt_panel_plain`` (the
    Pallas body's math, within 8·b·eps_f32 of max|strip|) and the kernel's
    own order ``llt_panel_blocked_plain`` (the same operations in the same
    order: within 16·eps_f32, as its f64 emulation of fma can round twice),
    count and ok equal (``bad`` counted pivots, ok false when any)."""
    from faer_tpu_torch.ops.kernels.llt_panel import (
        llt_panel, llt_panel_blocked_plain, llt_panel_plain)

    b = slab.shape[1]
    reset_launch_counts()
    s1, c1, o1 = llt_panel(slab, eps=eps, delta=delta)
    torch.cuda.synchronize()
    assert launch_counts()["llt_panel"] == 1
    s2, c2, o2 = llt_panel_plain(slab, eps=eps, delta=delta)
    s3, c3, o3 = llt_panel_blocked_plain(slab, eps=eps, delta=delta)
    assert int(c1) == int(c2) == int(c3) == bad
    assert bool(o1) == bool(o2) == bool(o3) == (bad == 0)
    assert torch.isfinite(s1).all() and torch.equal(torch.triu(s1[:b], 1), torch.zeros_like(s1[:b]))
    assert _rel(s1, s2) <= 8 * b * EPS32
    assert _rel(s1, s3) <= 16 * EPS32
    return s1


def _llt_slab(m, b, gen, cuda):
    """[A11; A21]: A11 = g gᵀ/b + I, A21 Gaussian."""
    g = torch.randn(b, b, generator=gen, device=cuda)
    a11 = g @ g.T / b + torch.eye(b, device=cuda)
    return torch.cat([a11, torch.randn(m - b, b, generator=gen, device=cuda)])


@pytest.mark.parametrize("m,b", [(160, 32), (256, 64), (640, 128), (4096, 32), (4096, 128),
                                 (4096, 256), (4096, 512), (256, 256), (1000, 256),
                                 (65536, 256), (200000, 256)])
def test_llt_panel_kernel(cuda, m, b):
    """SPD slabs, b from 32 to 512 and m from b to 200 000 (65536 and past
    on the route with the rows in global memory)."""
    gen = torch.Generator(device=cuda).manual_seed(m)
    if m <= 640:
        g = torch.randn(m, m, generator=gen, device=cuda)
        slab = (g @ g.T / m + torch.eye(m, device=cuda))[:, :b].contiguous()
    else:
        slab = _llt_slab(m, b, gen, cuda)
    _llt_checks(slab)


@pytest.mark.parametrize("m,b", [(3840, 256), (1024, 256), (4096, 512)])
def test_llt_panel_kernel_on_row_strided_views(cuda, m, b):
    """The main path's views, row stride 1024 (``pblock[:, :bw]`` of a
    1024-wide strip, ``linalg/cholesky.py``), NaN past the view: held like
    the others, and equal to a contiguous copy's result to the bit."""
    from faer_tpu_torch.ops.kernels.llt_panel import llt_panel

    gen = torch.Generator(device=cuda).manual_seed(m + b)
    strip = torch.full((m, 1024), float("nan"), device=cuda)
    strip[:, :b] = _llt_slab(m, b, gen, cuda)
    view = strip[:, :b]
    s1 = _llt_checks(view)
    assert torch.equal(s1, llt_panel(view.contiguous())[0])


@pytest.mark.parametrize("m,b", [(160, 32), (256, 64), (4096, 256), (4096, 512)])
def test_llt_panel_kernel_regularized(cuda, m, b):
    """Dynamic regularization (eps > 0): A = L Lᵀ + D where L has zero
    diagonal entries at a few columns and D puts -1e-3 there, so those
    pivots are clearly negative under any rounding. Each is counted, makes
    ok false, and is replaced by eps; every other pivot is ≥ 1."""
    gen = torch.Generator(device=cuda).manual_seed(m + 1)
    n = min(m, 640)
    lo = torch.tril(torch.randn(n, n, generator=gen, device=cuda) / n ** 0.5, -1)
    diag = 1 + torch.rand(n, generator=gen, device=cuda)
    bad = torch.tensor([3, b // 2, b - 1], device=cuda)
    diag[bad] = 0.0
    lo = lo + torch.diag(diag)
    lo[:, bad] = 0.0  # so that no later pivot cancels to a tiny positive one
    a = lo @ lo.T
    a[bad, bad] -= 1e-3
    slab = a[:, :b].contiguous()
    if m > n:
        slab = torch.cat([slab[:b], torch.randn(m - b, b, generator=gen, device=cuda)])
    _llt_checks(slab, eps=1.0, delta=1e-2, bad=3)


def test_llt_panel_routes(cuda):
    """The route is the C entry's alone: the main path's slabs (m ≤ 4096)
    keep their rows in shared memory, the 65536- and 200000-row slabs in
    global memory, on both sides of the edge found by bisection; every
    CTA's rows are a multiple of 32, every CTA has rows, the scratch is the
    wrapper's count, and nothing the parent took is refused. A tall slab's first rows equal the whole
    result's to the bit across the two routes, and so does a slab on its
    shared-memory edge against one row more."""
    from faer_tpu_torch.core.errors import ShapeError
    from faer_tpu_torch.ops.kernels.llt_panel import _route_code, llt_panel, route, shared_edge

    for m, b in ((4096, 256), (3840, 256), (256, 256), (4096, 512), (160, 32)):
        name, ctas, rpc = route(m, b, cuda)
        assert name == "rows in shared memory" and rpc % 32 == 0
        assert (ctas - 1) * rpc < m <= ctas * rpc
        # the wrapper sizes the scratch from b alone, as the C entry counts it
        assert _route_code(m, b, cuda)[3] == b * b + b + 4 * (b // 32)
    for m in (65536, 200000):
        name, ctas, rpc = route(m, 256, cuda)
        assert name == "rows in global memory" and (ctas - 1) * rpc < m <= ctas * rpc
    for b in (256, 512):
        e = shared_edge(b, cuda)
        assert route(e, b, cuda)[0] == "rows in shared memory"
        assert route(e + 1, b, cuda)[0] == "rows in global memory"
    for m, b in ((100, 48), (100, 544), (32, 64)):
        with pytest.raises(ShapeError):
            route(m, b, cuda)
    gen = torch.Generator(device=cuda).manual_seed(3)
    a = _llt_slab(200000, 256, gen, cuda)
    assert torch.equal(llt_panel(a)[0][:4096], llt_panel(a[:4096])[0])
    e = shared_edge(256, cuda)
    assert torch.equal(llt_panel(a[:e + 1])[0][:e], llt_panel(a[:e])[0])


def test_llt_panel_shared_rows_equal_global_rows(cuda):
    """The rows in shared memory against the rows forced into global memory
    on the same slabs (the profile build of ``tools/torch_profile.py``), to
    the bit: every row's arithmetic is done in one order on both routes."""
    import ctypes
    import sys

    sys.path.insert(0, os.path.join(REPO, "tools"))
    import torch_profile

    from faer_tpu_torch.ops.kernels.llt_panel import llt_panel, route

    lib = torch_profile.build("llt_panel")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.faer_llt_panel_route.argtypes = [I, I, P, P, P]
    lib.faer_llt_panel_profile_force_global.argtypes = [I]
    stream = torch.cuda.current_stream().cuda_stream
    for m, b in ((4096, 256), (256, 256), (1000, 64), (4096, 512)):
        gen = torch.Generator(device=cuda).manual_seed(m + b)
        a = _llt_slab(m, b, gen, cuda)
        assert route(m, b, cuda)[0] == "rows in shared memory"
        want = llt_panel(a)
        lib.faer_llt_panel_profile_force_global(1)
        ctas, rpc, nscratch = ctypes.c_int(), ctypes.c_int(), ctypes.c_longlong()
        try:
            assert lib.faer_llt_panel_route(m, b, ctypes.byref(ctas), ctypes.byref(rpc),
                                            ctypes.byref(nscratch)) == 0
            got = torch.empty(m, b, device=cuda)
            cnt_ok = torch.empty(2, dtype=torch.int32, device=cuda)
            scratch = torch.empty(nscratch.value, device=cuda)
            assert lib.faer_llt_panel(a.data_ptr(), b, got.data_ptr(), scratch.data_ptr(),
                                      nscratch.value, cnt_ok.data_ptr(), m, b, 0.0, 0.0,
                                      stream) == 0
        finally:
            lib.faer_llt_panel_profile_force_global(0)
        torch.cuda.synchronize()
        assert torch.equal(got, want[0])
        assert int(cnt_ok[0]) == int(want[1]) and bool(cnt_ok[1]) == bool(want[2])


@pytest.mark.parametrize("m,b", [(160, 32), (256, 64), (1000, 128), (40000, 256),
                                 (200000, 256)])
def test_lu_panel_kernel(cuda, m, b):
    """(40000, 256): the rows (40 MiB) exceed the card's shared memory, so
    the kernel keeps them in global memory. (200000, 256): the CTAs'
    working blocks exceed it too, so the grid route keeps those in global
    memory as well."""
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
    _check_lu_order(a, k1, p1, n1)


def _check_lu_order(a, k1, p1, n1):
    """The kernel's factor against its own order, ``lu_panel_blocked_plain``
    on the card: perm and nt equal, packed within 16·eps of max|packed|
    (the same operations in the same order, its fma emulated in f64)."""
    from faer_tpu_torch.ops.kernels.lu_panel import lu_panel_blocked_plain

    k3, p3, n3, _ = lu_panel_blocked_plain(a)
    assert torch.equal(p1, p3) and int(n1) == int(n3)
    assert _rel(k1, k3) <= 16 * EPS32


@pytest.mark.parametrize("edge", ["cluster 256", "cluster 64"])
@pytest.mark.parametrize("past", [0, 1])
def test_lu_panel_kernel_at_the_route_edges(cuda, edge, past):
    """Both sides of the LU panel kernel's cluster route edge, found from
    its own route: the largest m of the cluster route (b = 256 and 64) and
    one past it; held like ``test_lu_panel_kernel``."""
    from faer_tpu_torch.ops.kernels.lu_panel import (
        cluster_edge, lu_panel, lu_panel_plain, route_label)

    b = 64 if edge.endswith("64") else 256
    m = cluster_edge(b) + past
    label = route_label(m, b)
    assert label.startswith("grid" if past else "cluster")
    gen = torch.Generator(device=cuda).manual_seed(m + b)
    a, p = _separated_panel(m, b, gen, cuda)
    k1, p1, n1, o1 = lu_panel(a)
    k2, p2, n2, o2 = lu_panel_plain(a)
    print(f"lu_panel ({m}, {b}): {label}")
    assert torch.equal(p1, p2) and torch.equal(p1[:b], p[:b])
    assert int(n1) == int(n2) and bool(o1) and bool(o2)
    assert _rel(k1, k2) <= 8 * m * EPS32
    _check_lu_order(a, k1, p1, n1)


def test_lu_panel_routes(cuda):
    """The route is the C entry's alone: the main path's (4096, 256) leaves
    and the 16-panel CALU batch take the cluster route, the 40000- and
    65536-row panels the grid route, the 200000-row panel the grid route
    with its working blocks in global memory; a batch the grid route cannot
    hold one CTA an SM takes the cluster route past its edge where its
    shared memory holds it (16 × (12288, 256), sms + 1 panels past the
    cluster edge at b = 64). Past every route (more rows than 8192 a CTA
    over every CTA the card holds at once, 8 an SM at the most) the shape
    is refused, and so is its launch."""
    from faer_tpu_torch.core.errors import ShapeError
    from faer_tpu_torch.ops.kernels.lu_panel import cluster_edge, route, route_label
    from faer_tpu_torch.ops.kernels.lu_panel_v2 import lu_panel_v2_batched

    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for g, m in ((1, 4096), (16, 4096), (1, 4000), (1, 256), (16, 12288)):
        name, ctas, _ = route(m, 256, cuda, g)
        assert name == "cluster" and 1 <= ctas <= 16
    name, ctas, _ = route(cluster_edge(64) + 1, 64, cuda, sms + 1)
    assert name == "cluster" and 1 <= ctas <= 16
    for m in (40000, 65536, 200000):
        name, ctas, _ = route(m, 256, cuda)
        assert name == "grid" and 1 <= ctas <= 8 * sms
    assert route_label(200000, 256, cuda).endswith("working blocks in global memory")
    assert not route_label(65536, 256, cuda).endswith("working blocks in global memory")
    for g, m in ((1, 8192 * 8 * sms + 1), (8 * sms + 1, 30000)):
        with pytest.raises(ShapeError):
            route(m, 64, cuda, g)
        with pytest.raises(ShapeError):  # refused before any memory is touched
            lu_panel_v2_batched(torch.ones(1, m, 64, device=cuda).expand(g, m, 64))


def test_lu_panel_cluster_route_equals_the_grid_route(cuda):
    """The cluster route against the grid route forced onto the same shapes
    (the profile build of ``tools/torch_profile.py``), to the bit: every
    row's arithmetic is done in one order whichever route holds it."""
    import ctypes
    import sys

    sys.path.insert(0, os.path.join(REPO, "tools"))
    import torch_profile

    from faer_tpu_torch.ops.kernels.lu_panel import lu_panel, route

    lib = torch_profile.build("lu")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.faer_lu_panel_route.argtypes = [I, I, I, P, P]
    lib.faer_lu_panel_profile_force_grid.argtypes = [I]
    stream = torch.cuda.current_stream().cuda_stream
    for m, b in ((4096, 256), (2048, 256), (1000, 100), (300, 44)):
        gen = torch.Generator(device=cuda).manual_seed(m)
        a = torch.randn(m, b, generator=gen, device=cuda)
        assert route(m, b, cuda)[0] == "cluster"
        want = lu_panel(a)
        lib.faer_lu_panel_profile_force_grid(1)
        ctas, nscratch = ctypes.c_int(), ctypes.c_longlong()
        try:
            assert lib.faer_lu_panel_route(1, m, b, ctypes.byref(ctas),
                                           ctypes.byref(nscratch)) == 0
            got = (torch.empty(m, b, device=cuda), torch.empty(m, dtype=torch.long, device=cuda),
                   torch.empty(1, dtype=torch.int32, device=cuda),
                   torch.empty(1, dtype=torch.bool, device=cuda))
            scratch = torch.empty(nscratch.value, device=cuda)
            assert lib.faer_lu_panel_batched(
                a.data_ptr(), m * b, b, *(x.data_ptr() for x in got), scratch.data_ptr(),
                nscratch.value, 1, m, b, stream) == 0
        finally:
            lib.faer_lu_panel_profile_force_grid(0)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert int(got[2][0]) == int(want[2]) and bool(got[3][0]) == bool(want[3])


def _check_qr_panel(a, k1, t1, zero_col=None):
    """A packed panel factor of a Gaussian panel (m ≥ 4b, κ ≤ 3) against
    ``qr_panel_plain``, the kernel's one-pass order and ``torch.geqrf`` (the
    same larfg signs): R and the reflector tails V each within 8·m·eps
    relative to their own largest entry, τ within 8·m·eps; Q = I − V T Vᵀ
    orthogonal and Q·R = A to 8·m·eps. A panel with an all-zero column is
    held against the host's LAPACK geqrf: the card's returns τ ≈ 2 there
    for tall panels (another valid reflector, not larfg's τ = 0)."""
    from faer_tpu_torch.ops.householder import apply_block_on_left, form_block_t
    from faer_tpu_torch.ops.kernels.qr_panel import qr_panel_onepass_plain, qr_panel_plain

    m, b = a.shape
    tol = 8 * m * EPS32
    r1, v1 = torch.triu(k1[:b]), torch.tril(k1, -1)
    geqrf = torch.geqrf(a) if zero_col is None else tuple(
        x.to(a.device) for x in torch.geqrf(a.cpu()))
    for k, t in (qr_panel_plain(a), qr_panel_onepass_plain(a), geqrf):
        assert _rel(r1, torch.triu(k[:b])) <= tol
        assert _rel(v1, torch.tril(k, -1)) <= tol
        assert (t1 - t).abs().max().item() <= tol
    v = v1 + torch.eye(m, b, device=a.device)
    q = apply_block_on_left(v, form_block_t(v, t1), torch.eye(m, b, device=a.device),
                            adjoint=False)
    assert (q.T @ q - torch.eye(b, device=a.device)).abs().max().item() <= tol
    assert ((q @ r1 - a).norm() / a.norm()).item() <= tol
    if zero_col is not None:
        assert t1[zero_col].item() == 0.0
        assert bool((k1[zero_col:, zero_col] == 0).all())


# both sides of every route edge of csrc/qr_panel.cu: one CTA, a small
# cluster, the leaves of a 4096² QR (16 CTAs), the grid route with its rows
# in shared memory, and past it ((57000, 128), (60000, 128), (16384, 512));
# a zero column on each route, the grid's with its rows in shared memory
# (8192, 128) and in global memory (60000, 128)
QR_KERNEL_CASES = [(160, 32, None), (1000, 128, None), (200, 44, 5), (60000, 128, None),
                   (16384, 512, None), (128, 128, None), (3968, 128, None),
                   (4096, 128, None), (4096, 256, None), (8192, 128, None),
                   (57000, 128, None), (8192, 128, 5), (60000, 128, 100)]


@pytest.mark.parametrize("m,b,zero_col", QR_KERNEL_CASES)
def test_qr_panel_kernel(cuda, m, b, zero_col):
    """One launch of ``csrc/qr_panel.cu`` on its route (printed), held
    against the plain version, the kernel's one-pass order and geqrf."""
    from faer_tpu_torch.ops.kernels.qr_panel import qr_panel, route

    gen = torch.Generator(device=cuda).manual_seed(m + b)
    a = torch.randn(m, b, generator=gen, device=cuda)
    if zero_col is not None:
        a[:, zero_col] = 0.0
    reset_launch_counts()
    k1, t1 = qr_panel(a)
    torch.cuda.synchronize()
    assert launch_counts()["qr_panel"] == 1
    print(f"qr_panel ({m}, {b}): {route(m, b)}")
    _check_qr_panel(a, k1, t1, zero_col)


@pytest.mark.parametrize("past", [0, 1])
def test_qr_panel_kernel_at_the_cluster_edge(cuda, past):
    """The largest m of the cluster route at b = 128, and one past it (the
    grid route), each held like ``test_qr_panel_kernel``."""
    from faer_tpu_torch.ops.kernels.qr_panel import cluster_edge, qr_panel, route

    m = cluster_edge(128) + past
    assert route(m, 128)[0] == ("grid" if past else "cluster")
    a = torch.randn(m, 128, generator=torch.Generator(device=cuda).manual_seed(m),
                    device=cuda)
    k1, t1 = qr_panel(a)
    print(f"qr_panel ({m}, 128): {route(m, 128)}")
    _check_qr_panel(a, k1, t1)


def test_qr_panel_routes(cuda):
    """The route is the C entry's alone: a 4096² QR's leaves (m ≤ 4096,
    b = 128) take the cluster route with no global scratch, (4096, 256)
    and past the cluster edge the grid route, and b past 4096 is refused."""
    from faer_tpu_torch.core.errors import ShapeError
    from faer_tpu_torch.ops.kernels.qr_panel import cluster_edge, qr_panel, route

    for m in (128, 1000, 4096):
        name, ctas, scratch = route(m, 128)
        assert name == "cluster" and 1 <= ctas <= 16 and scratch == 0
    for m, b in ((4096, 256), (cluster_edge(128) + 1, 128), (65536, 128)):
        name, ctas, scratch = route(m, b)
        assert name == "grid" and 1 <= ctas <= torch.cuda.get_device_properties(
            cuda).multi_processor_count and scratch >= 2 * (ctas + 1) * b
    with pytest.raises(ShapeError):
        route(64, 4097)
    with pytest.raises(ShapeError):
        qr_panel(torch.zeros(64, 4097, device=cuda))


@pytest.mark.parametrize("b,reg", [(128, None), (80, None), (44, (1.0, 2.0))])
def test_llt_leaf_kernel(cuda, b, reg):
    """``reg``: eps > 0 with delta ≥ 1, so every pivot below 2 is counted.
    One launch of the blocked kernel and nothing else: no padding, no
    ``llt_panel``."""
    from faer_tpu_torch.ops.kernels.leaf import llt_leaf, llt_leaf_plain

    gen = torch.Generator(device=cuda).manual_seed(b)
    g = torch.randn(b, b, generator=gen, device=cuda)
    a = g @ g.T / b + torch.eye(b, device=cuda)
    eps, delta = reg or (0.0, 0.0)
    reset_launch_counts()
    l1, c1, o1 = llt_leaf(a, eps=eps, delta=delta)
    torch.cuda.synchronize()
    counts = launch_counts()
    assert counts["llt_leaf"] == 1 and counts["llt_panel"] == 0
    assert sum(counts.values()) == 1
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
    the same under any rounding (as in chip_smoke.py). A wide panel (m < b)
    has an (m, m) L and an (m, b) U."""
    k = min(m, b)
    lo = torch.tril((torch.rand(m, k, generator=gen, device=cuda) - 0.5) / b ** 0.5, -1)
    lo = lo + torch.eye(m, k, device=cuda)
    up = torch.triu(torch.randn(k, b, generator=gen, device=cuda), 1) / b ** 0.5
    up = up + torch.eye(k, b, device=cuda) * (
        1 + torch.rand(k, generator=gen, device=cuda))[:, None]
    p = torch.randperm(m, generator=gen, device=cuda)
    a = torch.empty(m, b, device=cuda)
    a[p] = lo @ up
    return a, p


def _lu_rec(a, packed, perm):
    """‖A[perm] − L·U‖ / ‖A‖ of a packed (m, b) panel factor (wide too)."""
    m, b = a.shape
    k = min(m, b)
    lo = torch.tril(packed[:, :k], -1) + torch.eye(m, k, device=a.device)
    return ((lo @ torch.triu(packed[:k]) - a[perm]).norm() / a.norm()).item()


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
    if name != "lu_panel_swap":
        _check_lu_order(a, k1, p1, n1)


# (m, b, route): the v1 kernel's measured shape and a ragged one on the
# cluster route, a wide panel on each route, (4096, 256) past the cluster's
# shared memory, and (40000, 256), whose rows (40 MiB) stay in global memory
LU_SWAP_SHAPES = [(4096, 128, "cluster"), (1000, 100, "cluster"), (64, 200, "cluster"),
                  (1000, 1024, "grid"), (4096, 256, "grid"),
                  (40000, 256, "grid, rows in global memory")]


@pytest.mark.parametrize("kind", ["separated", "gaussian"])
@pytest.mark.parametrize("m,b,want_route", LU_SWAP_SHAPES)
def test_lu_panel_swap_kernel_equals_the_plain_version(cuda, kind, m, b, want_route):
    """The kernel repeats the plain version's IEEE operations one by one
    (IEEE division for the multipliers, the product rounded before the
    subtraction) and its pivot search is exact, so packed, perm, nt and ok
    equal ``lu_panel_swap_plain``'s to the bit on every route, on separated
    pivots and on Gaussian panels alike. One launch; the route the one
    named."""
    from faer_tpu_torch.ops.kernels.lu_panel_swap import (
        lu_panel_swap, lu_panel_swap_plain, route)

    gen = torch.Generator(device=cuda).manual_seed(m * b + len(kind))
    a = (_separated_panel(m, b, gen, cuda)[0] if kind == "separated"
         else torch.randn(m, b, generator=gen, device=cuda))
    assert route(m, b, cuda)[0] == want_route
    reset_launch_counts()
    k1, p1, n1, o1 = lu_panel_swap(a)
    torch.cuda.synchronize()
    assert launch_counts()["lu_panel_swap"] == 1 and sum(launch_counts().values()) == 1
    k2, p2, n2, o2 = lu_panel_swap_plain(a)
    assert torch.equal(k1, k2) and torch.equal(p1, p2)
    assert int(n1) == int(n2) and bool(o1) == bool(o2)
    assert p1.dtype == p2.dtype and k1.shape == (m, b)


@pytest.mark.parametrize("g,m,b", [(16, 4096, 256), (5, 1000, 100), (3, 256, 256),
                                   (16, 12288, 256)])
def test_lu_panel_v2_batched_kernel(cuda, g, m, b):
    """One launch for the stack; each panel equals ``lu_panel_v2`` on it to
    the bit (the same kernel, whatever the CTAs per panel and the route:
    every row is updated by the same operations, and the pivot search is
    exact) and its plain version within 8·m·eps. 16 × (12288, 256) takes
    the cluster route past its edge (the grid route cannot hold the batch
    one CTA an SM), each panel alone the grid route."""
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
    """Clusters need no co-residency: 4000 panels of (64, 64) are one
    launch, each equal to ``lu_panel_v2`` on it. A batch of panels past the
    cluster route's shared memory needs every CTA of one cooperative grid
    co-resident; past that it is refused (ShapeError)."""
    from faer_tpu_torch.core.errors import ShapeError
    from faer_tpu_torch.ops.kernels.lu_panel_v2 import lu_panel_v2, lu_panel_v2_batched

    gen = torch.Generator(device=cuda).manual_seed(4000)
    stack = torch.randn(4000, 64, 64, generator=gen, device=cuda)
    got = lu_panel_v2_batched(stack)
    for q in (0, 1999, 3999):
        for x, y in zip(got, lu_panel_v2(stack[q])):
            assert torch.equal(x[q], y)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    g = 8 * sms + 1  # more panels than the card holds CTAs at once
    with pytest.raises(ShapeError):
        lu_panel_v2_batched(torch.ones(1, 30000, 64, device=cuda).expand(g, 30000, 64))


QR_FAMILY = ("qr_panel_v1", "qr_panel_v2", "qr_panel_v3", "qr_leaf")


def _qr_wrapper(name):
    """(wrapper, plain version) of a QR panel wrapper of the port."""
    import importlib

    mod = importlib.import_module("faer_tpu_torch.ops.kernels." + (
        "leaf" if name == "qr_leaf" else name))  # qr_panel too
    return getattr(mod, name), getattr(mod, f"{name}_plain")


def _qr_checks(a, packed, taus):
    """(max|QᵀQ − I|, ‖Q·R − A‖/‖A‖) of a packed panel factor, Q (m, m)."""
    m, b = a.shape
    k = min(m, b)
    v = torch.tril(packed[:, :k], -1) + torch.eye(m, k, device=a.device)
    q = torch.eye(m, device=a.device)
    for j in range(k - 1, -1, -1):  # Q = H_0 ⋯ H_{k−1}
        q -= taus[j] * torch.outer(v[:, j], v[:, j] @ q)
    orth = (q.T @ q - torch.eye(m, device=a.device)).abs().max().item()
    return orth, ((q @ torch.triu(packed) - a).norm() / a.norm()).item()


@pytest.mark.parametrize("name", QR_FAMILY)
@pytest.mark.parametrize("m,b,zero_col", [(4096, 128, None), (1000, 100, None),
                                           (200, 44, 5), (128, 128, None),
                                           (4096, 256, None), (8192, 128, None),
                                           (60000, 128, None), (8192, 128, 5),
                                           (60000, 128, 100)])
def test_qr_panel_family_kernels(cuda, name, m, b, zero_col):
    """v1, v2, v3 and the v4 leaf launch ``csrc/qr_panel.cu``, each behind
    its own counter, on both routes: equal to ``qr_panel`` to the bit, and
    within 8·m·eps of their plain versions, the kernel's one-pass order and
    geqrf (R and V each relative to their own largest entry; Gaussian panels
    with m ≥ 4b have κ ≤ 3)."""
    from faer_tpu_torch.ops.kernels.qr_panel import qr_panel

    kern, plain = _qr_wrapper(name)
    gen = torch.Generator(device=cuda).manual_seed(m + b)
    a = torch.randn(m, b, generator=gen, device=cuda)
    if zero_col is not None:
        a[:, zero_col] = 0.0
    reset_launch_counts()
    k1, t1 = kern(a)
    torch.cuda.synchronize()
    assert launch_counts()[name] == 1 and sum(launch_counts().values()) == 1
    k0, t0 = qr_panel(a)
    assert torch.equal(k1, k0) and torch.equal(t1, t0)
    k2, t2 = plain(a)
    tol = 8 * m * EPS32
    assert _rel(torch.triu(k1[:b]), torch.triu(k2[:b])) <= tol
    assert _rel(torch.tril(k1, -1), torch.tril(k2, -1)) <= tol
    assert (t1 - t2).abs().max().item() <= tol
    _check_qr_panel(a, k1, t1, zero_col)


LU_WRAPPERS = ("lu_panel", "lu_leaf", "lu_panel_v2", "lu_panel_v3", "lu_panel_swap",
               "lu_panel_v2_batched")


@pytest.mark.parametrize("name", LU_WRAPPERS + ("qr_panel",) + QR_FAMILY)
@pytest.mark.parametrize("m,b", [(16, 40), (64, 200), (1000, 1024)])
def test_wide_panels_on_card(cuda, name, m, b):
    """A wide panel (m < b) through every panel wrapper: min(m, b) steps in
    the kernel, the whole (m, b) panel back, against the plain version. LU:
    separated pivots, so perm, nt and ok exactly, packed within 8·b·eps of
    its largest entry, A[perm] = L·U to 8·b·eps. QR: I + G/(4√m) (κ ≤ 3),
    R and V within 8·b·eps of the plain version and of the QR kernel's
    one-pass order, taus (length m), QᵀQ = I and Q·R = A to 8·b·eps.
    (1000, 1024): the LU rows fit shared memory at 8 a CTA; the QR rows take
    the grid route, (16, 40) and (64, 200) the cluster route."""
    import importlib

    gen = torch.Generator(device=cuda).manual_seed(m + b)
    tol = 8 * b * EPS32
    if name.startswith("lu_"):
        base = {"lu_leaf": "leaf", "lu_panel_v2_batched": "lu_panel_v2"}.get(name, name)
        mod = importlib.import_module(f"faer_tpu_torch.ops.kernels.{base}")
        kern, plain = getattr(mod, name), getattr(mod, f"{name}_plain")
        batched = name == "lu_panel_v2_batched"
        stack = torch.stack([_separated_panel(m, b, gen, cuda)[0]
                             for _ in range(3 if batched else 1)])
        reset_launch_counts()
        got = kern(stack) if batched else tuple(x[None] for x in kern(stack[0]))
        torch.cuda.synchronize()
        counter = "lu_panel_v2" if batched else name
        assert launch_counts()[counter] == 1 and sum(launch_counts().values()) == 1
        want = plain(stack) if batched else tuple(x[None] for x in plain(stack[0]))
        for q, a in enumerate(stack):
            k1, p1, n1, o1 = (x[q] for x in got)
            k2, p2, n2, o2 = (x[q] for x in want)
            assert k1.shape == (m, b) and p1.shape == (m,)
            assert torch.equal(p1, p2) and int(n1) == int(n2) and bool(o1) and bool(o2)
            assert _rel(k1, k2) <= tol and _lu_rec(a, k1, p1) <= tol
        return
    from faer_tpu_torch.ops.kernels.qr_panel import qr_panel_onepass_plain, route

    kern, plain = _qr_wrapper(name)
    a = torch.randn(m, b, generator=gen, device=cuda) / (4 * m ** 0.5)
    a += torch.eye(m, b, device=cuda)
    reset_launch_counts()
    k1, t1 = kern(a)
    torch.cuda.synchronize()
    assert launch_counts()[name] == 1 and sum(launch_counts().values()) == 1
    print(f"{name} ({m}, {b}): {route(m, b)}")
    assert k1.shape == (m, b) and t1.shape == (m,)
    for k2, t2 in (plain(a), qr_panel_onepass_plain(a)):
        assert _rel(torch.triu(k1), torch.triu(k2)) <= tol
        assert _rel(torch.tril(k1, -1), torch.tril(k2, -1)) <= tol
        assert (t1 - t2).abs().max().item() <= tol
    orth, rec = _qr_checks(a, k1, t1)
    assert orth <= tol and rec <= tol


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
    from faer_tpu_torch.ops.kernels.sweep import _shift, _wilkinson_shift

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


@pytest.mark.parametrize("seed", [0, 7])
def test_self_adjoint_evd_repeated_eigenvalues_on_card(cuda, seed):
    """A = Q·diag(+1 ×256, −1 ×256)·Qᵀ at n = 512, the D&C route: its merges
    deflate many close pairs whose tear components are near 1e-20, where the
    f32 squares are subnormal (kept by PyTorch's CUDA kernels too). The
    deflation rotations stay rotations: max|VᵀV − I| and ‖AV − VΛ‖/‖A‖
    within 8·n·eps, the eigenvalues within 8·n·eps of f64 ``eigvalsh``."""
    from faer_tpu_torch.linalg.evd import self_adjoint_evd

    n = 512
    torch.manual_seed(seed)
    q, _ = torch.linalg.qr(torch.randn(n, n, dtype=torch.float64))
    sign = torch.cat([torch.ones(n // 2, dtype=torch.float64),
                      -torch.ones(n // 2, dtype=torch.float64)])
    a = ((q * sign) @ q.T).float().to(cuda)
    w, v, _ = self_adjoint_evd(a)
    torch.cuda.synchronize()
    tol = 8 * n * EPS32
    v64, w64, a64 = v.double(), w.double(), a.double()
    orth = (v64.T @ v64 - torch.eye(n, dtype=torch.float64, device=cuda)).abs().max().item()
    res = (torch.linalg.matrix_norm(a64 @ v64 - v64 * w64)
           / torch.linalg.matrix_norm(a64)).item()
    oracle = torch.linalg.eigvalsh(a64)
    assert orth <= tol and res <= tol
    assert (w64 - oracle).abs().max().item() <= tol * oracle.abs().max().item()


def test_spectral_on_card(cuda):
    """The EVD and the SVD on the card through their batched QR kernels:
    the D&C route (n = 600, leaves of 75 and less) and the direct QR route
    (n = 100), one launch and no host read a call."""
    from faer_tpu_torch import self_adjoint_evd, svd
    from faer_tpu_torch.core.config import host_reads

    gen = torch.Generator(device=cuda).manual_seed(11)
    for n in (600, 100):
        g = torch.randn(n, n, generator=gen, device=cuda)
        a = (g + g.T) / 2
        tol = 8 * n * EPS32
        eye = torch.eye(n, device=cuda)
        reset_launch_counts()
        w, v, info = self_adjoint_evd(a)
        torch.cuda.synchronize()
        assert launch_counts()["tridiag_sweep"] == 1 and host_reads() == 0
        assert bool(info.converged)
        assert ((a @ v - v * w).norm() / a.norm()).item() <= tol
        assert (v.T @ v - eye).abs().max().item() <= tol
        w64 = torch.linalg.eigvalsh(a.double())
        assert ((w.double() - w64).abs().max() / w64.abs().max()).item() <= tol
        reset_launch_counts()
        u, s, vs, info = svd(g)
        torch.cuda.synchronize()
        assert launch_counts()["bidiag_sweep"] == 1 and host_reads() == 0
        assert bool(info.converged)
        assert (((u * s) @ vs.T - g).norm() / g.norm()).item() <= tol
        assert (u.T @ u - eye).abs().max().item() <= tol
        assert (vs.T @ vs - eye).abs().max().item() <= tol
        s64 = torch.linalg.svdvals(g.double())
        assert ((s.double() - s64).abs().max() / s64[0]).item() <= tol


def _qr_batch(sizes, sqre, cuda, seed, zero=()):
    """Random problems of ``sizes`` packed as the batched kernels take them
    (d (B, nmax), e (B, nmax)); ``zero``: (problem, index) diagonals set to 0."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    nmax = max(sizes)
    d = torch.randn(len(sizes), nmax, generator=gen, device=cuda)
    e = torch.randn(len(sizes), nmax, generator=gen, device=cuda)
    for b, i in zero:
        d[b, i] = 0.0
    return (d, e, torch.tensor(sizes, dtype=torch.int32, device=cuda),
            torch.tensor(sqre, dtype=torch.int32, device=cuda))


QR_BATCHED_CASES = {
    # name: (sizes, sqre, max_sweeps_factor, zero diagonals)
    "ragged": ([64, 63, 2, 1, 17, 40], [1, 0, 1, 0, 0, 1], 30, ()),
    "max_iters": ([40, 64], [0, 1], 1, ()),
    "zero diagonal": ([64, 64, 30], [0, 1, 0], 30, ((0, 5), (1, 63), (2, 29))),
    "global memory": ([300], [0], 30, ()),
}


@pytest.mark.parametrize("case", sorted(QR_BATCHED_CASES))
@pytest.mark.parametrize("kind", ["tridiag", "bidiag"])
def test_qr_batched_kernel(cuda, kind, case):
    """Against the plain version on the card, which runs the same IEEE
    operations in the same order: d, e, iterations, converged and sweep
    steps equal to the bit; the vectors (rotated row by row in the kernel,
    by chunk GEMMs in the plain version) within 8·n·eps; the identity past
    each problem. One launch under the sweep's counter."""
    from faer_tpu_torch.ops.kernels import sweep

    sizes, sqre, factor, zero = QR_BATCHED_CASES[case]
    d, e, sz, sq = _qr_batch(sizes, sqre, cuda, len(case), zero)
    nmax = d.shape[1]
    if kind == "tridiag":
        e = e[:, :nmax - 1].contiguous()
        args = (sz,)
        kern, plain, counter = sweep.tridiag_qr_batched, sweep.tridiag_qr_batched_plain, \
            "tridiag_sweep"
    else:
        args = (sz, sq)
        kern, plain, counter = sweep.bidiag_qr_batched, sweep.bidiag_qr_batched_plain, \
            "bidiag_sweep"
    d1, e1, d2, e2 = d.clone(), e.clone(), d.clone(), e.clone()
    reset_launch_counts()
    got = kern(d1, e1, *args, max_sweeps_factor=factor)
    torch.cuda.synchronize()
    assert launch_counts()[counter] == 1
    want = plain(d2, e2, *args, max_sweeps_factor=factor)
    assert torch.equal(d1, d2) and torch.equal(e1, e2)
    for g, w in zip(got[-3:], want[-3:]):  # iterations, converged, steps
        assert torch.equal(g, w), (g, w)
    assert bool(got[-2].all()) == (factor >= 30)
    for g, w in zip(got[:-3], want[:-3]):  # Z; or U and W
        assert (g - w).abs().max().item() <= 8 * nmax * EPS32
        for b, n in enumerate(sizes):
            k = n + (sqre[b] if g.shape[1] > nmax else 0)
            eye = torch.eye(g.shape[1] - k, device=cuda)
            assert torch.equal(g[b, k:, k:], eye)
            assert not g[b, k:, :k].any() and not g[b, :k, k:].any()


def test_leaf_stage_reads_nothing_on_the_host(cuda):
    """``self_adjoint_evd`` 1024's leaf stage (every D&C leaf formed and
    solved in one launch, then sorted) under torch's sync debug mode
    "error": no operation in it synchronizes with the host."""
    from faer_tpu_torch.linalg import bidiag_dnc, tridiag_dnc
    from faer_tpu_torch.linalg.bidiag import bidiag_in_place
    from faer_tpu_torch.linalg.tridiag import tridiag_in_place

    gen = torch.Generator(device=cuda).manual_seed(12)
    g = torch.randn(1024, 1024, generator=gen, device=cuda)
    d, e, _, _ = tridiag_in_place((g + g.T) / 2)
    bd, be = bidiag_in_place(g)[:2]
    torch.cuda.synchronize()
    reset_launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        w, z, info, leaves = tridiag_dnc._leaf_stage(d, e)
        u, s, wv, binfo, bleaves = bidiag_dnc._leaf_stage(bd, be, 0)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert launch_counts()["tridiag_sweep"] == launch_counts()["bidiag_sweep"] == 1
    assert len(leaves) == 16 and bool(info.converged) and bool(binfo.converged)
    assert bool((w[:, 1:] >= w[:, :-1]).all()) and bool((s[:, 1:] <= s[:, :-1]).all())


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


def _tile_operand(rows, cols, transposed, offset, gen, cuda, dtype=torch.float32):
    """A (rows, cols) operand: row-major, or the ``.mT`` view of a row-major
    (cols, rows) array (``transposed``); ``offset`` 1 starts the view one
    element past an aligned base, so neither TMA nor a 16-byte copy takes it."""
    shape = (cols, rows) if transposed else (rows, cols)
    flat = torch.randn(rows * cols + offset, generator=gen, device=cuda).to(dtype)
    x = flat[offset:].view(shape)
    return x.mT if transposed else x


# (m, k, n): small and ragged; k = 1; long k over one CTA a tile (enough
# tiles that no plan splits k) and split; the split-k shapes of a QR block
# apply's Vᵀ·B (narrowed) and of an 8-column right-hand side
TILE_SHAPES = [(256, 128, 256), (300, 200, 260), (1, 33, 7), (129, 1, 130),
               (2048, 16384, 2048), (256, 16384, 256), (128, 4096, 520), (128, 4096, 8)]


@pytest.mark.parametrize("precision", ["highest", "high"])
@pytest.mark.parametrize("layout", ["nn", "tn", "nt", "tt"])
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("m,k,n", TILE_SHAPES)
def test_tile_matmul_kernel(cuda, monkeypatch, precision, layout, offset, m, k, n):
    """f32 in both modes, every layout, aligned and offset views, ragged
    edges, long k and split k: against the plain version and f64 within
    16·eps of max‖a_i‖·max‖b_j‖ ("highest") or within 2e-5 ("high",
    bf16x3). One launch count a call; the plan splits k where the output
    tiles leave the card idle."""
    from faer_tpu_torch.core.config import config
    from faer_tpu_torch.ops.kernels.matmul import (plan_tile_matmul, tile_matmul,
                                                    tile_matmul_plain)

    monkeypatch.setattr(config, "f32_precision", precision)
    gen = torch.Generator(device=cuda).manual_seed(m * 7 + k * 3 + n)
    a = _tile_operand(m, k, layout[0] == "t", offset, gen, cuda)
    b = _tile_operand(k, n, layout[1] == "t", offset, gen, cuda)
    plan = plan_tile_matmul(m, n, k, a.dtype, precision, a.stride(), b.stride(),
                            a.data_ptr(), b.data_ptr(),
                            torch.cuda.get_device_properties(cuda).multi_processor_count)
    assert (plan.split > 1) == (k >= 4096 and m * n < 2048 * 2048)
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
@pytest.mark.parametrize("layout", ["nn", "tn", "nt", "tt"])
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("m,k,n", [(256, 128, 256), (300, 200, 260), (2048, 16384, 2048),
                                   (256, 16384, 256), (128, 4096, 520), (128, 4096, 8)])
def test_tile_matmul_kernel_bf16(cuda, out, layout, offset, m, k, n):
    """bf16 operands, one pass, f32 sums, every layout, aligned (TMA) and
    offset (packed) views, long k and split k: against the plain version
    within 16·eps of max‖a_i‖·max‖b_j‖, past one bf16 rounding of each
    entry for a bf16 result."""
    from faer_tpu_torch.ops.kernels.matmul import (plan_tile_matmul, tile_matmul,
                                                    tile_matmul_plain)

    gen = torch.Generator(device=cuda).manual_seed(m + n)
    a = _tile_operand(m, k, layout[0] == "t", offset, gen, cuda, torch.bfloat16)
    b = _tile_operand(k, n, layout[1] == "t", offset, gen, cuda, torch.bfloat16)
    plan = plan_tile_matmul(m, n, k, a.dtype, "highest", a.stride(), b.stride(),
                            a.data_ptr(), b.data_ptr())
    if offset:  # a base 2 bytes off 16: TMA cannot take it
        assert plan.a == plan.b == "pack"
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


@pytest.mark.parametrize("precision", ["highest", "high"])
@pytest.mark.parametrize("case", ["main (3840, 256)", "k 257 contiguous", "k 257 of 260",
                                  "offset", "c row stride", "m 1"])
def test_syrk_lower_sub_kernel_reads(cuda, monkeypatch, precision, case):
    """The FP32 kernel's reads of A and one pass over C: the main path's
    K-major (3840, 256) (16-byte copies along k), a k that is not a multiple
    of 4 (rows not 16-byte aligned: 4-byte copies; or a (m, 260) array's
    first 257 columns: 16-byte copies, the last chunk partial), a view one
    element past an aligned base, a C read in place through a row stride,
    and m = 1. The lower triangle within 16·eps ("highest") or 2e-5
    ("high") of max‖a_i‖² of the plain version (bf16x3 also of f64), the
    upper triangle C's values bit for bit, one launch."""
    from faer_tpu_torch.core.config import config
    from faer_tpu_torch.ops.kernels.syrk import syrk_lower_sub, syrk_lower_sub_plain, syrk_read

    monkeypatch.setattr(config, "f32_precision", precision)
    gen = torch.Generator(device=cuda).manual_seed(len(case))
    m, k = {"main (3840, 256)": (3840, 256), "c row stride": (300, 256),
            "m 1": (1, 5)}.get(case, (300, 257))
    c = torch.randn(m, m, generator=gen, device=cuda)
    a = torch.randn(m, k, generator=gen, device=cuda)
    want_read = "cp16_k"
    if case == "k 257 contiguous":
        want_read = "cp4_k"
    elif case == "k 257 of 260":
        a = torch.randn(m, 260, generator=gen, device=cuda)[:, :k]
    elif case == "offset":
        flat = torch.randn(m * k + 1, generator=gen, device=cuda)
        a, want_read = flat[1:].view(m, k), "cp4_k"
    elif case == "c row stride":
        c = torch.randn(m, m + 6, generator=gen, device=cuda)[:, :m]
    elif case == "m 1":
        want_read = "cp4_k"
    assert syrk_read(a) == want_read
    reset_launch_counts()
    got = syrk_lower_sub(c, a)
    torch.cuda.synchronize()
    assert launch_counts()["syrk"] == 1 and sum(launch_counts().values()) == 1
    want = syrk_lower_sub_plain(c, a)
    scale = a.norm(dim=1).max().item() ** 2
    tol = BF16X3_TOL if precision == "high" else F32_TOL
    assert torch.tril(got - want).abs().max().item() <= tol * scale
    if precision == "high":
        ref = c.double() - a.double() @ a.double().mT
        assert torch.tril(got.double() - ref).abs().max().item() <= tol * scale
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


def test_self_adjoint_eigen_solve_of_a_vector_on_card(cuda):
    """``Mat(a).self_adjoint_eigen().solve(b)`` with an (n,) or ``Col``
    right-hand side returns (n,), within 8·n·eps of the (n, 1) solve's
    column and with a residual within 8·n·eps."""
    from faer_tpu_torch import Col, Mat

    n = 256
    gen = torch.Generator(device=cuda).manual_seed(8)
    g = torch.randn(n, n, generator=gen, device=cuda)
    a = (g + g.T) / 2
    b = torch.randn(n, generator=gen, device=cuda)
    eig = Mat(a).self_adjoint_eigen()
    x2 = eig.solve(b[:, None])
    tol = 8 * n * EPS32
    for rhs in (b, Col(b)):
        x = eig.solve(rhs)
        assert x.shape == (n,)
        assert ((x - x2[:, 0]).abs().max() / x2.abs().max()).item() <= tol
        assert ((a @ x - b).norm() / (a.norm() * x.norm())).item() <= tol


def _mirrored_spd(b, gen, device):
    """g gᵀ/b + 2I from its lower triangle: symmetric in full storage."""
    g = torch.randn(b, b, generator=gen, device=device)
    lo = torch.tril(g @ g.T / b + 2 * torch.eye(b, device=device))
    return lo + torch.tril(lo, -1).mT


LLT_BLOCK_KERNELS = ("llt_leaf", "llt_block", "llt_block_v3")


def _llt_block_kernel(name):
    """(wrapper, its plain version) of one of the three wrappers of
    ``csrc/llt_block.cu``."""
    from faer_tpu_torch.ops.kernels import leaf
    from faer_tpu_torch.ops.kernels import llt_block as mod

    owner = leaf if name == "llt_leaf" else mod
    return getattr(owner, name), getattr(owner, f"{name}_plain")


def test_llt_block_routes_follow_the_shared_memory_edge(cuda):
    """The kernel's C entry keeps the aligned packed lower triangle and its
    static arrays in a CTA's 227 KiB up to b = 337 and takes L2 from 338
    to 1024; ``route`` asks it."""
    from faer_tpu_torch.core.errors import ShapeError
    from faer_tpu_torch.ops.kernels.llt_block import route

    assert [route(b) for b in (1, 128, 256, 337)] == ["shared"] * 4
    assert [route(b) for b in (338, 512, 1024)] == ["L2"] * 3
    with pytest.raises(ShapeError):
        route(1025)


# the shared-memory route ends at b = 337; 338 takes the L2 route. pad > 0:
# a (b, b) view of a (b + pad, b + pad) block, row stride b + pad, as the
# recursive driver hands its leaves over
@pytest.mark.parametrize("name", LLT_BLOCK_KERNELS)
@pytest.mark.parametrize("b,pad", [(1, 0), (7, 0), (31, 0), (33, 0), (128, 0),
                                   (200, 0), (256, 0), (337, 0), (338, 0),
                                   (512, 0), (1024, 0), (125, 3), (338, 3)])
def test_llt_block_kernels(cuda, name, b, pad):
    """One CTA per block, in shared memory up to b = 337 and in L2 above:
    L within 8·b·eps of the wrapper's plain version and of an f64 factor,
    and within b·eps of the kernel's own order
    (``llt_block_blocked_plain``: the same operations, FMAs rounded once);
    the bits of a launch on a contiguous copy; (count, ok) = (0, True),
    zeros above the diagonal, one launch."""
    from faer_tpu_torch.ops.kernels.llt_block import llt_block_blocked_plain

    kern, plain = _llt_block_kernel(name)
    big = _mirrored_spd(b + pad, torch.Generator(device=cuda).manual_seed(b), cuda)
    a = big[:b, :b]
    reset_launch_counts()
    l1, c1, o1 = kern(a)
    torch.cuda.synchronize()
    assert launch_counts()[name] == 1 and sum(launch_counts().values()) == 1
    assert torch.equal(l1, kern(a.contiguous())[0])
    l2, c2, o2 = plain(a)
    assert (int(c1), bool(o1)) == (int(c2), bool(o2)) == (0, True)
    assert bool((torch.triu(l1, 1) == 0).all())
    tol = 8 * b * EPS32
    assert _rel(l1, l2) <= tol
    assert _rel(l1.double(), torch.linalg.cholesky(a.double())) <= tol
    l3, c3, o3 = llt_block_blocked_plain(a)
    assert (int(c3), bool(o3)) == (0, True)
    assert _rel(l1, l3) <= b * EPS32


@pytest.mark.parametrize("name", LLT_BLOCK_KERNELS)
@pytest.mark.parametrize("b,reg,want", [(128, (1.0, 1.0), (3, False)),
                                        (40, (0.0, 0.0), (0, False)),
                                        (512, (1.0, 1.0), (3, False))])
def test_llt_block_kernels_regularized(cuda, name, b, reg, want):
    """L Lᵀ with three zero diagonal entries of L, less 1e-3 there: with
    eps = delta = 1 the three pivots are replaced and counted; with eps = 0
    the first (negative) pivot becomes 1. ok is False either way."""
    from faer_tpu_torch.ops.kernels.llt_block import llt_block_blocked_plain

    kern, plain = _llt_block_kernel(name)
    gen = torch.Generator(device=cuda).manual_seed(b + 1)
    bad = [3, 20, b - 3]
    lo = torch.tril(torch.randn(b, b, generator=gen, device=cuda) / b ** 0.5, -1)
    diag = 1.5 + torch.rand(b, generator=gen, device=cuda)
    diag[bad] = 0.0
    lo = lo + torch.diag(diag)
    a = torch.tril(lo @ lo.T)
    a = a + torch.tril(a, -1).mT
    a[bad, bad] -= 1e-3
    eps, delta = reg
    l1, c1, o1 = kern(a, eps=eps, delta=delta)
    l2, c2, o2 = plain(a, eps=eps, delta=delta)
    l3, c3, o3 = llt_block_blocked_plain(a, eps=eps, delta=delta)
    torch.cuda.synchronize()
    assert (int(c1), bool(o1)) == (int(c2), bool(o2)) == (int(c3), bool(o3)) == want
    assert bool(torch.isfinite(l1).all()) and _rel(l1, l2) <= 8 * b * EPS32
    assert _rel(l1, l3) <= b * EPS32


@pytest.mark.parametrize("name", ["llt_block", "llt_block_v3"])
def test_llt_block_plugged_into_a_4096_factor(cuda, name):
    """``tools/torch_llt_blocks.py``'s factor with the kernel at every leaf
    (leaf width 128, block 256): 32 leaf launches, ‖LLᵀ − A‖/‖A‖ ≤ 8·n·eps."""
    import runpy

    from faer_tpu_torch.ops.kernels import llt_block as mod

    lab = runpy.run_path(os.path.join(REPO, "tools", "torch_llt_blocks.py"))
    n = 4096
    a = lab["spd"](n, torch.Generator(device=cuda).manual_seed(12), cuda)
    kern = getattr(mod, name)
    reset_launch_counts()
    l = lab["llt_factor_variant"](a, block=256, leaf=128, leaf_fn=lambda x: kern(x)[0])
    torch.cuda.synchronize()
    leaves, trtri = lab["variant_calls"](n, 256, 128)
    assert launch_counts()[name] == leaves == 32
    assert launch_counts()["trtri"] == trtri
    assert lab["llt_residual"](l, a) <= 8 * n * EPS32


def _chase_b(b, cuda):
    """b, or the largest b whose strip a cluster holds in shared memory on
    this card ("edge") and the next ("edge+1")."""
    from faer_tpu_torch.ops.kernels.band_chase import device_facts, shared_edge

    edge = shared_edge(*device_facts(cuda))
    return {"edge": edge, "edge+1": edge + 1}.get(b, b)


@pytest.mark.parametrize("b,g,steps", [(16, 2, 6), (64, 1, 3), (64, 4, 24),
                                       (84, 1, 24), (85, 2, 24), (128, 8, 24),
                                       (64, 1, 0), (17, 3, 12), (128, 1, 24),
                                       (128, 40, 6), (128, 2, 0), (200, 1, 12),
                                       ("edge", 1, 12), ("edge+1", 1, 12),
                                       ("edge+1", 2, 0), (1024, 1, 4)])
def test_chase_kernel(cuda, b, g, steps):
    """One thread-block cluster a strip, the strip's columns over its CTAs:
    in their shared memory up to the edge, in a global copy past it (the
    planner's route asserted); g = 40 at b = 128 is 320 CTAs, more than one
    wave; within 8·2b·eps of the plain version, relative to the output's
    largest entry; one launch a call."""
    from faer_tpu_torch.ops.kernels.band_chase import (
        chase_probe, chase_probe_plain, device_facts, route, shared_edge)

    b = _chase_b(b, cuda)
    p = route(b, g, cuda)
    want_route = ("cluster, strip in shared memory" if b <= shared_edge(*device_facts(cuda))
                  else "cluster, strip in global memory")
    assert p.route == want_route and 1 <= p.ctas <= device_facts(cuda)[1]
    gen = torch.Generator(device=cuda).manual_seed(b * g + steps)
    band = torch.randn(g * 4 * b, 2 * b, generator=gen, device=cuda)
    reset_launch_counts()
    got = chase_probe(band, b=b, steps=steps, g=g)
    torch.cuda.synchronize()
    assert launch_counts()["chase_probe"] == 1
    want = chase_probe_plain(band, b=b, steps=steps, g=g)
    assert bool(torch.isfinite(got).all())
    assert (got - want).abs().max().item() <= 8 * 2 * b * EPS32 * want.abs().max().item()
    if steps == 0:
        assert torch.equal(got, band)


def test_chase_plans_match_the_kernel(cuda):
    """The planner's shared memory equals the kernel's own count
    (``faer_chase_smem_bytes``) on both routes at every b, and every b up
    to ``MAX_B`` has a plan on this card."""
    from faer_tpu_torch.ops.kernels import _build
    from faer_tpu_torch.ops.kernels.band_chase import MAX_B, route, smem_bytes

    lib = _build.library()
    for b in range(1, MAX_B + 1):
        p = route(b, 1, cuda)
        for shared in (True, False):
            assert lib.faer_chase_smem_bytes(b, p.cw, int(shared)) == smem_bytes(b, p.cw, shared)


@pytest.mark.parametrize("b", [16, 64, 128, "edge", "edge+1"])
def test_chase_kernel_zero_tail_is_the_identity(cuda, b):
    """α = 0.75 and rows 2..b of column 0 zero in every strip's first
    window: tail_sq = 0, τ = 0, one step leaves the strip unchanged, on
    both routes and on a one-CTA cluster (b = 16)."""
    from faer_tpu_torch.ops.kernels.band_chase import chase_probe

    b = _chase_b(b, cuda)
    g = 2
    band = torch.randn(g * 4 * b, 2 * b, generator=torch.Generator(device=cuda).manual_seed(1),
                       device=cuda)
    for gi in range(g):
        band[gi * 4 * b + 1, 0] = 0.75
        band[gi * 4 * b + 2:gi * 4 * b + b + 1, 0] = 0.0
    assert torch.equal(chase_probe(band, b=b, steps=1, g=g), band)


def test_new_wrappers_raise_past_their_limits(cuda):
    from faer_tpu_torch.core.errors import ShapeError
    from faer_tpu_torch.ops.kernels.band_chase import chase_probe

    for kern in (_llt_block_kernel(name)[0] for name in LLT_BLOCK_KERNELS):
        with pytest.raises(ShapeError):
            kern(torch.eye(1025, device=cuda))
        with pytest.raises(ValueError):  # rows not contiguous
            kern(torch.eye(64, device=cuda).mT.contiguous().mT)
    with pytest.raises(ShapeError):
        chase_probe(torch.zeros(4 * 1025, 2 * 1025, device=cuda), b=1025, steps=1)
    with pytest.raises(ShapeError):
        chase_probe(torch.zeros(256, 128, device=cuda), b=64, steps=1, g=2)


# -- the float64 route and the dense stack on the card -------------------------------

def _dense_calls(n, dt, cuda, gen):
    """Every new factorization at n on the card: (name, call) pairs."""
    from faer_tpu_torch.linalg import cholesky as C
    from faer_tpu_torch.linalg import lu as L
    from faer_tpu_torch.linalg import qr as Q

    g = torch.randn(n, n, generator=gen, device=cuda, dtype=dt)
    spd = g @ g.T / n + torch.eye(n, device=cuda, dtype=dt)
    w = torch.randn(n, 3, generator=gen, device=cuda, dtype=dt) / n ** 0.5
    l, ld = C.llt_factor(spd)[0], C.ldlt_factor(spd)[0]
    return {"llt": lambda: C.llt_factor(spd), "ldlt": lambda: C.ldlt_factor(spd),
            "piv_llt": lambda: C.piv_llt_factor(spd),
            "lblt": lambda: C.lblt_factor((g + g.T) / 2),
            "llt_rank_r_update": lambda: C.llt_rank_r_update(l, w, -1.0),
            "ldlt_rank_r_update": lambda: C.ldlt_rank_r_update(ld, w, 1.0),
            "lu_in_place": lambda: L.lu_in_place(g),
            "full_piv_lu_in_place": lambda: L.full_piv_lu_in_place(g),
            "qr_in_place": lambda: Q.qr_in_place(g),
            "col_piv_qr_in_place": lambda: Q.col_piv_qr_in_place(g)}


@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
def test_dense_stack_syncs_only_where_it_reads(cuda, dt):
    """Pivots, ranks and counts stay on the card: torch's sync debug mode
    sees a synchronizing call only where the driver makes a counted host
    read (Bunch–Kaufman's one a panel). A float64 call launches no kernel."""
    import warnings

    from faer_tpu_torch.core.config import host_reads

    for name, fn in _dense_calls(200, dt, cuda, torch.Generator(device=cuda).manual_seed(3)).items():
        fn()
        torch.cuda.synchronize()
        reset_launch_counts()
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                fn()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        syncs = sum("called a synchronizing CUDA operation" in str(r.message) for r in rec)
        assert syncs == host_reads(), (name, syncs, host_reads())
        if dt == torch.float64:
            assert not any(launch_counts().values()), (name, launch_counts())
        elif name in ("ldlt", "llt", "lu_in_place", "qr_in_place"):
            assert any(launch_counts().values()), name


@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
def test_dense_stack_objects_on_card(cuda, dt):
    """The solver objects at n = 300 on the card, held to f64 references:
    reconstructions and residuals within 8·n·eps of the dtype."""
    import faer_tpu_torch as ft

    n = 300
    eps = torch.finfo(dt).eps
    tol = 8 * n * eps
    gen = torch.Generator(device=cuda).manual_seed(5)
    g = torch.randn(n, n, generator=gen, device=cuda, dtype=torch.float64)
    spd = g @ g.T / n + torch.eye(n, device=cuda, dtype=torch.float64)
    sym = (g + g.T) / 2
    b = torch.randn(n, 4, generator=gen, device=cuda, dtype=torch.float64)

    def rel(x, y):
        return ((x.double() - y).norm() / y.norm()).item()

    def res(a, x):
        x = x.double()
        return ((a @ x - b).norm() / (a.norm() * x.norm())).item()

    objs = {"ldlt": (ft.Mat(spd.to(dt)).ldlt(), spd), "piv_llt": (ft.Mat(spd.to(dt)).piv_llt(), spd),
            "lblt": (ft.Mat(sym.to(dt)).lblt(), sym), "full_piv_lu": (ft.Mat(g.to(dt)).full_piv_lu(), g),
            "col_piv_qr": (ft.Mat(g.to(dt)).col_piv_qr(), g), "llt": (ft.Mat(spd.to(dt)).llt(), spd),
            "partial_piv_lu": (ft.Mat(g.to(dt)).partial_piv_lu(), g), "qr": (ft.Mat(g.to(dt)).qr(), g)}
    for name, (obj, a) in objs.items():
        assert obj.reconstruct().device.type == "cuda"
        assert rel(obj.reconstruct(), a) <= tol, name
        solve = obj.solve_lstsq if name == "qr" else obj.solve
        assert res(a, solve(b.to(dt))) <= tol, name
    w = torch.randn(n, 2, generator=gen, device=cuda, dtype=torch.float64) / n ** 0.5
    upd = spd + w @ w.T
    assert rel(objs["llt"][0].rank_update(w.to(dt), 1.0).reconstruct(), upd) <= tol
    assert rel(objs["ldlt"][0].rank_update(w.to(dt), 1.0).reconstruct(), upd) <= tol
    sign = torch.linalg.slogdet(g)[0].item()
    assert torch.sign(objs["full_piv_lu"][0].determinant()).item() == sign
    assert torch.sign(objs["partial_piv_lu"][0].determinant()).item() == sign


# -- the real Schur kernel and the f64 spectral kernels -----------------------

def _hess_batch(n, batch, seed, dtype):
    gen = torch.Generator().manual_seed(seed)
    return torch.triu(torch.randn(batch, n, n, generator=gen, dtype=torch.float64), -1).to(dtype)


def _schur_pair(h, cuda):
    """The kernel on the card and its plain version on the CPU copies (IEEE
    operations only, so the two devices round alike): T, Q, iterations and
    converged of each."""
    from faer_tpu_torch.ops.kernels import real_schur as krs

    batch, n, _ = h.shape
    q = torch.eye(n, dtype=h.dtype).repeat(batch, 1, 1)
    sizes = torch.full((batch,), n, dtype=torch.int32)
    reset_launch_counts()
    got = krs.real_schur_batched(h.to(cuda), q.to(cuda), sizes.to(cuda))
    torch.cuda.synchronize()
    assert launch_counts()["real_schur"] == 1
    want = krs.real_schur_batched_plain(h, q, sizes)
    return [g.cpu() for g in got], want


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,batch", [(2, 3), (3, 3), (16, 4), (48, 2), (96, 1)])
def test_real_schur_kernel_equals_its_plain_version(cuda, n, batch, dtype):
    """T, Q, the iteration counts, the convergence flags and the chase steps
    equal to the bit, every problem converged."""
    got, want = _schur_pair(_hess_batch(n, batch, n, dtype), cuda)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert bool(got[3].all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("past", [0, 1])
def test_real_schur_kernel_at_its_shared_memory_edge(cuda, dtype, past):
    """The largest nmax whose H and Q the kernel keeps in shared memory
    (169 in float32, 119 in float64 on an H100) and the next, in global
    memory: equal to the plain version to the bit."""
    from faer_tpu_torch.ops.kernels import real_schur as krs

    n = krs.shared_edge(dtype) + past
    assert krs.route(n, dtype) == ("global" if past else "shared")
    got, want = _schur_pair(_hess_batch(n, 1, 3, dtype), cuda)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# -- the complex Schur kernel ---------------------------------------------------

def _complex_hess_batch(n, batch, seed, dtype):
    gen = torch.Generator().manual_seed(seed)
    g = torch.complex(torch.randn(batch, n, n, generator=gen, dtype=torch.float64),
                      torch.randn(batch, n, n, generator=gen, dtype=torch.float64))
    return torch.triu(g, -1).to(dtype)


def _complex_schur_pair(h, cuda, factor=30):
    """The kernel on the card and its plain version on the CPU copies (IEEE
    operations on real numbers only, so the two devices round alike): T,
    Q, iterations, converged and chase steps of each."""
    from faer_tpu_torch.ops.kernels import complex_schur as kcs

    batch, n, _ = h.shape
    q = torch.eye(n, dtype=h.dtype).repeat(batch, 1, 1)
    sizes = torch.full((batch,), n, dtype=torch.int32)
    reset_launch_counts()
    got = kcs.complex_schur_batched(h.to(cuda), q.to(cuda), sizes.to(cuda),
                                    max_sweeps_factor=factor)
    torch.cuda.synchronize()
    assert launch_counts()["complex_schur"] == 1
    want = kcs.complex_schur_batched_plain(h, q, sizes, max_sweeps_factor=factor)
    return [g.cpu() for g in got], want


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("n,batch,factor", [(1, 2, 30), (2, 3, 30), (16, 4, 30), (48, 2, 30),
                                            (96, 1, 30), (48, 1, 0)])
def test_complex_schur_kernel_equals_its_plain_version(cuda, n, batch, factor, dtype):
    """T, Q, the iteration counts, the convergence flags and the chase steps
    equal to the bit; every problem converged, or none under a budget of
    0."""
    got, want = _complex_schur_pair(_complex_hess_batch(n, batch, n, dtype), cuda, factor)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert bool(got[3].all()) == (factor > 0 or n == 1)


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("past", [0, 1])
def test_complex_schur_kernel_at_its_shared_memory_edge(cuda, dtype, past):
    """The largest nmax whose H and Q the kernel keeps in shared memory
    (119 in complex64, 85 in complex128 on an H100) and the next, in global
    memory: equal to the plain version to the bit."""
    from faer_tpu_torch.ops.kernels import complex_schur as kcs

    n = kcs.shared_edge(dtype) + past
    assert kcs.route(n, dtype) == ("global" if past else "shared")
    got, want = _complex_schur_pair(_complex_hess_batch(n, 1, 5, dtype), cuda)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_complex_evd_on_card_against_the_cpu_route(cuda, monkeypatch):
    """``evd`` of a complex64 matrix at 200 (multishift with AED, each window
    one complex_schur launch) on the card and on the CPU: both residuals
    ‖AV − V diag(w)‖/‖A‖ within 8·n·eps, one launch an AED call and no
    other kernel."""
    import faer_tpu_torch as ft
    from faer_tpu_torch.linalg import schur_multishift as tms

    calls = []
    aed = tms._aed
    monkeypatch.setattr(tms, "_aed", lambda *a, **k: calls.append(1) or aed(*a, **k))
    n = 200
    rng = np.random.default_rng(200)
    g = (rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))).astype(np.complex64)
    a = torch.tensor(g)
    reset_launch_counts()
    w, v, info = ft.evd(a.to(cuda))
    torch.cuda.synchronize()
    counts = launch_counts()
    assert bool(info.converged) and counts["complex_schur"] == len(calls) > 0
    assert sum(counts.values()) == counts["complex_schur"]
    wc, vc, _ = ft.evd(a)
    an = g.astype(np.complex128)
    tol = 8 * n * EPS32

    def resid(w, v):
        w, v = w.cpu().numpy().astype(np.complex128), v.cpu().numpy().astype(np.complex128)
        return np.linalg.norm(an @ v - v * w) / np.linalg.norm(an)

    assert resid(w, v) <= tol and resid(wc, vc) <= tol


@pytest.mark.parametrize("case", ["ragged", "global memory"])
@pytest.mark.parametrize("kind", ["tridiag", "bidiag"])
def test_qr_batched_kernel_f64(cuda, kind, case):
    """The float64 instantiations: d, e, iterations, converged and sweep
    steps equal to the plain version's to the bit, the vectors within
    8·n·eps_f64; one launch under the sweep's counter."""
    from faer_tpu_torch.ops.kernels import sweep

    sizes, sqre, factor, _ = QR_BATCHED_CASES[case]
    d, e, sz, sq = _qr_batch(sizes, sqre, cuda, len(case))
    d, e = d.double(), e.double()
    nmax = d.shape[1]
    if kind == "tridiag":
        e = e[:, :nmax - 1].contiguous()
        args, kern, plain, counter = ((sz,), sweep.tridiag_qr_batched,
                                      sweep.tridiag_qr_batched_plain, "tridiag_sweep")
    else:
        args, kern, plain, counter = ((sz, sq), sweep.bidiag_qr_batched,
                                      sweep.bidiag_qr_batched_plain, "bidiag_sweep")
    d1, e1, d2, e2 = d.clone(), e.clone(), d.clone(), e.clone()
    reset_launch_counts()
    got = kern(d1, e1, *args, max_sweeps_factor=factor)
    torch.cuda.synchronize()
    assert launch_counts()[counter] == 1
    want = plain(d2, e2, *args, max_sweeps_factor=factor)
    assert torch.equal(d1, d2) and torch.equal(e1, e2)
    for g, w in zip(got[-3:], want[-3:]):
        assert torch.equal(g, w)
    for g, w in zip(got[:-3], want[:-3]):
        assert g.dtype == torch.float64
        assert (g - w).abs().max().item() <= 8 * nmax * float(np.finfo(np.float64).eps)


def test_evd_on_card_against_the_cpu_route(cuda, monkeypatch):
    """``evd`` at 300 (multishift with AED, each window one real_schur
    launch) on the card and on the CPU: both residuals ‖AV − V diag(w)‖/‖A‖
    and the sorted eigenvalues within 8·n·eps_f32 of each other; one launch
    per AED call, no sweep kernel."""
    import faer_tpu_torch as ft
    from faer_tpu_torch.linalg import schur_multishift as tms

    calls = []
    aed = tms._aed
    monkeypatch.setattr(tms, "_aed", lambda *a, **k: calls.append(1) or aed(*a, **k))
    n = 300
    g = np.random.default_rng(300).standard_normal((n, n)).astype(np.float32)
    a = torch.tensor(g)
    reset_launch_counts()
    w, v, info = ft.evd(a.to(cuda))
    torch.cuda.synchronize()
    counts = launch_counts()
    assert bool(info.converged) and counts["real_schur"] == len(calls) > 0
    assert counts["tridiag_sweep"] == counts["bidiag_sweep"] == 0
    wc, vc, _ = ft.evd(a)
    an = g.astype(np.float64)
    tol = 8 * n * EPS32

    def resid(w, v):
        w, v = w.cpu().numpy().astype(np.complex128), v.cpu().numpy().astype(np.complex128)
        return np.linalg.norm(an @ v - v * w) / np.linalg.norm(an)

    assert resid(w, v) <= tol and resid(wc, vc) <= tol
    wg = np.sort_complex(w.cpu().numpy().astype(np.complex128))
    wcp = np.sort_complex(wc.numpy().astype(np.complex128))
    assert np.abs(wg - wcp).max() <= tol * np.abs(wcp).max()


# -- the generalized EVD's kernels --------------------------------------------

def _gevd_inputs(n, batch, seed, dtype, rank_deficient=False):
    """The Givens chain's inputs on the CPU, (h, r, q, z) (batch, n, n):
    the QR of a Gaussian B (of rank n − 1 when ``rank_deficient``: a zero
    column, so R has a zero diagonal entry and T one the QZ must deflate),
    Q₀ᵀA, Z = I."""
    gen = torch.Generator().manual_seed(seed)
    a = torch.randn(batch, n, n, generator=gen, dtype=torch.float64)
    b = torch.randn(batch, n, n, generator=gen, dtype=torch.float64)
    if rank_deficient:
        b[:, :, min(3, n - 1)] = 0
    q, r = torch.linalg.qr(b)
    z = torch.eye(n, dtype=torch.float64).repeat(batch, 1, 1)
    return tuple(x.to(dtype).contiguous() for x in (q.mT @ a, torch.triu(r), q, z))


def _gevd_kernel_pairs(mats, sizes, cuda):
    """``hess_tri_batched`` and then ``real_qz_batched`` on the card (one
    launch each, the second on the first's output), and their plain
    versions on the CPU copies: (kernel outputs, plain outputs) of each."""
    from faer_tpu_torch.ops.kernels import hess_tri as kh
    from faer_tpu_torch.ops.kernels import real_qz as kq

    reset_launch_counts()
    red = kh.hess_tri_batched(*(x.to(cuda) for x in mats), sizes.to(cuda))
    qz = kq.real_qz_batched(*red, sizes.to(cuda))
    torch.cuda.synchronize()
    assert launch_counts()["hess_tri"] == 1 and launch_counts()["real_qz"] == 1
    red_cpu = [x.cpu() for x in red]
    return ((red_cpu, kh.hess_tri_batched_plain(*mats, sizes)),
            ([x.cpu() for x in qz], kq.real_qz_batched_plain(*red_cpu, sizes)))


def _assert_bitwise(pairs):
    for got, want in pairs:
        for g, w in zip(got, want):
            assert torch.equal(g, w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,batch", [(1, 2), (2, 2), (3, 3), (16, 3), (48, 1), (96, 1)])
def test_gevd_kernels_equal_their_plain_versions(cuda, n, batch, dtype):
    """H, R, Q, Z of the reduction and S, T, Q, Z, iterations, converged and
    chase steps of the QZ equal to the bit; every problem converged."""
    mats = _gevd_inputs(n, batch, n, dtype)
    pairs = _gevd_kernel_pairs(mats, torch.full((batch,), n, dtype=torch.int32), cuda)
    _assert_bitwise(pairs)
    assert bool(pairs[1][0][5].all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_gevd_kernels_ragged_and_rank_deficient(cuda, dtype):
    """A ragged batch (sizes 0 and 1 among them) and a B of rank n − 1 (the
    infinite-eigenvalue step on the card): equal to the bit, one β = 0."""
    mats = _gevd_inputs(40, 5, 7, dtype, rank_deficient=True)
    sizes = torch.tensor([40, 7, 1, 0, 33], dtype=torch.int32)
    pairs = _gevd_kernel_pairs(mats, sizes, cuda)
    _assert_bitwise(pairs)
    s, t = pairs[1][0][0][0], pairs[1][0][1][0]
    assert int((torch.diagonal(t) == 0).sum()) == 1 and bool(pairs[1][0][5][0])
    assert torch.equal(torch.tril(s, -2), torch.zeros_like(s))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kernel", ["hess_tri", "real_qz"])
@pytest.mark.parametrize("past", [0, 1])
def test_gevd_kernels_at_their_shared_memory_edge(cuda, dtype, kernel, past):
    """The largest nmax whose four matrices the kernel keeps in shared
    memory (120 and 119 in float32, 85 in float64 on an H100) and the next,
    in global memory: both kernels equal to their plain versions."""
    from faer_tpu_torch.ops.kernels import hess_tri as kh
    from faer_tpu_torch.ops.kernels import real_qz as kq

    mod = kh if kernel == "hess_tri" else kq
    n = mod.shared_edge(dtype) + past
    assert mod.route(n, dtype) == ("global" if past else "shared")
    mats = _gevd_inputs(n, 1, 5, dtype)
    _assert_bitwise(_gevd_kernel_pairs(mats, torch.full((1,), n, dtype=torch.int32), cuda))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_gevd_kernels_past_the_cta_width(cuda, dtype):
    """At 520, past the kernels' 512 threads a CTA (the width of the main
    path's 1024): some threads take two entries of a row, the CTA
    reductions span 16 warps, the matrices sit in global memory. Both
    kernels equal to their plain versions; the QZ converged."""
    n = 520
    mats = _gevd_inputs(n, 1, 520, dtype)
    pairs = _gevd_kernel_pairs(mats, torch.full((1,), n, dtype=torch.int32), cuda)
    _assert_bitwise(pairs)
    assert bool(pairs[1][0][5].all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_gevd_on_card_against_scipy(cuda, dtype):
    """``gevd`` at 256 on the card (one ``hess_tri`` and one ``real_qz``
    launch): A V diag(β) − B V diag(α) within 8·n·eps of (‖A‖|β| + ‖B‖|α|)
    column by column, and every (α, β) within 2·κ_i·η of scipy's in the
    chordal metric (κ_i the pencil's chordal condition number from scipy's
    vectors, η the call's backward error ‖(A − QSZᵀ, B − QTZᵀ)‖₂)."""
    import faer_tpu_torch as ft
    import scipy.linalg as sla

    n = 256
    rng = np.random.default_rng(256)
    a64, b64 = rng.standard_normal((n, n)), rng.standard_normal((n, n))
    a, b = (torch.tensor(x, dtype=dtype, device=cuda) for x in (a64, b64))
    reset_launch_counts()
    s, t, q, z, info = ft.real_qz(a, b)
    alpha, beta, v, info2 = ft.gevd(a, b)
    torch.cuda.synchronize()
    assert launch_counts()["hess_tri"] == 2 and launch_counts()["real_qz"] == 2
    assert bool(info.converged) and bool(info2.converged)
    ad, bd = (x.double() for x in (a, b))
    sd, td, qd, zd = (x.double() for x in (s, t, q, z))
    eta = float(np.hypot(torch.linalg.matrix_norm(ad - qd @ sd @ zd.T, ord=2).item(),
                         torch.linalg.matrix_norm(bd - qd @ td @ zd.T, ord=2).item()))
    al, be = (x.cpu().numpy().astype(np.complex128) for x in (alpha, beta))
    vn = v.cpu().numpy().astype(np.complex128)
    eps = float(torch.finfo(dtype).eps)
    num = np.linalg.norm(a64 @ vn * be[None, :] - b64 @ vn * al[None, :], axis=0)
    den = (np.linalg.norm(a64, 2) * np.abs(be) + np.linalg.norm(b64, 2) * np.abs(al)) \
        * np.linalg.norm(vn, axis=0)
    assert (num / den).max() <= 8 * n * eps
    (ra, rb), yl, xr = sla.eig(a64, b64, left=True, right=True, homogeneous_eigvals=True)
    kappa = (np.linalg.norm(yl, axis=0) * np.linalg.norm(xr, axis=0)
             / np.hypot(np.abs(np.sum(yl.conj() * (a64 @ xr), axis=0)),
                        np.abs(np.sum(yl.conj() * (b64 @ xr), axis=0))))
    chord = (np.abs(al[:, None] * rb[None, :] - ra[None, :] * be[:, None])
             / (np.hypot(np.abs(al), np.abs(be))[:, None]
                * np.hypot(np.abs(ra), np.abs(rb))[None, :]))
    tol = 2 * kappa * eta
    assert (chord.min(axis=0) / tol).max() <= 1
    assert (chord.min(axis=1) / tol[chord.argmin(axis=1)]).max() <= 1


def test_qr_panel_at_a_subnormal_scale_on_card(cuda):
    """F2 on the card: the QR panel kernel on a (4096, 128) Gaussian scaled
    by 1e-20 (f32 squares subnormal; the cluster route), its rescaled
    branch: R, V and τ within 2·b·eps of ``qr_panel_plain`` and of the
    kernel's one-pass order (relative to their own largest entries), Q
    orthogonal and Q R = A within 2·b·eps in f64, and every wrapper of the
    family (one kernel) equal to ``qr_panel`` to the bit. The kernel's
    parallel sums make no plain version its bitwise twin; their rounding
    reaches the later columns through at most b reflectors."""
    from faer_tpu_torch.ops.kernels import leaf, qr_panel_v1, qr_panel_v2, qr_panel_v3
    from faer_tpu_torch.ops.kernels.qr_panel import (
        qr_panel, qr_panel_onepass_plain, qr_panel_plain)

    m, b = 4096, 128
    gen = torch.Generator(device=cuda).manual_seed(20)
    a = torch.randn(m, b, generator=gen, device=cuda) * 1e-20
    k1, t1 = qr_panel(a)
    tol = 2 * b * EPS32
    for k, t in (qr_panel_plain(a), qr_panel_onepass_plain(a)):
        assert _rel(torch.triu(k1[:b]), torch.triu(k[:b])) <= tol
        assert _rel(torch.tril(k1, -1), torch.tril(k, -1)) <= tol
        assert (t1 - t).abs().max().item() <= tol
    pk = k1.double()
    v = torch.tril(pk, -1) + torch.eye(m, b, dtype=torch.float64, device=cuda)
    q = torch.eye(m, dtype=torch.float64, device=cuda)
    for j in range(b - 1, -1, -1):
        q -= t1[j].double() * torch.outer(v[:, j], v[:, j] @ q)
    eye = torch.eye(m, dtype=torch.float64, device=cuda)
    assert (q.T @ q - eye).abs().max().item() <= tol
    assert ((q @ torch.triu(pk) - a.double()).abs().max() / a.abs().max()).item() <= tol
    for fn in (qr_panel_v1.qr_panel_v1, qr_panel_v2.qr_panel_v2, qr_panel_v3.qr_panel_v3,
               leaf.qr_leaf):
        k2, t2 = fn(a)
        assert torch.equal(k1, k2) and torch.equal(t1, t2)


def test_complex_llt_ldlt_on_card(cuda):
    """complex64 LLT and LDLT at n = 512 on the card: the 1024 float32
    embedding runs the fused-panel route, 4 ``llt_panel`` launches (a
    panel of 256 for each 256 columns of the embedding) and the solves'
    ``trtri``; L, the packed LDLT and both solves within 8·n·eps of the
    plain CPU route of the same functions, the backward errors too."""
    from faer_tpu_torch.linalg import cholesky as ch

    n = 512
    gen = torch.Generator(device="cpu").manual_seed(21)
    g = torch.complex(torch.randn(n, n, generator=gen), torch.randn(n, n, generator=gen))
    a = g @ g.mH / n + torch.eye(n)
    b = torch.complex(torch.randn(n, 8, generator=gen), torch.randn(n, 8, generator=gen))
    ac, bc = a.to(cuda), b.to(cuda)
    tol = 8 * n * EPS32
    reset_launch_counts()
    l, info = ch.llt_factor(ac)
    x = ch.llt_solve(l, bc)
    torch.cuda.synchronize()
    counts = launch_counts()
    assert counts["llt_panel"] == 4 and counts["trtri"] > 0 and bool(info.success)
    assert l.is_cuda and x.is_cuda and l.dtype == torch.complex64
    lp, _ = ch.llt_factor(a)
    xp = ch.llt_solve(lp, b)
    assert _rel(l.cpu(), lp) <= tol and _rel(x.cpu(), xp) <= tol
    res = ((ac @ x - bc).abs().max() / (ac.abs().max() * x.abs().max())).item()
    assert res <= tol
    ld, info = ch.ldlt_factor(ac)
    y = ch.ldlt_solve(ld, bc)
    ldp, _ = ch.ldlt_factor(a)
    assert ld.is_cuda and _rel(ld.cpu(), ldp) <= tol
    assert _rel(y.cpu(), ch.ldlt_solve(ldp, b)) <= tol


def test_complex_spectral_one_sweep_launch_on_card(cuda):
    """complex64 Hermitian EVD and SVD on the card, the direct QR route
    (100) and the D&C route (600): one sweep launch and no host read a
    call, real values within 8·n·eps of f64 ``eigvalsh``/``svdvals``,
    VᴴV = I, UᴴU = I and the reconstructions within 8·n·eps; no other
    kernel runs (the complex reductions stay off the kernels)."""
    from faer_tpu_torch import self_adjoint_evd, svd
    from faer_tpu_torch.core.config import host_reads

    gen = torch.Generator(device=cuda).manual_seed(22)
    for n in (100, 600):
        g = torch.complex(torch.randn(n, n, generator=gen, device=cuda),
                          torch.randn(n, n, generator=gen, device=cuda))
        a = (g + g.mH) / 2
        tol = 8 * n * EPS32
        eye = torch.eye(n, device=cuda)
        reset_launch_counts()
        w, v, info = self_adjoint_evd(a)
        torch.cuda.synchronize()
        counts = launch_counts()
        assert counts["tridiag_sweep"] == 1 and host_reads() == 0
        assert sum(counts.values()) == 1 and w.dtype == torch.float32
        assert ((a @ v - v * w).norm() / a.norm()).item() <= tol
        assert (v.mH @ v - eye).abs().max().item() <= tol
        w64 = torch.linalg.eigvalsh(a.to(torch.complex128))
        assert ((w.double() - w64).abs().max() / w64.abs().max()).item() <= tol
        reset_launch_counts()
        u, s, vs, info = svd(g)
        torch.cuda.synchronize()
        counts = launch_counts()
        assert counts["bidiag_sweep"] == 1 and host_reads() == 0 and sum(counts.values()) == 1
        assert (((u * s) @ vs.mH - g).norm() / g.norm()).item() <= tol
        assert (u.mH @ u - eye).abs().max().item() <= tol
        assert (vs.mH @ vs - eye).abs().max().item() <= tol
        s64 = torch.linalg.svdvals(g.to(torch.complex128))
        assert ((s.double() - s64).abs().max() / s64[0]).item() <= tol


def _complex_gevd_inputs(n, batch, seed, dtype, rank=None):
    """The complex Givens chain's inputs on the CPU, (h, r, q, z) (batch, n,
    n): the QR of a complex Gaussian B (of rank ``rank`` when given, so that
    R has zero diagonal entries), Q₀ᴴA, Z = I."""
    gen = torch.Generator().manual_seed(seed)

    def cg(*shape):
        return torch.complex(torch.randn(*shape, generator=gen, dtype=torch.float64),
                             torch.randn(*shape, generator=gen, dtype=torch.float64))

    a, b = cg(batch, n, n), cg(batch, n, n)
    if rank is not None:
        b = cg(batch, n, rank) @ cg(batch, rank, n)
    q, r = torch.linalg.qr(b)
    z = torch.eye(n, dtype=torch.complex128).repeat(batch, 1, 1)
    return tuple(x.to(dtype).contiguous() for x in (q.mH @ a, torch.triu(r), q, z))


def _complex_gevd_kernel_pairs(mats, sizes, cuda, factor=30):
    """``complex_hess_tri_batched`` and then ``complex_qz_batched`` on the
    card (one launch each, the second on the first's output), and their
    plain versions on the CPU copies (IEEE operations on real numbers only,
    so the two devices round alike): (kernel outputs, plain outputs) of
    each."""
    from faer_tpu_torch.ops.kernels import complex_qz as kcq

    reset_launch_counts()
    red = kcq.complex_hess_tri_batched(*(x.to(cuda) for x in mats), sizes.to(cuda))
    qz = kcq.complex_qz_batched(*red, sizes.to(cuda), max_sweeps_factor=factor)
    torch.cuda.synchronize()
    assert launch_counts()["complex_hess_tri"] == 1 and launch_counts()["complex_qz"] == 1
    red_cpu = [x.cpu() for x in red]
    return ((red_cpu, kcq.complex_hess_tri_batched_plain(*mats, sizes)),
            ([x.cpu() for x in qz], kcq.complex_qz_batched_plain(
                *red_cpu, sizes, max_sweeps_factor=factor)))


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("n,batch,factor", [(1, 2, 30), (2, 2, 30), (3, 3, 30), (16, 3, 30),
                                            (48, 1, 30), (96, 1, 30), (48, 1, 0)])
def test_complex_gevd_kernels_equal_their_plain_versions(cuda, n, batch, factor, dtype):
    """H, R, Q, Z of the complex reduction and S, T, Q, Z, iterations,
    converged and chase steps of the complex QZ equal to the bit; every
    problem converged, or none under a budget of 0."""
    mats = _complex_gevd_inputs(n, batch, n, dtype)
    pairs = _complex_gevd_kernel_pairs(mats, torch.full((batch,), n, dtype=torch.int32),
                                       cuda, factor)
    _assert_bitwise(pairs)
    assert bool(pairs[1][0][5].all()) == (factor > 0 or n == 1)


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_complex_gevd_kernels_ragged_and_low_rank(cuda, dtype):
    """A ragged batch (sizes 0 and 1 among them) and a B of rank 12 at 16
    (four infinite eigenvalues, carried by the guarded shift): equal to the
    bit."""
    mats = _complex_gevd_inputs(40, 5, 7, dtype)
    sizes = torch.tensor([40, 7, 1, 0, 33], dtype=torch.int32)
    _assert_bitwise(_complex_gevd_kernel_pairs(mats, sizes, cuda))
    mats = _complex_gevd_inputs(16, 1, 12, dtype, rank=12)
    _assert_bitwise(_complex_gevd_kernel_pairs(mats, torch.full((1,), 16, dtype=torch.int32),
                                               cuda))


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("kernel", ["complex_hess_tri", "complex_qz"])
@pytest.mark.parametrize("past", [0, 1])
def test_complex_gevd_kernels_at_their_shared_memory_edge(cuda, dtype, kernel, past):
    """The largest nmax whose four matrices the kernel keeps in shared
    memory and the next, in global memory: both kernels equal to their
    plain versions."""
    from faer_tpu_torch.ops.kernels import complex_qz as kcq

    n = kcq.shared_edge(kernel, dtype) + past
    assert kcq.route(kernel, n, dtype) == ("global" if past else "shared")
    mats = _complex_gevd_inputs(n, 1, 5, dtype)
    _assert_bitwise(_complex_gevd_kernel_pairs(mats, torch.full((1,), n, dtype=torch.int32),
                                               cuda))


def test_complex_hess_tri_past_the_cta_width(cuda):
    """At 520, past the kernel's 512 threads a CTA (the width of the main
    path's 1024): some threads take two entries of a row, the matrices sit
    in global memory; equal to the plain version to the bit."""
    from faer_tpu_torch.ops.kernels import complex_qz as kcq

    mats = _complex_gevd_inputs(520, 1, 520, torch.complex64)
    sizes = torch.full((1,), 520, dtype=torch.int32)
    got = kcq.complex_hess_tri_batched(*(x.to(cuda) for x in mats), sizes.to(cuda))
    _assert_bitwise([([x.cpu() for x in got], kcq.complex_hess_tri_batched_plain(*mats, sizes))])


@pytest.mark.parametrize("n", [100, 200])
def test_complex_gevd_on_card_against_the_cpu_route(cuda, n, monkeypatch):
    """``gevd`` of a complex64 pencil at 100 (one complex_hess_tri and one
    complex_qz launch) and 200 (multishift QZ with AED: one complex_qz and
    one complex_hess_tri launch an AED window, besides the reduction's) on
    the card and on the CPU: both pencil residuals ‖AVβ − BVα‖ within 8·n·eps
    of (‖A‖|β| + ‖B‖|α|)‖v‖ column by column; no other kernel."""
    import faer_tpu_torch as ft
    from faer_tpu_torch.linalg import qz_multishift as tqm

    calls = []
    aed = tqm._aed
    monkeypatch.setattr(tqm, "_aed", lambda *a, **k: calls.append(1) or aed(*a, **k))
    rng = np.random.default_rng(n)
    an, bn = ((rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n)))
              .astype(np.complex64) for _ in range(2))
    a, b = torch.tensor(an), torch.tensor(bn)
    reset_launch_counts()
    alpha, beta, v, info = ft.gevd(a.to(cuda), b.to(cuda))
    torch.cuda.synchronize()
    counts = launch_counts()
    windows = len(calls)
    assert bool(info.converged) and (windows > 0) == (n >= 128)
    assert counts["complex_qz"] == max(windows, 1)
    assert counts["complex_hess_tri"] == 1 + windows
    assert sum(counts.values()) == counts["complex_qz"] + counts["complex_hess_tri"]
    a64, b64 = an.astype(np.complex128), bn.astype(np.complex128)

    def resid(alpha, beta, v):
        al, be, vn = (x.cpu().numpy().astype(np.complex128) for x in (alpha, beta, v))
        num = np.linalg.norm(a64 @ vn * be[None, :] - b64 @ vn * al[None, :], axis=0)
        den = (np.linalg.norm(a64, 2) * np.abs(be) + np.linalg.norm(b64, 2) * np.abs(al)) \
            * np.linalg.norm(vn, axis=0)
        return (num / den).max()

    tol = 8 * n * EPS32
    assert resid(alpha, beta, v) <= tol
    assert resid(*ft.gevd(a, b)[:3]) <= tol
