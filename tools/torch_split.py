"""Per-call and device time of a checkout's hand-written kernels and their callers, on one CUDA card.

    python tools/torch_split.py {chase,dense,gevd,householder,llt,llt_panel,lu,lu_swap,matmul,qr,spectral,syrk,trtri} [ROOT]

Times the ``faer_tpu_torch`` under ROOT (by default this checkout) with the
timers and inputs of this checkout's ``chip_smoke.py``: ``cuda_ms`` per
call (what a caller pays, the host's wrapper included) and ``graph_ms`` on
the device (a CUDA graph of the calls). Only this checkout's
``chip_smoke.py`` is used, so one chip call can time another checkout (a
parent commit unpacked beside this one) in turns with this one by the same
code. The rows, per kernel:

* ``chase`` (seed 19): ``chase_probe`` on Gaussian strips at phase 3's
  ``CHASE_CASES`` ((64, 1, 3), (64, 4, 24), (128, 8, 24)) and at the chase
  lab's g = 1 chains, b ∈ {64, 128} and steps ∈ {256, 1024} (the chain's
  time a step is the difference of the two over 768), per call and on the
  device (a CUDA graph of the calls); no PyTorch call computes a chase
  step;
* ``dense`` (seed 15): phase 13's calls at 4096 (``chip_smoke.
  _dense_inputs``): in float64 ``llt_factor``, ``lu_in_place``,
  ``qr_in_place``, ``ldlt_factor``, ``piv_llt_factor``,
  ``full_piv_lu_in_place``, ``col_piv_qr_in_place``, the rank-8
  ``llt_rank_r_update`` and ``ldlt_rank_r_update`` and the 8-rhs
  ``ldlt_solve``, and ``ldlt_factor`` in float32, each once per call
  (after one warm-up) and on the device (a CUDA graph of one call; none of
  them reads the host); ``lblt_factor``, which reads the host once a
  panel, per call only; ``cholesky_ex``, ``ldl_factor``, ``lu_factor_ex``
  and ``geqrf`` in float64 on the same inputs, per call;
* ``gevd`` (seed 20): the general EVD's host-driven layer,
  ``multishift_real_schur`` at ``GEVD_N`` in float32 on
  ``hessenberg_blocked``'s output (one call after a warm-up: its sweeps
  and AED rounds read the host), and ``Mat(a).eigen()`` at 128 (the
  multishift route's edge) per call;
* ``householder`` (seed 21): the host-issued callers of
  ``make_householder``, each per call: ``hessenberg_blocked`` at 1024 in
  float32 and float64 (the general EVD's reduction), ``qr_in_place`` at
  1024 and 4096 and ``col_piv_qr_in_place`` at 1024 in float64, and
  ``make_householder`` on one column of 1024 in float32, with Gaussian
  inputs;
* ``llt``: ``llt_leaf``, ``llt_block``, ``llt_block_v3`` and
  ``torch.linalg.cholesky_ex`` at phase 3's sizes ``LLT_TIMED``, on its
  ``_spd`` inputs mirrored from the lower triangle (seed 1);
* ``llt_panel`` (seed 14): ``llt_panel`` at ``LLT_PANEL_SHAPES`` on
  ``chip_smoke._llt_slab`` slabs, and on the main path's view (m = 3840,
  row stride 1024, as ``_llt_factor_v5`` hands a panel over), per call and
  on the device, each beside the two-call yardstick
  ``chip_smoke.llt_pair`` (``cholesky_ex(A11)`` then ``solve_triangular``
  for L21) on the same slab; then per call and on the device
  ``llt_factor`` at 4096 beside ``cholesky_ex``, ``flagship_step`` at 4096
  (8 right-hand sides, ``chip_smoke._inputs``), and per call only (they
  read ``info.success`` on the host) ``Mat(a).llt()`` and
  ``Mat(a).llt().solve(b)`` at 4096 with the tile switch off;
* ``lu`` (seed 13): ``lu_panel`` at (4096, 256), (2048, 256) and
  (65536, 256), ``lu_leaf`` at (4000, 256) and ``lu_panel_v2_batched`` on
  16 × (4096, 256), per call and on the device, each beside
  ``torch.linalg.lu_factor_ex`` on the same inputs per call (it cannot be
  captured in a CUDA graph on panels); then per call and on the device
  ``lu_in_place`` at 4096 beside ``lu_factor_ex``, ``flagship_step`` at 4096 (8
  right-hand sides, ``chip_smoke._inputs``),
  ``Mat(g).partial_piv_lu().solve(b)`` at 4096 with the tile switch off,
  the off-route ``lu_in_place`` of a 4000², and the CALU factor of a
  65536 × 1024 at ``_CALU_GROUP`` = 4096 (the gate restored after);
* ``lu_swap`` (seed 18): ``lu_panel_swap``, the LU panel that swaps rows,
  on Gaussian panels at (4096, 128) (the v1 kernel's measured shape),
  (1000, 100), (4096, 256) and (40000, 256), per call and on the device,
  each beside ``torch.linalg.lu_factor_ex`` on the same panel per call;
* ``matmul`` (seed 10): ``tile_matmul`` in each mode ("highest" FP32,
  "high" bf16x3, bf16) at 4096³ and at the facade's thin products
  (``chip_smoke.tile_matmul_rows``: Vᵀ·B (128, 4096)·(4096, 3968) and
  Vᵀ·b (128, 4096)·(4096, 8), ``.mT`` lhs), ``torch.matmul`` beside each
  on the same operands, ``Mat(g) @ Mat(h)`` at 4096 with the tile switch
  on beside ``g @ h``, and phase 8's facade solves at 4096 (8 right-hand
  sides, ``chip_smoke._inputs``) with the switch off and on (per call
  only);
* ``qr`` (seed 12): ``qr_panel`` at (4096, 128) and (4096, 256) with
  ``torch.geqrf`` on the same inputs; ``qr_panel_v1``, ``qr_panel_v2``,
  ``qr_panel_v3`` and ``qr_leaf`` at (4096, 256); ``qr_panel`` at
  (8192, 128) and (65536, 128); per call only, ``qr_in_place`` at 4096,
  ``qr_solve_lstsq`` of 4096 × 8 after it, the 8192 × 2048 factor and
  lstsq, and ``Mat(a).qr().solve_lstsq(b)`` at 4096 with the tile switch
  off;
* ``spectral`` (seed 16): ``self_adjoint_evd`` and ``svd`` at 384 (the
  direct QR route) and 4096, ``tridiag_evd`` and ``bidiag_svd`` (the D&C
  layers) at 4096 on ``tridiag_in_place``'s and ``bidiag_in_place``'s
  outputs, and the two leaf stages at 4096 (every D&C leaf solved: one
  batched launch in a checkout that has ``tridiag_dnc._leaf_stage``, else
  the leaves one after another, as the parent's recursion formed them);
  ``eigh`` and ``torch.linalg.svd`` beside each call and, per shape, on the
  leaves as dense blocks. Per call (the 4096 calls one call after a
  warm-up); the leaf stages also in a CUDA graph when batched; the card's
  busy time (``chip_smoke.device_ms``, torch.profiler) of the 384 calls
  and, in a batched checkout, of the D&C layers;
* ``syrk`` (seed 17): ``syrk_lower_sub`` at (3840, 256), a 4096 LLT's
  trailing update at block 256, on a row-major (K-major) A in
  ``f32_precision`` "highest" (FP32) and "high" (bf16x3), and on an
  M-major A (a ``.mT`` view) in FP32, per call and on the device, each
  beside ``torch.addmm(c, a, aᵀ, alpha=−1)`` on the same operands;
* ``trtri`` (seed 9): ``trtri`` on one 128 block (``_trtri_block``); the
  inverses of the 32 diagonal blocks of a 4096 triangle as a triangular
  solve makes them (one ``trtri_batched`` launch, or 32 ``trtri`` calls on
  contiguous copies in a checkout without it, as its solve loop made
  them); ``solve_lower_triangular`` and ``solve_upper_triangular`` at
  4096 × 8; ``flagship_step`` and ``lu_in_place`` at 4096 (per call only);
  ``torch.linalg.solve_triangular`` beside them on the same inputs.

Prints the card's name and power limit, one line a row, and as the last
line one JSON object with every row. Exits non-zero without a card.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parents[1]
N = 4096  # the trtri rows' triangle and flagship size
NRHS = 8
STEP_REPS = 5  # per-call repetitions of the solves, the step and the factor
QR_REPS = 10  # per-call repetitions, and calls in a graph, of the QR panels
LU_REPS = 10  # the same for the LU panels
SYRK_SHAPE = (3840, 256)  # (m, k): a 4096 LLT's trailing update at block 256
LU_SWAP_SHAPES = ((4096, 128), (1000, 100), (4096, 256), (40000, 256))


def _chip_smoke():
    """This checkout's ``chip_smoke.py`` as a module (its ``main`` not run)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def gevd_rows(cs):
    """(name, call, per-call reps, graph reps) of the general EVD's Schur
    step at ``GEVD_N`` and the facade's EVD at 128, both float32."""
    from faer_tpu_torch import Mat
    from faer_tpu_torch.linalg.evd import hessenberg_blocked
    from faer_tpu_torch.linalg.schur_multishift import multishift_real_schur

    gen = torch.Generator(device="cuda").manual_seed(20)
    a = torch.randn(cs.GEVD_N, cs.GEVD_N, generator=gen, device="cuda")
    h, q = hessenberg_blocked(a)
    yield (f"multishift_real_schur n={cs.GEVD_N} f32", lambda: multishift_real_schur(h, q),
           1, None)
    a2 = torch.randn(128, 128, generator=gen, device="cuda")
    yield "Mat(a).eigen() n=128 f32", lambda: Mat(a2).eigen(), 3, None


def householder_rows(cs):
    """(name, call, per-call reps, None) of ``make_householder`` and the
    host-issued loops that call it once a column."""
    from faer_tpu_torch.linalg import qr as Q
    from faer_tpu_torch.linalg.evd import hessenberg_blocked
    from faer_tpu_torch.ops.householder import make_householder

    gen = torch.Generator(device="cuda").manual_seed(21)
    g = torch.randn(N, N, generator=gen, device="cuda", dtype=torch.float64)
    small = g[:1024, :1024].contiguous()
    for dt in (torch.float32, torch.float64):
        h = small.to(dt)
        yield f"hessenberg_blocked n=1024 {dt}", lambda h=h: hessenberg_blocked(h), 3, None
    yield "qr_in_place n=1024 float64", lambda: Q.qr_in_place(small), 3, None
    yield f"qr_in_place n={N} float64", lambda: Q.qr_in_place(g), 3, None
    yield "col_piv_qr_in_place n=1024 float64", lambda: Q.col_piv_qr_in_place(small), 3, None
    col = small[:, 0].float()
    yield "make_householder m=1024 float32", lambda: make_householder(col), 50, None


def llt_rows(cs):
    """(name, call, per-call reps, graph reps) of the LLT diagonal block."""
    from faer_tpu_torch.ops.kernels.leaf import llt_leaf
    from faer_tpu_torch.ops.kernels.llt_block import llt_block, llt_block_v3

    calls = {"llt_leaf": llt_leaf, "llt_block": llt_block, "llt_block_v3": llt_block_v3,
             "cholesky_ex": torch.linalg.cholesky_ex}
    gen = torch.Generator(device="cuda").manual_seed(1)
    for b in cs.LLT_TIMED:
        a = cs._mirrored(cs._spd(b, gen))
        for name, fn in calls.items():
            yield f"{name} b={b}", (lambda f=fn: f(a)), cs.LLT_CALL_REPS, cs.LLT_GRAPH_REPS


def trtri_rows(cs):
    """(name, call, per-call reps, graph reps or None) of ``trtri`` and the
    calls that reach it."""
    from faer_tpu_torch.entry import flagship_step
    from faer_tpu_torch.linalg.lu import lu_in_place
    from faer_tpu_torch.ops.kernels import trtri as ktrtri
    from faer_tpu_torch.ops.triangular_solve import (
        solve_lower_triangular, solve_upper_triangular)

    gen = torch.Generator(device="cuda").manual_seed(9)
    blk = cs._trtri_block(128, False, gen)
    a_spd, g, b = cs._inputs(N, gen)
    lo = torch.linalg.cholesky(a_spd)
    up = lo.mT.contiguous()
    blocks = [(o, 128) for o in range(0, N, 128)]
    if hasattr(ktrtri, "trtri_batched"):
        inverses = lambda: ktrtri.trtri_batched(lo, blocks)
    else:
        inverses = lambda: [ktrtri.trtri(lo[o:o + s, o:o + s].contiguous())
                            for o, s in blocks]
    stack = torch.stack([torch.tril(lo[o:o + s, o:o + s]) for o, s in blocks])
    eye = torch.eye(128, device="cuda")
    reps = cs.TRTRI_REPS
    solve = torch.linalg.solve_triangular
    yield "trtri n=128", lambda: ktrtri.trtri(blk), reps, reps
    yield ("solve_triangular(L, I) n=128",
           lambda: solve(torch.tril(blk), eye, upper=False), reps, reps)
    yield f"diagonal inverses of a {N} triangle ({len(blocks)} blocks)", inverses, reps, reps
    yield ("solve_triangular(L, I) on the (32, 128, 128) batch",
           lambda: solve(stack, eye, upper=False), reps, reps)
    yield (f"solve_lower_triangular {N}x{NRHS}", lambda: solve_lower_triangular(lo, b),
           STEP_REPS, STEP_REPS)
    yield (f"solve_triangular lower {N}x{NRHS}", lambda: solve(lo, b, upper=False),
           STEP_REPS, STEP_REPS)
    yield (f"solve_upper_triangular {N}x{NRHS}", lambda: solve_upper_triangular(up, b),
           STEP_REPS, STEP_REPS)
    yield (f"solve_triangular upper {N}x{NRHS}", lambda: solve(up, b, upper=True),
           STEP_REPS, STEP_REPS)
    yield f"flagship_step n={N}", lambda: flagship_step(a_spd, g, b), STEP_REPS, None
    yield f"lu_in_place n={N}", lambda: lu_in_place(g), STEP_REPS, None


def matmul_rows(cs):
    """(name, call, per-call reps, graph reps or None) of ``tile_matmul``,
    the facade's product and the facade's solves."""
    from faer_tpu_torch import Mat
    from faer_tpu_torch.core.config import config

    gen = torch.Generator(device="cuda").manual_seed(10)
    reps = cs.TILE_REPS
    for mode, label, x, y, call, lib in cs.tile_matmul_rows(gen):
        yield f"tile_matmul {mode} {label}", call, reps, reps
        yield f"torch.matmul {str(x.dtype)[6:]} {label}", lib, reps, reps
    g = torch.randn(N, N, generator=gen, device="cuda")
    h = torch.randn(N, N, generator=gen, device="cuda")

    def facade():
        config.use_tile_matmul, config.f32_precision = True, "highest"
        return Mat(g) @ Mat(h)

    yield f"Mat(g) @ Mat(h) n={N}, tile switch on", facade, reps, reps
    yield f"g @ h n={N}", lambda: g @ h, reps, reps
    spd, gl, rhs = cs._inputs(N, gen)
    solves = {"Mat(spd).llt().solve(b)": lambda: Mat(spd).llt().solve(rhs),
              "Mat(g).partial_piv_lu().solve(b)": lambda: Mat(gl).partial_piv_lu().solve(rhs),
              "Mat(g).qr().solve_lstsq(b)": lambda: Mat(gl).qr().solve_lstsq(rhs)}
    for label, fn in solves.items():
        for on in (False, True):
            def call(fn=fn, on=on):
                config.use_tile_matmul, config.f32_precision = on, "highest"
                return fn()

            yield (f"{label} n={N}, tile switch {'on' if on else 'off'}", call,
                   STEP_REPS, None)
    config.use_tile_matmul = False


def qr_rows(cs):
    """(name, call, per-call reps, graph reps or None) of the QR panel
    kernel and the QR paths that reach it."""
    from faer_tpu_torch import Mat, qr_in_place, qr_solve_lstsq
    from faer_tpu_torch.core.config import config
    from faer_tpu_torch.ops.kernels.leaf import qr_leaf
    from faer_tpu_torch.ops.kernels.qr_panel import qr_panel
    from faer_tpu_torch.ops.kernels.qr_panel_v1 import qr_panel_v1
    from faer_tpu_torch.ops.kernels.qr_panel_v2 import qr_panel_v2
    from faer_tpu_torch.ops.kernels.qr_panel_v3 import qr_panel_v3

    gen = torch.Generator(device="cuda").manual_seed(12)
    reps = QR_REPS
    for m, b in ((4096, 128), (4096, 256)):
        a = torch.randn(m, b, generator=gen, device="cuda")
        yield f"qr_panel ({m}, {b})", lambda a=a: qr_panel(a), reps, reps
        yield f"geqrf ({m}, {b})", lambda a=a: torch.geqrf(a), reps, reps
    a = torch.randn(4096, 256, generator=gen, device="cuda")
    for name, fn in (("qr_panel_v1", qr_panel_v1), ("qr_panel_v2", qr_panel_v2),
                     ("qr_panel_v3", qr_panel_v3), ("qr_leaf", qr_leaf)):
        yield f"{name} (4096, 256)", lambda fn=fn: fn(a), reps, reps
    for m in (8192, 65536):
        t = torch.randn(m, 128, generator=gen, device="cuda")
        yield f"qr_panel ({m}, 128)", lambda t=t: qr_panel(t), reps, reps
    g = torch.randn(N, N, generator=gen, device="cuda")
    rhs = torch.randn(N, NRHS, generator=gen, device="cuda")
    packed, ts, block = qr_in_place(g)
    yield f"qr_in_place n={N}", lambda: qr_in_place(g), STEP_REPS, None
    yield (f"qr_solve_lstsq {N}x{NRHS}", lambda: qr_solve_lstsq(packed, ts, block, rhs),
           STEP_REPS, None)
    yield f"geqrf n={N}", lambda: torch.geqrf(g), STEP_REPS, None
    mt, nt = cs.TALL
    at = torch.randn(mt, nt, generator=gen, device="cuda")
    bt = torch.randn(mt, NRHS, generator=gen, device="cuda")

    def tall():
        p, t, blk = qr_in_place(at)
        return qr_solve_lstsq(p, t, blk, bt)

    yield f"qr_in_place + qr_solve_lstsq {mt}x{nt}", tall, STEP_REPS, None

    def facade():
        config.use_tile_matmul = False
        return Mat(g).qr().solve_lstsq(rhs)

    yield f"Mat(a).qr().solve_lstsq(b) n={N}, tile switch off", facade, STEP_REPS, None


def dense_rows(cs):
    """(name, call, per-call reps, graph reps or None) of phase 13's
    factorizations at N, float64 unless named."""
    from faer_tpu_torch.linalg import cholesky as C
    from faer_tpu_torch.linalg import lu as L
    from faer_tpu_torch.linalg import qr as Q

    x = cs._dense_inputs(N, torch.Generator(device="cuda").manual_seed(15))
    spd, sym, g, b, w = (x[k] for k in ("spd", "sym", "g", "b", "w"))
    l, ld = C.llt_factor(spd)[0], C.ldlt_factor(spd)[0]
    spd32 = spd.float()
    rows = {"llt_factor": lambda: C.llt_factor(spd),
            "lu_in_place": lambda: L.lu_in_place(g),
            "qr_in_place": lambda: Q.qr_in_place(g),
            "ldlt_factor": lambda: C.ldlt_factor(spd),
            "ldlt_factor f32": lambda: C.ldlt_factor(spd32),
            f"ldlt_solve {N}x{NRHS}": lambda: C.ldlt_solve(ld, b),
            "piv_llt_factor": lambda: C.piv_llt_factor(spd),
            "full_piv_lu_in_place": lambda: L.full_piv_lu_in_place(g),
            "col_piv_qr_in_place": lambda: Q.col_piv_qr_in_place(g),
            f"llt_rank_r_update r={cs.DENSE_R}": lambda: C.llt_rank_r_update(l, w, 1.0),
            f"ldlt_rank_r_update r={cs.DENSE_R}": lambda: C.ldlt_rank_r_update(ld, w, 1.0)}
    for name, fn in rows.items():
        yield f"{name} n={N}", fn, 1, 1
    yield f"lblt_factor n={N}", lambda: C.lblt_factor(sym), 1, None
    for name, fn in (("cholesky_ex", lambda: torch.linalg.cholesky_ex(spd)),
                     ("ldl_factor", lambda: torch.linalg.ldl_factor(spd)),
                     ("ldl_factor (g + gᵀ)/2", lambda: torch.linalg.ldl_factor(sym)),
                     ("lu_factor_ex", lambda: torch.linalg.lu_factor_ex(g)),
                     ("geqrf", lambda: torch.geqrf(g))):
        yield f"{name} n={N}", fn, STEP_REPS, None


LLT_PANEL_SHAPES = ((4096, 256), (2048, 256), (256, 256), (4096, 512), (65536, 256))


def llt_panel_rows(cs):
    """(name, call, per-call reps, graph reps or None) of the LLT panel kernel, its
    two-call yardstick and the LLT paths that reach it."""
    from faer_tpu_torch import Mat
    from faer_tpu_torch.core.config import config
    from faer_tpu_torch.entry import flagship_step
    from faer_tpu_torch.linalg.cholesky import llt_factor
    from faer_tpu_torch.ops.kernels.llt_panel import llt_panel

    gen = torch.Generator(device="cuda").manual_seed(14)
    reps = LU_REPS
    for m, b in LLT_PANEL_SHAPES:
        a = cs._llt_slab(m, b, gen)
        yield f"llt_panel ({m}, {b})", lambda a=a: llt_panel(a), reps, reps
        yield f"cholesky_ex + solve_triangular ({m}, {b})", lambda a=a: cs.llt_pair(a), reps, reps
    strip = torch.empty(3840, 1024, device="cuda")
    strip[:, :256] = cs._llt_slab(3840, 256, gen)
    view = strip[:, :256]
    yield "llt_panel (3840, 256), row stride 1024", lambda: llt_panel(view), reps, reps
    yield ("cholesky_ex + solve_triangular (3840, 256), row stride 1024",
           lambda: cs.llt_pair(view), reps, reps)
    spd, g, rhs = cs._inputs(N, gen)
    yield f"llt_factor n={N}", lambda: llt_factor(spd), STEP_REPS, STEP_REPS
    yield f"cholesky_ex n={N}", lambda: torch.linalg.cholesky_ex(spd), STEP_REPS, STEP_REPS
    yield f"flagship_step n={N}", lambda: flagship_step(spd, g, rhs), STEP_REPS, STEP_REPS

    def llt():
        config.use_tile_matmul = False
        return Mat(spd).llt()

    def solve():
        config.use_tile_matmul = False
        return Mat(spd).llt().solve(rhs)

    # Llt.new reads info.success on the host: per call only
    yield f"Mat(a).llt() n={N}, tile switch off", llt, STEP_REPS, None
    yield f"Mat(a).llt().solve(b) n={N}, tile switch off", solve, STEP_REPS, None


def lu_rows(cs):
    """(name, call, per-call reps, graph reps or None) of the LU panel
    kernel and the LU paths that reach it."""
    from faer_tpu_torch import Mat
    from faer_tpu_torch.core.config import config
    from faer_tpu_torch.entry import flagship_step
    from faer_tpu_torch.linalg import lu as tlu
    from faer_tpu_torch.ops.kernels.leaf import lu_leaf
    from faer_tpu_torch.ops.kernels.lu_panel import lu_panel
    from faer_tpu_torch.ops.kernels.lu_panel_v2 import lu_panel_v2_batched

    gen = torch.Generator(device="cuda").manual_seed(13)
    reps = LU_REPS
    lib = torch.linalg.lu_factor_ex
    for m in (4096, 2048, 65536):
        a = torch.randn(m, 256, generator=gen, device="cuda")
        yield f"lu_panel ({m}, 256)", lambda a=a: lu_panel(a), reps, reps
        yield f"lu_factor_ex ({m}, 256)", lambda a=a: lib(a), reps, None
    a = torch.randn(4000, 256, generator=gen, device="cuda")
    yield "lu_leaf (4000, 256)", lambda: lu_leaf(a), reps, reps
    yield "lu_factor_ex (4000, 256)", lambda: lib(a), reps, None
    stack = torch.randn(16, 4096, 256, generator=gen, device="cuda")
    yield "lu_panel_v2_batched 16 x (4096, 256)", lambda: lu_panel_v2_batched(stack), reps, reps
    yield "lu_factor_ex 16 x (4096, 256)", lambda: lib(stack), reps, None
    spd, g, rhs = cs._inputs(N, gen)
    yield f"lu_in_place n={N}", lambda: tlu.lu_in_place(g), STEP_REPS, STEP_REPS
    yield f"lu_factor_ex n={N}", lambda: lib(g), STEP_REPS, STEP_REPS
    yield f"flagship_step n={N}", lambda: flagship_step(spd, g, rhs), STEP_REPS, STEP_REPS

    def solve():
        config.use_tile_matmul = False
        return Mat(g).partial_piv_lu().solve(rhs)

    yield f"Mat(g).partial_piv_lu().solve(b) n={N}, tile switch off", solve, STEP_REPS, STEP_REPS
    g2 = torch.randn(4000, 4000, generator=gen, device="cuda")
    yield "lu_in_place 4000x4000 (off-route)", lambda: tlu.lu_in_place(g2), STEP_REPS, STEP_REPS
    tall = torch.randn(*cs.CALU, generator=gen, device="cuda")

    def calu():
        gate = tlu._CALU_GROUP
        tlu._CALU_GROUP = cs.CALU_GROUP
        try:
            return tlu.lu_in_place(tall)
        finally:
            tlu._CALU_GROUP = gate

    yield (f"lu_in_place {cs.CALU[0]}x{cs.CALU[1]}, CALU group {cs.CALU_GROUP}", calu,
           STEP_REPS, STEP_REPS)


def syrk_rows(cs):
    """(name, call, per-call reps, graph reps) of ``syrk_lower_sub`` in
    both precisions and of ``torch.addmm`` on the same operands."""
    from faer_tpu_torch.core.config import config
    from faer_tpu_torch.ops.kernels.syrk import syrk_lower_sub

    gen = torch.Generator(device="cuda").manual_seed(17)
    m, k = SYRK_SHAPE
    c = torch.randn(m, m, generator=gen, device="cuda")
    ak = torch.randn(m, k, generator=gen, device="cuda")
    am = torch.randn(k, m, generator=gen, device="cuda").mT
    reps = cs.TILE_REPS
    for label, a, modes in (("K-major", ak, ("highest", "high")), ("M-major", am, ("highest",))):
        for mode in modes:
            def call(a=a, mode=mode):
                config.f32_precision = mode
                return syrk_lower_sub(c, a)

            yield f"syrk_lower_sub {mode} ({m}, {k}) {label}", call, reps, reps
        yield (f"torch.addmm(c, a, aᵀ, alpha=-1) ({m}, {k}) {label}",
               lambda a=a: torch.addmm(c, a, a.mT, alpha=-1), reps, reps)
    config.f32_precision = "highest"


CHASE_CHAINS = tuple((b, 1, steps) for b in (64, 128) for steps in (256, 1024))


def chase_rows(cs):
    """(name, call, per-call reps, graph reps) of ``chase_probe`` at phase
    3's cases and the lab's chains."""
    from faer_tpu_torch.ops.kernels.band_chase import chase_probe

    gen = torch.Generator(device="cuda").manual_seed(19)
    for b, g, steps in cs.CHASE_CASES + CHASE_CHAINS:
        band = torch.randn(g * 4 * b, 2 * b, generator=gen, device="cuda")
        reps = 10 if steps <= 256 else 5
        yield (f"chase_probe b={b} g={g} steps={steps}",
               lambda band=band, b=b, g=g, steps=steps: chase_probe(band, b=b, steps=steps, g=g),
               reps, reps)


def lu_swap_rows(cs):
    """(name, call, per-call reps, graph reps or None) of ``lu_panel_swap``
    and ``lu_factor_ex`` on the same panels."""
    from faer_tpu_torch.ops.kernels.lu_panel_swap import lu_panel_swap

    gen = torch.Generator(device="cuda").manual_seed(18)
    for m, b in LU_SWAP_SHAPES:
        a = torch.randn(m, b, generator=gen, device="cuda")
        yield f"lu_panel_swap ({m}, {b})", lambda a=a: lu_panel_swap(a), LU_REPS, LU_REPS
        yield (f"lu_factor_ex ({m}, {b})", lambda a=a: torch.linalg.lu_factor_ex(a),
               LU_REPS, None)


SPECTRAL_DIRECT = 384  # the direct QR route (n < 512)


def _tridiag_leaves(d, e, leaf=64):
    """The D&C leaves' (d, e) as ``tridiag_evd_dnc``'s recursion forms them:
    halves, the tear's β taken off the two ends it joins."""
    n = d.shape[0]
    if n <= leaf:
        return [(d, e)]
    k = n // 2
    d1, d2 = d[:k].clone(), d[k:].clone()
    d1[k - 1] -= e[k - 1]
    d2[0] -= e[k - 1]
    return _tridiag_leaves(d1, e[:k - 1], leaf) + _tridiag_leaves(d2, e[k:], leaf)


def _bidiag_leaves(d, e, sqre, leaf=64):
    """The D&C leaves' (d, e, sqre) as ``bidiag_dnc._dnc``'s recursion
    forms them: the rows above the middle one (wide), and the rows below."""
    m = d.shape[0]
    if m <= leaf:
        return [(d, e, sqre)]
    k = m // 2
    return _bidiag_leaves(d[:k], e[:k], 1, leaf) + _bidiag_leaves(d[k + 1:], e[k + 1:],
                                                                  sqre, leaf)


def _tridiag_dense(blocks):
    """The (d, e) blocks as dense symmetric tridiagonals, stacked."""
    return torch.stack([torch.diag(d) + torch.diag(e, 1) + torch.diag(e, -1)
                        for d, e in blocks])


def _bidiag_dense(blocks):
    """The (d, e, sqre) blocks as dense (m, m + sqre) upper bidiagonals, stacked."""
    out = []
    for d, e, sqre in blocks:
        m = d.shape[0]
        b = torch.zeros(m, m + sqre, device=d.device)
        idx = torch.arange(m, device=d.device)
        b[idx, idx] = d
        b[idx[:m - 1 + sqre], idx[:m - 1 + sqre] + 1] = e
        out.append(b)
    return torch.stack(out)


def _by_shape(blocks, shape):
    groups = {}
    for blk in blocks:
        groups.setdefault(shape(blk), []).append(blk)
    return groups


def spectral_rows(cs):
    """(name, call, per-call reps, graph reps, "profile" or None) of the
    spectral calls, their D&C layers and their leaf stages."""
    from faer_tpu_torch import self_adjoint_evd, svd
    from faer_tpu_torch.linalg import bidiag_dnc, tridiag_dnc
    from faer_tpu_torch.linalg.bidiag import bidiag_in_place
    from faer_tpu_torch.linalg.bidiag_svd import bidiag_svd
    from faer_tpu_torch.linalg.tridiag import tridiag_in_place
    from faer_tpu_torch.linalg.tridiag_evd import tridiag_evd

    # a checkout with the batched leaf kernels solves every leaf in one
    # launch and reads the host nowhere in it: its leaf stage is captured in
    # a CUDA graph and its D&C layers are profiled; the parent's loops (one
    # host read an iteration, ~10⁶ launches a 4096 layer) are timed per call
    # only, as are the 4096 calls (their reductions' host loops make ~10⁵
    # launches, which torch.profiler takes minutes to collect)
    batched = hasattr(tridiag_dnc, "_leaf_stage")
    dev_rows = "profile" if batched else None
    gen = torch.Generator(device="cuda").manual_seed(16)
    n2 = SPECTRAL_DIRECT
    g2 = torch.randn(n2, n2, generator=gen, device="cuda")
    a2 = (g2 + g2.T) / 2
    yield f"self_adjoint_evd n={n2}", lambda: self_adjoint_evd(a2), 3, None, "profile"
    yield f"svd n={n2}", lambda: svd(g2), 3, None, "profile"
    yield f"eigh n={n2}", lambda: torch.linalg.eigh(a2), 3, None, None
    yield (f"torch.linalg.svd n={n2}", lambda: torch.linalg.svd(g2, full_matrices=False),
           3, None, None)
    g = torch.randn(N, N, generator=gen, device="cuda")
    a = (g + g.T) / 2
    d, e, _, _ = tridiag_in_place(a)
    bd = bidiag_in_place(g)
    nrm = torch.maximum(bd[0].abs().max(), bd[1].abs().max())
    dn, en = bd[0] / nrm, bd[1] / nrm  # bidiag_svd_dnc's scaling
    t_leaves = _tridiag_leaves(d, e)
    b_leaves = _bidiag_leaves(dn, en, 0)
    if batched:
        t_stage = lambda: tridiag_dnc._leaf_stage(d, e)
        b_stage = lambda: bidiag_dnc._leaf_stage(dn, en, 0)
    else:
        t_stage = lambda: [tridiag_evd(x, y) for x, y in t_leaves]
        b_stage = lambda: [bidiag_dnc._leaf(x, y, sq) for x, y, sq in b_leaves]
    graph = 3 if batched else None
    yield f"tridiag leaf stage n={N} ({len(t_leaves)} leaves)", t_stage, 1, graph, None
    yield f"bidiag leaf stage n={N} ({len(b_leaves)} leaves)", b_stage, 1, graph, None
    yield f"tridiag_evd (D&C) n={N}", lambda: tridiag_evd(d, e), 1, None, dev_rows
    yield f"bidiag_svd (D&C) n={N}", lambda: bidiag_svd(bd[0], bd[1]), 1, None, dev_rows
    yield f"self_adjoint_evd n={N}", lambda: self_adjoint_evd(a), 1, None
    yield f"svd n={N}", lambda: svd(g), 1, None
    yield f"eigh n={N}", lambda: torch.linalg.eigh(a), 3, None, None
    yield (f"torch.linalg.svd n={N}", lambda: torch.linalg.svd(g, full_matrices=False),
           3, None, None)
    # the library yardsticks of the leaf stages: the leaves as dense blocks,
    # one batched call a shape
    for (m,), blocks in _by_shape(t_leaves, lambda b: tuple(b[0].shape)).items():
        t = _tridiag_dense(blocks)
        yield (f"eigh of the {len(blocks)} tridiagonal leaves of {m}",
               lambda t=t: torch.linalg.eigh(t), 3, None, None)
    for (m, sq), blocks in _by_shape(b_leaves, lambda b: (b[0].shape[0], b[2])).items():
        t = _bidiag_dense(blocks)
        yield (f"torch.linalg.svd of the {len(blocks)} bidiagonal leaves ({m}, {m + sq})",
               lambda t=t: torch.linalg.svd(t, full_matrices=False), 3, None, None)


ROWS = {"chase": chase_rows, "dense": dense_rows, "gevd": gevd_rows,
        "householder": householder_rows, "llt": llt_rows,
        "llt_panel": llt_panel_rows, "lu": lu_rows, "lu_swap": lu_swap_rows,
        "matmul": matmul_rows, "qr": qr_rows, "spectral": spectral_rows,
        "syrk": syrk_rows, "trtri": trtri_rows}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("kernel", choices=sorted(ROWS))
    parser.add_argument("root", nargs="?", type=Path, default=HERE,
                        help="the checkout to time (default: this one)")
    args = parser.parse_args()
    root = args.root.resolve()
    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is false: this script needs a CUDA card")
    sys.path.insert(0, str(root))
    cs = _chip_smoke()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"nvidia-smi: {smi}")
    rows = []
    for name, fn, reps, graph_reps, *busy in ROWS[args.kernel](cs):
        r = dict(call=name, per_call_ms=cs.cuda_ms(fn, reps),
                 device_ms=cs.graph_ms(fn, graph_reps) if graph_reps else None)
        if busy and busy[0] == "profile":
            # calls that read the host cannot be captured: the card's busy
            # time instead, the kernel spans torch.profiler records
            r["device_busy_ms"] = cs.device_ms(fn)
        rows.append(r)
        print(f"{name}: per call {r['per_call_ms']:.4f} ms"
              + ("" if r["device_ms"] is None else f", device {r['device_ms']:.4f} ms")
              + (f", device busy {r['device_busy_ms']:.4f} ms" if "device_busy_ms" in r
                 else ""), flush=True)
    print(json.dumps({"kernel": args.kernel, "root": str(root), "device": smi,
                      "rows": rows}))


if __name__ == "__main__":
    main()
