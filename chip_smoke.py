"""Drive the PyTorch port's main path once on one CUDA card and check it.

    python3 chip_smoke.py

Phases, each printing lines; any failure exits non-zero:

1. device: a CUDA card must be present (no CPU fallback); prints the card's
   name and power limit as nvidia-smi reports them;
2. build: compiles ``faer_tpu_torch/csrc/*.cu`` into ``build/faer_tpu_torch``;
3. kernels: each hand-written kernel against its plain PyTorch version on
   the card, at the main paths' shapes, with the tolerance stated, and its
   time beside its plain version's, its bound and a library yardstick;
4. flagship step: ``flagship_step`` at n = 4096 f32 (the JAX package's bench
   size) with 8 right-hand sides on inputs made from seed 0, launch counts,
   reconstruction errors, solve residuals, a reference check at n = 1024
   against an f64 oracle, and CUDA-event timings of each factorization and
   solve;
5. QR: ``qr_in_place`` then ``qr_solve_lstsq`` at n = 4096 (as ``bench.py``
   drives it), launch counts, ‖QR − A‖, QᵀQ − I, the solve residual, tall
   8192 × 2048 and 65536 × 512 least-squares solves, an f64 check at
   2048 × 512, and timings;
6. off-route: ``llt_factor`` and ``lu_in_place`` on shapes the fused route
   does not take (the recursive drivers and their leaf kernels), launch
   counts, reconstruction errors and timings;
7. spectral: ``self_adjoint_evd((g + gᵀ)/2)`` and ``svd(g)`` at n = 4096
   f32 (``tools/bench_spectral.py``'s cells) on inputs made from seed 0,
   sweep-kernel launch counts and host reads, residuals and orthogonality,
   eigenvalues and singular values against an f64 oracle at n = 1024, the
   direct QR-iteration route at n = 384, the tall SVD at 8192 × 2048 (QR
   preprocessing), per-layer times and ``torch.linalg.eigh``/``svd``
   yardsticks;
8. facade: ``Mat`` and the solver objects at n = 4096 f32 (seed 0) with the
   tile GEMM switch on (``config.use_tile_matmul``, ``f32_precision =
   "highest"``): ``Mat @ Mat``, ``llt()`` with ``solve``, ``inverse``,
   ``determinant``/``logdet``, ``partial_piv_lu()`` with ``solve``,
   ``solve_transpose``, ``inverse``, ``determinant``, ``qr().solve_lstsq``
   at 4096 and 8192 × 2048, ``self_adjoint_eigen()`` and ``svd()`` at
   1024; ``tile_matmul`` launches per call, residuals, the same calls with
   the switch off (no launch), times with the switch off and on in turns,
   and the GEMM and ``llt().solve`` errors with ``f32_precision = "high"``;
9. calu: the tournament (CALU) leaf, ``lu_in_place`` on a Gaussian
   65536 × 1024 f32 (seed 0) with ``_CALU_GROUP`` = 4096 (4 leaves of 16
   groups, each leaf one batched ``lu_panel_v2`` launch and one more for
   its stacked candidates), launch counts against the code's prediction,
   ‖A[perm] − LU‖/‖A‖ and max|L|, ``lu_solve`` after ``lu_in_place`` on a
   4000² with the gate at 1024, and the 65536 × 1024 factor's time beside
   the default gate's (``lu_leaf`` leaves) and ``torch.linalg.lu_factor_ex``.

Each path is driven with the launch counters set to 0 just before it and
read just after. The second-to-last line is a JSON object with one entry
per kernel; the last is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import torch

DEV = "cuda"  # every tensor of the run lives on the card
N = 4096  # flagship size: a 64 MiB f32 matrix
SEED = 0
EPS32 = float(torch.finfo(torch.float32).eps)
# NVIDIA's data sheet, H100 SXM at 700 W: FP32 outside the tensor cores, bf16
# dense on the tensor cores, HBM3
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
# launches the code predicts (PERF.md, PR 2): recursive-driver leaves per
# off-route factor, and trtri in one qr_in_place + qr_solve_lstsq at N
LLT_LEAVES = {4000: 32, 1000: 16}
LU_LEAVES = {(4000, 4000): 16, (4096, 1024): 4, (1024, 4096): 4}
QR_TRTRI = 96
# operations per step of the sweep kernels' chains, counted from their source
SWEEP_STEP_FLOPS = 28
SPECTRAL_SLOW_S = 10.0  # above this a call is timed once, not 1 + median of 3
ORACLE_N = 1024  # spectral check against f64 eigvalsh / svdvals
DIRECT_N = 384  # below 512: the QR iteration without D&C
TALL = (8192, 2048)  # m/n > 11/6: the SVD's QR preprocessing
TILE = 128  # output tile side of tile_matmul and syrk_lower_sub
# limits of the tile kernels' errors, relative to max‖a_i‖·max‖b_j‖ (PERF.md
# §6). An FP32 result (FP32 FFMA, or bf16 operands' exact products summed
# in f32) differs from the plain one only in the order of its sums: ≤ 16·eps,
# where one TF32 pass errs ~3e-5 at k = 4096. bf16x3 errs ~1.4e-6 against the
# plain split and against f64, where one bf16 pass errs ~2.5e-4.
F32_TOL = 16 * EPS32
BF16X3_TOL = 2e-5
FACADE_SPECTRAL_N = 1024  # the facade's EVD and SVD (phase 7 runs 4096)
CALU = (65536, 1024)  # the tall-skinny LU that the CALU leaf was kept for
CALU_GROUP = 4096  # _CALU_GROUP for phase 9's tall factor: 16 groups a leaf
CALU_SOLVE = (4000, 1024)  # (n, gate) of phase 9's square factor and solve
# launches per lu_in_place in phase 9 (PERF.md §6), counted from the
# drivers' control flow, which does not depend on the data
CALU_LAUNCHES = {CALU: dict(lu_panel_v2=8, lu_leaf=0, trtri=14),
                 (4000, 4000): dict(lu_panel_v2=24, lu_leaf=4, trtri=68)}
# tile_matmul launches per facade call with the switch on (PERF.md §6):
# the drivers' products, counted from their control flow, which does not
# depend on the data (4096 unless the name says otherwise)
FACADE_MATMUL = {
    "Mat @ Mat": 1, "Mat @ Mat 1024": 1, "llt()": 18, "llt().solve": 30,
    "llt().inverse()": 62, "llt().determinant()": 0, "partial_piv_lu()": 18,
    "partial_piv_lu().solve": 30, "partial_piv_lu().solve_transpose": 30,
    "partial_piv_lu().inverse()": 62, "partial_piv_lu().determinant()": 0,
    "qr().solve_lstsq": 109 + 29, "qr().solve_lstsq 8192x2048": 53 + 8,
    "self_adjoint_eigen() 1024": 24, "svd() 1024": 36,
}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    print(("ok    " if cond else "FAIL  ") + msg, flush=True)
    if not cond:
        sys.exit(1)


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Median wall time of ``fn`` on the card, in ms, by CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def graph_ms(fn, reps: int) -> float:
    """Device time of ``fn`` per call, in ms: ``reps`` calls captured in one
    CUDA graph and replayed, timed by CUDA events, so the host's launch cost
    (which ``cuda_ms`` includes for a kernel shorter than it) drops out."""
    fn()  # outside the capture: lazy loads and first allocations
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def bound_of(flops: float, nbytes: float, peak: float = PEAK_F32_FLOPS) -> dict:
    """The least time the card could take: the larger of the operations
    over the peak rate of their type (FP32 unless ``peak`` says otherwise)
    and the bytes (each input read once, each output written once) over the
    memory rate."""
    t_ops = flops / peak * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return dict(bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes")


def rel_norm(x, y) -> float:
    return (torch.linalg.matrix_norm(x - y) / torch.linalg.matrix_norm(y)).item()


def phase_device() -> str:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()
    print(f"nvidia-smi: {smi[0]}")
    name = torch.cuda.get_device_name(0)
    print(f"device: {name}, count {torch.cuda.device_count()}, torch "
          f"{torch.__version__}, cuda {torch.version.cuda}")
    return name


def phase_build() -> None:
    from faer_tpu_torch.ops.kernels import _build

    _build.build(extra_flags=("-Xptxas", "-v"))
    _build.library()
    secs = _build.build_seconds
    print(f"build: {'reused' if secs is None else f'{secs:.1f} s'} -> "
          f"{_build._library_path().name}")
    # the full -Xptxas -v report goes beside the library
    with open(_build.BUILD_DIR / "ptxas.log", "w") as f:
        f.write(_build.build_log)
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print("ptxas:", line.strip())


def _max_rel(got, want) -> tuple[float, float]:
    err = (got - want).abs().max().item()
    return err, err / max(want.abs().max().item(), 1e-30)


def _spd(n: int, gen) -> torch.Tensor:
    g0 = torch.randn(n, n, generator=gen, device=DEV)
    return g0 @ g0.T / n + torch.eye(n, device=DEV)


def _separated_panel(m: int, b: int, gen):
    """P·L·U with |L| ≤ 1/(2√b) below a unit diagonal: every pivot beats the
    other candidates by 2√b. Off-diagonal entries are O(1/√b) so that L and
    U stay well conditioned, and the pivot order is the same under any
    rounding."""
    lo = (torch.rand(m, b, generator=gen, device=DEV) - 0.5) / b ** 0.5
    lo = torch.tril(lo, -1) + torch.eye(m, b, device=DEV)
    up = torch.triu(torch.randn(b, b, generator=gen, device=DEV), 1) / b ** 0.5
    up = up + torch.diag(1.0 + torch.rand(b, generator=gen, device=DEV))
    p = torch.randperm(m, generator=gen, device=DEV)
    a = torch.empty(m, b, device=DEV)
    a[p] = lo @ up
    return a


def _trtri_block(n: int, unit: bool, gen) -> torch.Tensor:
    """A lower-triangular block with garbage above the diagonal, which the
    kernel must not read. Unit: strict lower entries N(0, 1/n), so the
    condition number stays O(1), and a stored diagonal in [2, 3], which the
    kernel must ignore. Non-unit: the Cholesky factor of g gᵀ/n + I."""
    g = torch.randn(n, n, generator=gen, device=DEV)
    if unit:
        lo = torch.tril(g / n ** 0.5, -1) + torch.diag(
            2.0 + torch.rand(n, generator=gen, device=DEV))
    else:
        lo = torch.linalg.cholesky(g @ g.T / n + torch.eye(n, device=DEV))
    return (lo + torch.triu(torch.randn(n, n, generator=gen, device=DEV), 1)
            ).contiguous()


def _regularized_spd(b: int, bad, gen) -> torch.Tensor:
    """A = L Lᵀ − 1e-3·Σ e_k e_kᵀ over the ``bad`` columns k, where L has
    diagonal 0 there and in [1.5, 2.5] elsewhere: the bad pivots are
    clearly negative and every other pivot is at least 2.25 under any
    rounding."""
    lo = torch.tril(torch.randn(b, b, generator=gen, device=DEV) / b ** 0.5, -1)
    diag = 1.5 + torch.rand(b, generator=gen, device=DEV)
    diag[bad] = 0.0
    lo = lo + torch.diag(diag)
    a = lo @ lo.T
    a[bad, bad] -= 1e-3
    return a


def phase_kernels(gen) -> dict:
    from faer_tpu_torch.ops.householder import apply_block_on_left, form_block_t
    from faer_tpu_torch.ops.kernels.leaf import (
        llt_leaf, llt_leaf_plain, lu_leaf, lu_leaf_plain)
    from faer_tpu_torch.ops.kernels.llt_panel import llt_panel, llt_panel_plain
    from faer_tpu_torch.ops.kernels.lu_panel import lu_panel, lu_panel_plain
    from faer_tpu_torch.ops.kernels import _build
    from faer_tpu_torch.ops.kernels.qr_panel import MIN_ROWS_PER_CTA as qr_min_rows
    from faer_tpu_torch.ops.kernels.qr_panel import qr_panel, qr_panel_plain
    from faer_tpu_torch.ops.kernels.trtri import trtri, trtri_plain
    from faer_tpu_torch.utils import flops

    res = {}
    # trtri: against the plain version and an f64 inverse of the structured
    # block; forward-error tolerance 8·n·eps·κ₂(L), relative to max|L⁻¹|
    errs = []
    for n, unit in ((128, False), (128, True), (100, False), (100, True)):
        t = _trtri_block(n, unit, gen)
        got, want = trtri(t, unit=unit), trtri_plain(t, unit=unit)
        torch.cuda.synchronize()
        lo64 = torch.tril(t.double(), -1) + (
            torch.eye(n, dtype=torch.float64, device=DEV) if unit
            else torch.diag(torch.diagonal(t).double()))
        tol = 8 * n * EPS32 * torch.linalg.cond(lo64).item()
        err, rel = _max_rel(got, want)
        _, rel64 = _max_rel(got.double(), torch.linalg.inv(lo64))
        errs.append(err)
        check(rel <= tol and rel64 <= tol,
              f"trtri n={n} unit={unit}: max abs err {err:.3e}, rel {rel:.3e} "
              f"vs plain, {rel64:.3e} vs f64 <= tol {tol:.3e}")
    t = _trtri_block(128, False, gen)
    eye128 = torch.eye(128, device=DEV)
    res["trtri"] = dict(
        max_abs_err=max(errs), ms=cuda_ms(lambda: trtri(t), 50),
        plain_ms=cuda_ms(lambda: trtri_plain(t), 3),
        library_ms=cuda_ms(lambda: torch.linalg.solve_triangular(
            torch.tril(t), eye128, upper=False), 50),
        **bound_of(128 ** 3 / 3, 2 * 128 * 128 * 4))

    # llt_panel: SPD slabs with cond ≤ 5; tolerance 8·b·eps relative to max|strip|
    errs = []
    spd = _spd(4096, gen)
    for m in (4096, 1024, 256):
        slab = spd[:m, :256].contiguous()
        (s1, c1, o1), (s2, c2, o2) = llt_panel(slab), llt_panel_plain(slab)
        torch.cuda.synchronize()
        tol = 8 * 256 * EPS32
        err, rel = _max_rel(s1, s2)
        errs.append(err)
        check(rel <= tol and bool(o1) and bool(o2) and int(c1) == int(c2) == 0,
              f"llt_panel ({m}, 256): max abs err {err:.3e}, rel {rel:.3e} "
              f"<= tol {tol:.3e}, ok {bool(o1)}, count {int(c1)}")
    slab = spd[:, :256].contiguous()
    res["llt_panel"] = dict(
        max_abs_err=max(errs), ms=cuda_ms(lambda: llt_panel(slab), 10),
        plain_ms=cuda_ms(lambda: llt_panel_plain(slab), 3),
        library_ms=None,  # no single library call computes the fused panel
        **bound_of(256 ** 3 / 3 + (4096 - 256) * 256 ** 2, 2 * 4096 * 256 * 4))

    # lu_panel: separated pivots, so perm must match exactly; packed within
    # 8·m·eps relative to max|packed|. At m = 40000 the rows (40 MiB) exceed
    # the card's shared memory, so the kernel keeps them in global memory
    errs = []
    for m in (4096, 1024, 256, 40000):
        pan = _separated_panel(m, 256, gen)
        (k1, p1, n1, o1), (k2, p2, n2, o2) = lu_panel(pan), lu_panel_plain(pan)
        torch.cuda.synchronize()
        tol = 8 * m * EPS32
        err, rel = _max_rel(k1, k2)
        errs.append(err)
        check(bool((p1 == p2).all()) and int(n1) % 2 == int(n2) % 2
              and bool(o1) and bool(o2) and rel <= tol,
              f"lu_panel ({m}, 256): perm equal {bool((p1 == p2).all())}, nt "
              f"{int(n1)} vs {int(n2)}, ok {bool(o1)}, max abs err {err:.3e}, "
              f"rel {rel:.3e} <= tol {tol:.3e}")
        if m > 10000:
            print(f"time lu_panel ({m}, 256): kernel "
                  f"{cuda_ms(lambda: lu_panel(pan), 3):.4f} ms, lu_factor_ex "
                  f"{cuda_ms(lambda: torch.linalg.lu_factor_ex(pan), 3):.4f} ms")
    pan = torch.randn(4096, 256, generator=gen, device=DEV)
    res["lu_panel"] = dict(
        max_abs_err=max(errs), ms=cuda_ms(lambda: lu_panel(pan), 10),
        plain_ms=cuda_ms(lambda: lu_panel_plain(pan), 3),
        library_ms=cuda_ms(lambda: torch.linalg.lu_factor_ex(pan), 10),
        **bound_of(flops.lu_flops(4096, 256), 2 * 4096 * 256 * 4 + 4096 * 8))

    # qr_panel: Gaussian panels (m ≥ 4b, so κ ≤ 3) and one with an all-zero
    # column (τ = 0 there). At (57000, 128) a CTA's rows (rows per CTA ×
    # (b + 1) × 4 B, printed) just fit its 227 KiB of shared memory; at
    # (60000, 128) and (16384, 512) they do not, and the kernel keeps them in
    # global memory. Against the plain version and torch.geqrf (the same
    # larfg signs): R and the reflector tails V each within 8·m·eps relative
    # to their own largest entry, τ within 8·m·eps; Q = I − V T Vᵀ orthogonal,
    # and ‖Q·R − A‖/‖A‖, to 8·m·eps
    errs = []
    for m, b, zero in ((4096, 128, None), (3968, 128, None), (1000, 128, None),
                       (200, 44, None), (1000, 128, 5), (57000, 128, None),
                       (60000, 128, None), (16384, 512, None)):
        a = torch.randn(m, b, generator=gen, device=DEV)
        if zero is not None:
            a[:, zero] = 0.0
        (k1, t1), (k2, t2) = qr_panel(a), qr_panel_plain(a)
        k3, t3 = torch.geqrf(a)
        torch.cuda.synchronize()
        tol = 8 * m * EPS32
        r1, v1 = torch.triu(k1[:b]), torch.tril(k1, -1)
        err_r = max(_max_rel(r1, torch.triu(k[:b]))[1] for k in (k2, k3))
        err_v = max(_max_rel(v1, torch.tril(k, -1))[1] for k in (k2, k3))
        terr = max((t1 - t).abs().max().item() for t in (t2, t3))
        v = v1 + torch.eye(m, b, device=DEV)
        q = apply_block_on_left(v, form_block_t(v, t1),
                                torch.eye(m, b, device=DEV), adjoint=False)
        orth = (q.T @ q - torch.eye(b, device=DEV)).abs().max().item()
        rec = rel_norm(q @ r1, a)
        zero_ok = zero is None or (t1[zero].item() == 0.0
                                   and bool((k1[zero:, zero] == 0).all()))
        err = (k1 - k2).abs().max().item()
        errs.append(err)
        rpc = _build.grid(m, a.device, qr_min_rows)[1]
        check(max(err_r, err_v, terr, orth, rec) <= tol and zero_ok,
              f"qr_panel ({m}, {b}){' zero column' if zero else ''} "
              f"[{rpc} rows per CTA, {rpc * (b + 1) * 4 / 1024:.0f} KiB]: max "
              f"abs err {err:.3e} vs plain; rel R {err_r:.3e}, rel V "
              f"{err_v:.3e}, taus {terr:.3e} vs plain and geqrf; |QᵀQ-I| "
              f"{orth:.3e}, |QR-A|/|A| {rec:.3e}; all <= {tol:.3e}")
        if m > 10000:  # the tall shapes, near and past the shared-memory edge
            print(f"time qr_panel ({m}, {b}): kernel "
                  f"{cuda_ms(lambda: qr_panel(a), 3):.4f} ms, geqrf "
                  f"{cuda_ms(lambda: torch.geqrf(a), 3):.4f} ms")
    pq = torch.randn(4096, 128, generator=gen, device=DEV)
    res["qr_panel"] = dict(
        max_abs_err=max(errs), ms=cuda_ms(lambda: qr_panel(pq), 10),
        plain_ms=cuda_ms(lambda: qr_panel_plain(pq), 3),
        library_ms=cuda_ms(lambda: torch.geqrf(pq), 10),
        **bound_of(flops.qr_flops(4096, 128), 2 * 4096 * 128 * 4 + 128 * 4))

    # llt_leaf: SPD blocks (cond ≤ 5) and one regularized ragged block with
    # delta = 1, where the identity padding's unit pivots must not count;
    # tolerance 8·b·eps relative to max|L|
    errs = []
    for b, reg in ((128, False), (80, False), (44, False), (44, True)):
        if reg:
            bad = torch.tensor([3, 20, 43], device=DEV)
            a, eps, delta = _regularized_spd(b, bad, gen), 1.0, 1.0
        else:
            a, eps, delta = _spd(b, gen), 0.0, 0.0
        (l1, c1, o1), (l2, c2, o2) = (llt_leaf(a, eps=eps, delta=delta),
                                      llt_leaf_plain(a, eps=eps, delta=delta))
        torch.cuda.synchronize()
        tol = 8 * b * EPS32
        err, rel = _max_rel(l1, l2)
        errs.append(err)
        want = (3, False) if reg else (0, True)
        check(rel <= tol and (int(c1), bool(o1)) == (int(c2), bool(o2)) == want,
              f"llt_leaf ({b}, {b}){' eps=1 delta=1' if reg else ''}: max abs "
              f"err {err:.3e}, rel {rel:.3e} <= tol {tol:.3e}, count {int(c1)}, "
              f"ok {bool(o1)}")
    blk = _spd(128, gen)
    res["llt_leaf"] = dict(
        max_abs_err=max(errs), ms=cuda_ms(lambda: llt_leaf(blk), 50),
        plain_ms=cuda_ms(lambda: llt_leaf_plain(blk), 3),
        library_ms=cuda_ms(lambda: torch.linalg.cholesky_ex(blk), 50),
        **bound_of(128 ** 3 / 3, 2 * 128 * 128 * 4))

    # lu_leaf: separated pivots, so perm must match exactly; packed within
    # 8·m·eps relative to max|packed|
    errs = []
    for m, b in ((4000, 256), (1000, 64), (44, 44)):
        pan = _separated_panel(m, b, gen)
        (k1, p1, n1, o1), (k2, p2, n2, o2) = lu_leaf(pan), lu_leaf_plain(pan)
        torch.cuda.synchronize()
        tol = 8 * m * EPS32
        err, rel = _max_rel(k1, k2)
        errs.append(err)
        check(bool((p1 == p2).all()) and int(n1) == int(n2) and bool(o1)
              and bool(o2) and rel <= tol,
              f"lu_leaf ({m}, {b}): perm equal {bool((p1 == p2).all())}, nt "
              f"{int(n1)} vs {int(n2)}, ok {bool(o1)}, max abs err {err:.3e}, "
              f"rel {rel:.3e} <= tol {tol:.3e}")
    pan = torch.randn(4000, 256, generator=gen, device=DEV)
    res["lu_leaf"] = dict(
        max_abs_err=max(errs), ms=cuda_ms(lambda: lu_leaf(pan), 10),
        plain_ms=cuda_ms(lambda: lu_leaf_plain(pan), 3),
        library_ms=cuda_ms(lambda: torch.linalg.lu_factor_ex(pan), 10),
        **bound_of(flops.lu_flops(4000, 256), 2 * 4000 * 256 * 4 + 4000 * 8))
    res.update(_lu_panel_family(gen))
    res.update(_sweep_kernels(gen))
    res.update(_tile_kernels(gen))
    for name, r in res.items():
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
        print(f"time {name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} "
              f"ms, library {lib}, bound {r['bound_ms']:.6g} ms ({r['bound_by']})")
    return res


def _lu_rec(a, packed, perm) -> float:
    """‖A[perm] − L·U‖ / ‖A‖ of a packed (m, b) panel factor, m ≥ b."""
    m, b = a.shape
    lo = torch.tril(packed, -1) + torch.eye(m, b, device=DEV)
    return rel_norm(lo @ torch.triu(packed[:b]), a[perm])


def _lu_panel_family(gen) -> dict:
    """``lu_panel_v2`` (one panel, and a batch in one launch), ``lu_panel_v3``
    and ``lu_panel_swap`` against their plain versions on separated pivots:
    perm, nt and ok exactly, packed within 8·m·eps of its largest entry, and
    ‖A[perm] − LU‖/‖A‖ ≤ 8·m·eps. Shapes: the CALU group (4096, 256), 16 of
    them in one batched launch, the v1 kernel's measured shape (4096, 128),
    and ragged (1000, 100) panels. Timed on Gaussian panels beside
    ``torch.linalg.lu_factor_ex`` on the same panel (or the same batch)."""
    from faer_tpu_torch.ops.kernels.lu_panel_swap import lu_panel_swap, lu_panel_swap_plain
    from faer_tpu_torch.ops.kernels.lu_panel_v2 import (
        lu_panel_v2, lu_panel_v2_batched, lu_panel_v2_batched_plain, lu_panel_v2_plain)
    from faer_tpu_torch.ops.kernels.lu_panel_v3 import lu_panel_v3, lu_panel_v3_plain
    from faer_tpu_torch.utils import flops

    def held(name, k1, p1, n1, o1, k2, p2, n2, o2, a) -> float:
        m, b = a.shape
        tol = 8 * m * EPS32
        err, rel = _max_rel(k1, k2)
        rec = _lu_rec(a, k1, p1)
        same = bool((p1 == p2).all())
        check(same and int(n1) == int(n2) and bool(o1) and bool(o2) and rel <= tol
              and rec <= tol,
              f"{name} ({m}, {b}): perm equal {same}, nt {int(n1)} vs {int(n2)}, ok "
              f"{bool(o1)}, max abs err {err:.3e}, rel {rel:.3e}, bitwise equal "
              f"{torch.equal(k1, k2)}; |A[perm]-LU|/|A| {rec:.3e}; <= tol {tol:.3e}")
        return err

    def bound(g, m, b):
        return bound_of(g * flops.lu_flops(m, b), g * (2 * m * b * 4 + m * 8))

    res = {}
    for name, kern, plain, shapes in (
            ("lu_panel_v2", lu_panel_v2, lu_panel_v2_plain, ((4096, 256), (1000, 100))),
            ("lu_panel_v3", lu_panel_v3, lu_panel_v3_plain, ((4096, 256), (1000, 100))),
            ("lu_panel_swap", lu_panel_swap, lu_panel_swap_plain,
             ((4096, 128), (1000, 100)))):
        errs = []
        for m, b in shapes:
            a = _separated_panel(m, b, gen)
            out1, out2 = kern(a), plain(a)
            torch.cuda.synchronize()
            errs.append(held(name, *out1, *out2, a))
        m, b = shapes[0]
        pan = torch.randn(m, b, generator=gen, device=DEV)
        res[name] = dict(
            max_abs_err=max(errs), ms=cuda_ms(lambda: kern(pan), 10),
            plain_ms=cuda_ms(lambda: plain(pan), 3),
            library_ms=cuda_ms(lambda: torch.linalg.lu_factor_ex(pan), 10),
            **bound(1, m, b))

    # the batch: each panel held against its plain version, and equal to the
    # one-panel launch to the bit (the same arithmetic on every row)
    for g, m, b in ((16, 4096, 256), (5, 1000, 100)):
        stack = torch.stack([_separated_panel(m, b, gen) for _ in range(g)])
        got, want = lu_panel_v2_batched(stack), lu_panel_v2_batched_plain(stack)
        torch.cuda.synchronize()
        errs = [held(f"lu_panel_v2_batched [{q}]", *(x[q] for x in got),
                     *(x[q] for x in want), stack[q]) for q in range(g)]
        one = [lu_panel_v2(stack[q]) for q in range(g)]
        bitwise = all(torch.equal(x[q], y) for q in range(g) for x, y in zip(got, one[q]))
        check(bitwise, f"lu_panel_v2_batched {g} x ({m}, {b}): one launch equals "
                       f"lu_panel_v2 on each panel to the bit; max abs err vs plain "
                       f"{max(errs):.3e}")
        res["lu_panel_v2"]["max_abs_err"] = max(res["lu_panel_v2"]["max_abs_err"], *errs)
    from faer_tpu_torch.ops.kernels.lu_panel import batched_grid

    for g, m in ((1, 4096), (16, 4096), (1, 40000), (1, 65536), (16, 1000)):
        ctas, rpc = batched_grid(g, m, 256, DEV)
        print(f"lu_panel_batched grid for {g} x ({m}, 256): {ctas} CTAs a panel, "
              f"{rpc} rows ({rpc} KiB) each")
    stack = torch.randn(16, 4096, 256, generator=gen, device=DEV)
    ms = cuda_ms(lambda: lu_panel_v2_batched(stack), 10)
    plain_ms = cuda_ms(lambda: lu_panel_v2_batched_plain(stack), 1, warmup=0)
    lib_ms = cuda_ms(lambda: torch.linalg.lu_factor_ex(stack), 10)
    bnd = bound(16, 4096, 256)
    print(f"time lu_panel_v2_batched 16 x (4096, 256): kernel {ms:.4f} ms (one "
          f"panel alone {res['lu_panel_v2']['ms']:.4f} ms), plain {plain_ms:.4f} ms, "
          f"lu_factor_ex (batched) {lib_ms:.4f} ms, bound {bnd['bound_ms']:.6g} ms "
          f"({bnd['bound_by']})")
    return res


def _sweep_case(n: int, l: int, m: int, bidiag: bool, gen):
    """(d, e, lm, mu) of one sweep on block [l, m] with the driver's shift."""
    from faer_tpu_torch.linalg.bidiag_svd import _shift
    from faer_tpu_torch.linalg.tridiag_evd import _wilkinson_shift

    d = torch.randn(n, generator=gen, device=DEV) + (2.0 if bidiag else 0.0)
    e = torch.randn(n - 1, generator=gen, device=DEV)
    mu = _shift(d, e, m) if bidiag else _wilkinson_shift(d[m - 1], e[m - 1], d[m])
    lm = torch.tensor([l, m], dtype=torch.int32, device=DEV)
    return d, e, lm, mu.reshape(1)


def _sweep_kernels(gen) -> dict:
    """``tridiag_sweep`` and ``bidiag_sweep`` against their plain versions at
    the D&C leaf shape (64), the direct route (384) and a length whose d and
    e do not fit the 48 KB of shared memory (8192: global memory), each on
    an inner block (l > 0, m < n−1); timed at a full leaf sweep (0, 63) by
    graph replay (``graph_ms``)."""
    from faer_tpu_torch.ops.kernels import sweep

    res = {}
    for name, bidiag, n_rot in (("tridiag_sweep", False, 2), ("bidiag_sweep", True, 4)):
        kern, plain = getattr(sweep, name), getattr(sweep, f"{name}_plain")
        errs = []
        for n, l, m in ((64, 5, 60), (384, 7, 370), (8192, 3, 8000)):
            args = _sweep_case(n, l, m, bidiag, gen)
            got, want = kern(*args), plain(*args)
            torch.cuda.synchronize()
            # the two round alike (same operations in the same order), so
            # they should agree to the bit; the tolerance is faer's 8·n·eps
            # relative to the largest |d|, |e| (≥ 1: c and s are ≤ 1)
            scale = max(1.0, args[0].abs().max().item(), args[1].abs().max().item())
            tol = 8 * n * EPS32 * scale
            err = max((g - w).abs().max().item() for g, w in zip(got, want))
            same = all(torch.equal(g, w) for g, w in zip(got, want))
            outside = all(bool((r[:l] == v).all() and (r[m:] == v).all())
                          for r, v in zip(got[2:], (1.0, 0.0) * 2))
            errs.append(err)
            check(err <= tol and outside,
                  f"{name} n={n} (l, m) = ({l}, {m}) "
                  f"[{'shared' if n <= 6144 else 'global'} memory]: max abs err "
                  f"{err:.3e} <= tol {tol:.3e}, bitwise equal {same}, "
                  f"rotations identity outside [l, m) {outside}")
        # the kernel's device time (graph replay) and the wrapper's time per
        # call as a driver sees it (CUDA events around each call: host-bound)
        full = {n: _sweep_case(n, 0, n - 1, bidiag, gen) for n in (64, 384)}
        ms = {n: graph_ms(lambda a=a: kern(*a), 50) for n, a in full.items()}
        per_step = (ms[384] - ms[64]) / (383 - 63) * 1e3
        print(f"time {name}: device {ms[64]:.4f} ms (64 steps), {ms[384]:.4f} ms "
              f"(384 steps): chain latency {per_step:.4f} us per step; wrapper "
              f"call {cuda_ms(lambda: kern(*full[64]), 50):.4f} ms")
        n = 64
        nbytes = (2 * n + 2 * (n - 1) + n_rot * (n - 1) + 3) * 4
        res[name] = dict(
            max_abs_err=max(errs), ms=ms[64],
            plain_ms=cuda_ms(lambda: plain(*full[64]), 3),
            library_ms=None,  # no PyTorch call computes one sweep
            **bound_of(SWEEP_STEP_FLOPS * (n - 1), nbytes))
    return res


def _row_col_scale(a, b) -> float:
    """max_i ‖a_i‖₂ · max_j ‖b_j‖₂, a bound on every (|A||B|)_ij."""
    return (a.float().norm(dim=1).max() * b.float().norm(dim=0).max()).item()


def _tile_kernels(gen) -> dict:
    """``tile_matmul`` in its three modes (f32 "highest" and "high", bf16)
    and ``syrk_lower_sub`` in its two, against their plain versions: the
    GEMM at 4096³ (the facade's product), a ragged (3000, 1000)·(1000, 2050),
    both with transposed (strided) operands, and the main path's thin
    products (a QR block apply Vᵀ·B, an 8-column TRSM update, an LLT
    trailing update); the SYRK at (3840, 256), the trailing update of a 4096
    LLT at block 256, and a ragged (300, 200). Limits ``F32_TOL`` and
    ``BF16X3_TOL``; bf16x3 is also held against f64, and a bf16 result
    against the plain f32 one, past one bf16 rounding of each entry. Timed
    at 4096³ and (3840, 256)."""
    from faer_tpu_torch.core.config import config
    from faer_tpu_torch.ops.kernels.matmul import tile_matmul, tile_matmul_plain
    from faer_tpu_torch.ops.kernels.syrk import syrk_lower_sub, syrk_lower_sub_plain

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=DEV)

    n = N
    a, b = randn(n, n), randn(n, n)
    ar, br = randn(3000, 1000), randn(1000, 2050)
    v, w = randn(n, TILE), randn(n - 256, 256)
    cases = {f"{n}^3": (a, b), "(3000, 1000)·(1000, 2050)": (ar, br),
             f"{n}^3 .mT operands": (b.mT, a.mT),
             "(2050, 1000)·(1000, 3000) .mT operands": (br.mT, ar.mT),
             f"QR apply (128, {n})·({n}, {n - TILE}), .mT lhs": (v.mT, randn(n, n - TILE)),
             f"TRSM update ({n - TILE}, 128)·(128, 8)": (randn(n - TILE, TILE), randn(TILE, 8)),
             f"LLT update ({n - 256}, 256)·(256, {n - 256}), .mT rhs": (w, w.mT)}
    errs, timed = [], {}
    for mode in ("highest", "high", "bf16"):
        config.f32_precision = "highest" if mode == "bf16" else mode
        lim = BF16X3_TOL if mode == "high" else F32_TOL
        for label, (x, y) in cases.items():
            if mode == "bf16":
                x, y = x.bfloat16(), y.bfloat16()
            outs = (torch.float32, torch.bfloat16) if mode == "bf16" else (torch.float32,)
            want = tile_matmul_plain(x, y, out_dtype=torch.float32)
            scale = _row_col_scale(x, y)
            for out in outs:
                got = tile_matmul(x, y, out_dtype=out)
                torch.cuda.synchronize()
                diff = (got.float() - want).abs()
                if out == torch.bfloat16:  # what exceeds one bf16 rounding of C
                    diff = (diff - 2.0 ** -8 * want.abs()).clamp_min(0)
                err = diff.max().item() / scale
                if mode == "highest":
                    errs.append(err * scale)
                msg = f"{err:.3e} of max|a_i||b_j| vs plain"
                ok = err <= lim
                if mode == "high":
                    err64 = (got.double() - x.double() @ y.double()).abs().max().item() / scale
                    msg += f", {err64:.3e} vs f64"
                    ok = ok and err64 <= lim
                if out == torch.bfloat16:
                    msg += " beyond one bf16 rounding"
                check(ok, f"tile_matmul {mode} {label} -> {str(out)[6:]}: max abs err "
                          f"{msg} <= {lim:.3e}")
        x, y = cases[f"{n}^3"]
        if mode == "bf16":
            x, y = x.bfloat16(), y.bfloat16()
        flops = 2 * n ** 3
        nbytes = (2 * n * n) * x.element_size() + n * n * 4
        peak = PEAK_F32_FLOPS if mode == "highest" else PEAK_BF16_FLOPS
        passes = 3 if mode == "high" else 1
        timed[mode] = dict(
            ms=cuda_ms(lambda: tile_matmul(x, y), 10),
            plain_ms=cuda_ms(lambda: tile_matmul_plain(x, y), 3),
            library_ms=cuda_ms(lambda: torch.matmul(x, y), 10),
            **bound_of(passes * flops, nbytes, peak))
        r = timed[mode]
        print(f"time tile_matmul {mode} {n}^3: kernel {r['ms']:.4f} ms "
              f"({flops / r['ms'] / 1e9:.2f} TFLOP/s), plain {r['plain_ms']:.4f} ms, "
              f"torch.matmul {r['library_ms']:.4f} ms, bound {r['bound_ms']:.6g} ms "
              f"({r['bound_by']}, {passes} pass{'es' if passes > 1 else ''})")
    res = {"matmul": dict(max_abs_err=max(errs), **timed["highest"])}

    errs, timed = [], {}
    for mode in ("highest", "high"):
        config.f32_precision = mode
        tol = BF16X3_TOL if mode == "high" else F32_TOL
        for m, k in ((n - 256, 256), (300, 200)):
            c, x = randn(m, m), randn(m, k)
            got, want = syrk_lower_sub(c, x), syrk_lower_sub_plain(c, x)
            torch.cuda.synchronize()
            scale = x.norm(dim=1).max().item() ** 2
            err = torch.tril(got - want).abs().max().item() / scale
            kept = torch.equal(torch.triu(got, 1), torch.triu(c, 1))
            if mode == "highest":
                errs.append(err * scale)
            msg = f"{err:.3e} of max|a_i|² vs plain"
            ok = err <= tol and kept
            if mode == "high":
                ref = c.double() - x.double() @ x.double().mT
                err64 = torch.tril(got.double() - ref).abs().max().item() / scale
                msg += f", {err64:.3e} vs f64"
                ok = ok and err64 <= tol
            check(ok, f"syrk_lower_sub {mode} ({m}, {k}): lower max abs err {msg} "
                      f"<= {tol:.3e}; upper triangle kept C's values {kept}")
            if m != n - 256:
                continue
            # the function's work: the lower triangle with its diagonal,
            # m(m+1)/2 dot products of length k, read and written once, and A
            passes = 3 if mode == "high" else 1
            peak = PEAK_BF16_FLOPS if mode == "high" else PEAK_F32_FLOPS
            timed[mode] = dict(
                ms=cuda_ms(lambda: syrk_lower_sub(c, x), 20),
                plain_ms=cuda_ms(lambda: syrk_lower_sub_plain(c, x), 5),
                library_ms=cuda_ms(lambda: torch.addmm(c, x, x.mT, alpha=-1), 20),
                **bound_of(passes * m * (m + 1) * k, (m * (m + 1) + m * k) * 4, peak))
            r = timed[mode]
            print(f"time syrk_lower_sub {mode} ({m}, {k}): kernel {r['ms']:.4f} ms, "
                  f"plain {r['plain_ms']:.4f} ms, torch.addmm {r['library_ms']:.4f} ms, "
                  f"bound {r['bound_ms']:.6g} ms ({r['bound_by']}, {passes} "
                  f"pass{'es' if passes > 1 else ''})")
    config.f32_precision = "highest"
    res["syrk"] = dict(max_abs_err=max(errs), **timed["highest"])
    return res


def _inputs(n: int, gen):
    a_spd = _spd(n, gen)
    g = torch.randn(n, n, generator=gen, device=DEV)
    b = torch.randn(n, 8, generator=gen, device=DEV)
    return a_spd, g, b


def phase_flagship(gen) -> dict:
    from faer_tpu_torch import (
        llt_factor, llt_reconstruct, llt_solve, lu_in_place, lu_reconstruct,
        lu_solve)
    from faer_tpu_torch.core.config import launch_counts, reset_launch_counts
    from faer_tpu_torch.entry import flagship_step
    from faer_tpu_torch.utils import flops

    n = N
    a_spd, g, b = _inputs(n, gen)
    torch.cuda.synchronize()
    reset_launch_counts()
    x, success = flagship_step(a_spd, g, b)
    torch.cuda.synchronize()
    counts = launch_counts()
    print(f"launches in flagship_step: {counts}")
    check(counts["llt_panel"] == n // 256 and counts["lu_panel"] == n // 256
          and counts["trtri"] > 0,
          f"llt_panel and lu_panel ran {n // 256} times each, trtri ran")
    check(tuple(x.shape) == (n, 8) and bool(torch.isfinite(x).all())
          and bool(success), "flagship output finite, shape (n, 8), success")

    bound = 8 * n * EPS32
    l, info = llt_factor(a_spd)
    lu, perm, linfo = lu_in_place(g)
    rec_llt = (torch.linalg.matrix_norm(llt_reconstruct(l) - a_spd)
               / torch.linalg.matrix_norm(a_spd)).item()
    rec_lu = (torch.linalg.matrix_norm(lu_reconstruct(lu, perm) - g)
              / torch.linalg.matrix_norm(g)).item()
    check(rec_llt <= bound, f"|LL^T - A|/|A| = {rec_llt:.3e} <= {bound:.3e}")
    check(rec_lu <= bound, f"|A[perm] - LU|/|A| = {rec_lu:.3e} <= {bound:.3e}")
    x1, x2 = llt_solve(l, b), lu_solve(lu, perm, b)
    for name, mat, xs in (("llt", a_spd, x1), ("lu", g, x2)):
        res = (torch.linalg.matrix_norm(mat @ xs - b)
               / (torch.linalg.matrix_norm(mat) * torch.linalg.matrix_norm(xs))).item()
        check(res <= bound, f"{name} solve |Ax-b|/(|A||x|) = {res:.3e} <= {bound:.3e}")
    dx = (torch.linalg.matrix_norm(x - (x1 + x2))
          / torch.linalg.matrix_norm(x1 + x2)).item()
    check(dx <= bound, f"flagship x vs separate solves: rel diff {dx:.3e}")

    # reference check at n = 1024 against an f64 oracle on the card
    a_s, g_s, b_s = _inputs(1024, gen)
    xs, _ = flagship_step(a_s, g_s, b_s)
    a64, g64, b64 = a_s.double(), g_s.double(), b_s.double()
    x_ref = torch.linalg.solve(a64, b64) + torch.linalg.solve(g64, b64)
    kappa = max(torch.linalg.cond(a64).item(), torch.linalg.cond(g64).item())
    err = (torch.linalg.matrix_norm(xs.double() - x_ref)
           / torch.linalg.matrix_norm(x_ref)).item()
    tol = 8 * 1024 * EPS32 * kappa
    check(err <= tol, f"n=1024 flagship vs f64 oracle: rel err {err:.3e} <= "
                      f"8 n eps cond = {tol:.3e}")

    t = {
        "llt_factor": cuda_ms(lambda: llt_factor(a_spd), 5),
        "lu_in_place": cuda_ms(lambda: lu_in_place(g), 5),
        "llt_solve": cuda_ms(lambda: llt_solve(l, b), 5),
        "lu_solve": cuda_ms(lambda: lu_solve(lu, perm, b), 5),
    }
    fl = {"llt_factor": flops.llt_flops(n), "lu_in_place": flops.lu_flops(n, n),
          "llt_solve": 2 * flops.trsm_flops(n, 8),
          "lu_solve": 2 * flops.trsm_flops(n, 8)}
    for k, ms in t.items():
        print(f"time {k} n={n}: {ms:.4f} ms, {fl[k] / ms / 1e6:.1f} GFLOP/s")
    print(f"library cholesky_ex n={n}: "
          f"{cuda_ms(lambda: torch.linalg.cholesky_ex(a_spd), 5):.4f} ms, "
          f"lu_factor_ex: {cuda_ms(lambda: torch.linalg.lu_factor_ex(g), 5):.4f} ms")
    return counts


def phase_qr(gen) -> dict:
    """The QR path as ``bench.py`` drives it: ``qr_in_place``, then
    ``qr_solve_lstsq``."""
    from faer_tpu_torch import (
        qr_compute_q, qr_in_place, qr_reconstruct, qr_solve_lstsq)
    from faer_tpu_torch.core.config import launch_counts, reset_launch_counts
    from faer_tpu_torch.utils import flops

    n = N
    a = torch.randn(n, n, generator=gen, device=DEV)
    b = torch.randn(n, 8, generator=gen, device=DEV)
    torch.cuda.synchronize()
    reset_launch_counts()
    packed, ts, block = qr_in_place(a)
    x = qr_solve_lstsq(packed, ts, block, b)
    torch.cuda.synchronize()
    counts = launch_counts()
    print(f"launches in qr_in_place + qr_solve_lstsq: {counts}")
    check(counts["qr_panel"] == n // 128 and counts["trtri"] == QR_TRTRI
          and counts["llt_panel"] == counts["lu_panel"] == 0,
          f"qr_panel ran {n // 128} times (one per 128-wide leaf), trtri "
          f"{QR_TRTRI} times (64 in the T factors, 32 in the R solve)")
    tol = 8 * n * EPS32
    rec = rel_norm(qr_reconstruct(packed, ts, block), a)
    q = qr_compute_q(packed, ts, block)
    orth = (q.T @ q - torch.eye(n, device=DEV)).abs().max().item()
    res = (torch.linalg.matrix_norm(a @ x - b) / (
        torch.linalg.matrix_norm(a) * torch.linalg.matrix_norm(x))).item()
    check(tuple(packed.shape) == (n, n) and tuple(ts.shape) == (n // block, block, block)
          and bool(torch.isfinite(packed).all()), "QR output finite, of the expected shapes")
    check(rec <= tol, f"|QR - A|/|A| = {rec:.3e} <= {tol:.3e}")
    check(orth <= tol, f"max|QᵀQ - I| = {orth:.3e} <= {tol:.3e}")
    check(res <= tol, f"qr_solve_lstsq |Ax-b|/(|A||x|) = {res:.3e} <= {tol:.3e}")

    # tall least squares, 8192 × 2048: the residual is orthogonal to the
    # columns (Frobenius norms, an upper bound on the 2-norms)
    mt, nt_ = 8192, 2048
    at = torch.randn(mt, nt_, generator=gen, device=DEV)
    bt = torch.randn(mt, 8, generator=gen, device=DEV)
    pt, tst, blt = qr_in_place(at)
    xt = qr_solve_lstsq(pt, tst, blt, bt)
    r = bt - at @ xt
    orth_r = (torch.linalg.matrix_norm(at.T @ r) / (
        torch.linalg.matrix_norm(at) * torch.linalg.matrix_norm(r))).item()
    tol_t = 8 * mt * EPS32
    check(orth_r <= tol_t, f"lstsq {mt}x{nt_}: |Aᵀr|/(|A||r|) = {orth_r:.3e} "
                           f"<= {tol_t:.3e}")
    # tall-skinny least squares, 65536 × 512: its 128-wide leaves have about
    # 497 rows per CTA (250 KiB), more than shared memory holds
    ms2, ns2 = 65536, 512
    a2 = torch.randn(ms2, ns2, generator=gen, device=DEV)
    b2 = torch.randn(ms2, 8, generator=gen, device=DEV)
    p2, ts2, bl2 = qr_in_place(a2)
    r2 = b2 - a2 @ qr_solve_lstsq(p2, ts2, bl2, b2)
    orth_r2 = (torch.linalg.matrix_norm(a2.T @ r2) / (
        torch.linalg.matrix_norm(a2) * torch.linalg.matrix_norm(r2))).item()
    check(orth_r2 <= 8 * ms2 * EPS32,
          f"lstsq {ms2}x{ns2}: |Aᵀr|/(|A||r|) = {orth_r2:.3e} <= "
          f"{8 * ms2 * EPS32:.3e}")
    # against an f64 least-squares solve at 2048 × 512: forward error within
    # 8·m·eps·κ², the sensitivity of a least-squares problem with a residual
    ms_, ns_ = 2048, 512
    a_s = torch.randn(ms_, ns_, generator=gen, device=DEV)
    b_s = torch.randn(ms_, 8, generator=gen, device=DEV)
    p_s, t_s, bl_s = qr_in_place(a_s)
    x_s = qr_solve_lstsq(p_s, t_s, bl_s, b_s).double()
    x64 = torch.linalg.lstsq(a_s.double(), b_s.double()).solution
    kappa = torch.linalg.cond(a_s.double()).item()
    err = rel_norm(x_s, x64)
    tol_s = 8 * ms_ * EPS32 * kappa ** 2
    check(err <= tol_s, f"lstsq {ms_}x{ns_} vs f64: rel err {err:.3e} <= "
                        f"8 m eps cond² = {tol_s:.3e}")

    t = {
        f"qr_in_place n={n}": (cuda_ms(lambda: qr_in_place(a), 3), flops.qr_flops(n, n)),
        f"qr_solve_lstsq n={n} (8 rhs)": (
            cuda_ms(lambda: qr_solve_lstsq(packed, ts, block, b), 5),
            2 * flops.matmul_flops(n, 8, n) + flops.trsm_flops(n, 8)),
        f"qr_in_place {mt}x{nt_}": (cuda_ms(lambda: qr_in_place(at), 3),
                                    flops.qr_flops(mt, nt_)),
        f"qr_solve_lstsq {mt}x{nt_} (8 rhs)": (
            cuda_ms(lambda: qr_solve_lstsq(pt, tst, blt, bt), 5),
            2 * flops.matmul_flops(mt, 8, nt_) + flops.trsm_flops(nt_, 8)),
        f"qr_in_place {ms2}x{ns2}": (cuda_ms(lambda: qr_in_place(a2), 3),
                                     flops.qr_flops(ms2, ns2)),
    }
    for k, (ms, fl) in t.items():
        print(f"time {k}: {ms:.4f} ms, {fl / ms / 1e6:.1f} GFLOP/s")
    print(f"library geqrf n={n}: {cuda_ms(lambda: torch.geqrf(a), 3):.4f} ms, "
          f"{mt}x{nt_}: {cuda_ms(lambda: torch.geqrf(at), 3):.4f} ms, "
          f"{ms2}x{ns2}: {cuda_ms(lambda: torch.geqrf(a2), 3):.4f} ms")
    return counts


def phase_off_route(gen) -> dict:
    """``llt_factor`` and ``lu_in_place`` on shapes off the fused route:
    the recursive drivers and their ``llt_leaf`` / ``lu_leaf`` kernels.
    Each factorization is counted on its own; the counts are summed."""
    from faer_tpu_torch import llt_factor, llt_reconstruct, lu_in_place, lu_reconstruct
    from faer_tpu_torch.core.config import launch_counts, reset_launch_counts
    from faer_tpu_torch.utils import flops

    total = {}
    for n, leaves in LLT_LEAVES.items():
        a = _spd(n, gen)
        torch.cuda.synchronize()
        reset_launch_counts()
        l, info = llt_factor(a)
        torch.cuda.synchronize()
        counts = launch_counts()
        total = {k: total.get(k, 0) + v for k, v in counts.items()}
        rec = rel_norm(llt_reconstruct(l), a)
        tol = 8 * n * EPS32
        check(counts["llt_leaf"] == leaves and counts["llt_panel"] == 0
              and bool(info.success) and rec <= tol,
              f"llt_factor n={n}: launches {counts}, |LLᵀ-A|/|A| = {rec:.3e} "
              f"<= {tol:.3e}")
        ms = cuda_ms(lambda: llt_factor(a), 3)
        print(f"time llt_factor n={n}: {ms:.4f} ms, "
              f"{flops.llt_flops(n) / ms / 1e6:.1f} GFLOP/s; library cholesky_ex "
              f"{cuda_ms(lambda: torch.linalg.cholesky_ex(a), 3):.4f} ms")
    for (m, n), leaves in LU_LEAVES.items():
        g = torch.randn(m, n, generator=gen, device=DEV)
        torch.cuda.synchronize()
        reset_launch_counts()
        lu, perm, info = lu_in_place(g)
        torch.cuda.synchronize()
        counts = launch_counts()
        total = {k: total.get(k, 0) + v for k, v in counts.items()}
        rec = rel_norm(lu_reconstruct(lu, perm), g)
        tol = 8 * max(m, n) * EPS32
        check(counts["lu_leaf"] == leaves and counts["lu_panel"] == 0
              and tuple(lu.shape) == (m, n) and bool(info.success) and rec <= tol,
              f"lu_in_place {m}x{n}: launches {counts}, |A[perm]-LU|/|A| = "
              f"{rec:.3e} <= {tol:.3e}")
        ms = cuda_ms(lambda: lu_in_place(g), 3)
        print(f"time lu_in_place {m}x{n}: {ms:.4f} ms, "
              f"{flops.lu_flops(m, n) / ms / 1e6:.1f} GFLOP/s; library "
              f"lu_factor_ex {cuda_ms(lambda: torch.linalg.lu_factor_ex(g), 3):.4f} ms")
    print(f"launches in the off-route factorizations: {total}")
    return total


def _timed(fn, label: str, flops: float | None = None) -> float:
    """One call to warm up (host clock), then the median of 3 by CUDA
    events; a call that took more than SPECTRAL_SLOW_S is not repeated:
    its host-clock time, which ends in a synchronize, is the time."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    if first > SPECTRAL_SLOW_S:
        ms, how = first * 1e3, "one call, host clock"
    else:
        ms, how = cuda_ms(fn, 3, warmup=0), "median of 3"
    rate = "" if flops is None else f", {flops / ms / 1e6:.1f} GFLOP/s"
    print(f"time {label}: {ms:.4f} ms ({how}){rate}")
    return ms


def _evd_checks(a, w, v, label: str) -> None:
    n = a.shape[0]
    tol = 8 * n * EPS32
    res = (torch.linalg.matrix_norm(a @ v - v * w[None, :])
           / torch.linalg.matrix_norm(a)).item()
    orth = (v.T @ v - torch.eye(n, device=DEV)).abs().max().item()
    check(tuple(w.shape) == (n,) and tuple(v.shape) == (n, n)
          and bool(torch.isfinite(v).all()) and bool((w[1:] >= w[:-1]).all()),
          f"{label}: finite, of the expected shapes, ascending")
    check(res <= tol and orth <= tol,
          f"{label}: |AV - VΛ|/|A| = {res:.3e}, max|VᵀV - I| = {orth:.3e}, "
          f"both <= {tol:.3e}")


def _svd_checks(a, u, s, v, label: str) -> None:
    m, n = a.shape
    k = min(m, n)
    tol = 8 * max(m, n) * EPS32
    res = rel_norm((u * s[None, :]) @ v.T, a)
    eye = torch.eye(k, device=DEV)
    orth_u = (u.T @ u - eye).abs().max().item()
    orth_v = (v.T @ v - eye).abs().max().item()
    check(tuple(u.shape) == (m, k) and tuple(v.shape) == (n, k)
          and bool(torch.isfinite(u).all()) and bool((s[:-1] >= s[1:]).all())
          and bool((s >= 0).all()),
          f"{label}: finite, of the expected shapes, s descending ≥ 0")
    check(res <= tol and orth_u <= tol and orth_v <= tol,
          f"{label}: |U diag(s) Vᵀ - A|/|A| = {res:.3e}, max|UᵀU - I| = "
          f"{orth_u:.3e}, max|VᵀV - I| = {orth_v:.3e}, all <= {tol:.3e}")


def device_ms(fn) -> float:
    """The card's busy time in one call of ``fn``, in ms: the sum of the
    kernel spans ``torch.profiler`` records (one stream, so they do not
    overlap). Beside the call's wall time it gives the device's busy share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == DeviceType.CUDA) / 1e3


def _counted(fn):
    """Run ``fn`` with every counter set to 0 just before and read just
    after: (result, launch counts, host reads)."""
    from faer_tpu_torch.core.config import host_reads, launch_counts, reset_launch_counts

    torch.cuda.synchronize()
    reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, launch_counts(), host_reads()


def phase_spectral(gen) -> dict:
    """The spectral path as ``tools/bench_spectral.py`` drives it:
    ``self_adjoint_evd((g + gᵀ)/2)`` and ``svd(g)``."""
    from faer_tpu_torch import (
        self_adjoint_eigenvalues, self_adjoint_evd, singular_values, svd)
    from faer_tpu_torch.linalg.bidiag import (
        bidiag_apply_ql, bidiag_apply_qr_mat, bidiag_in_place)
    from faer_tpu_torch.linalg.bidiag_svd import bidiag_svd
    from faer_tpu_torch.linalg.tridiag import tridiag_apply_q, tridiag_in_place
    from faer_tpu_torch.linalg.tridiag_evd import tridiag_evd
    from faer_tpu_torch.utils import flops

    total = {}

    def add(counts):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v

    n = N
    g = torch.randn(n, n, generator=gen, device=DEV)
    a = (g + g.T) / 2
    (w, v, info), counts, reads = _counted(lambda: self_adjoint_evd(a))
    add(counts)
    print(f"launches in self_adjoint_evd n={n}: {counts}; host reads {reads}; "
          f"info converged {bool(info.converged)}, iterations {int(info.iterations)}")
    check(counts["tridiag_sweep"] > 0 and bool(info.converged),
          f"self_adjoint_evd n={n} ran tridiag_sweep {counts['tridiag_sweep']} times")
    _evd_checks(a, w, v, f"self_adjoint_evd n={n}")
    (u, s, vs, sinfo), counts, reads = _counted(lambda: svd(g))
    add(counts)
    print(f"launches in svd n={n}: {counts}; host reads {reads}; "
          f"info converged {bool(sinfo.converged)}, iterations {int(sinfo.iterations)}")
    check(counts["bidiag_sweep"] > 0 and bool(sinfo.converged),
          f"svd n={n} ran bidiag_sweep {counts['bidiag_sweep']} times")
    _svd_checks(g, u, s, vs, f"svd n={n}")

    # eigenvalues and singular values against an f64 oracle on the card
    n1 = ORACLE_N
    g1 = torch.randn(n1, n1, generator=gen, device=DEV)
    a1 = (g1 + g1.T) / 2
    tol1 = 8 * n1 * EPS32
    w64 = torch.linalg.eigvalsh(a1.double())
    err_w = ((self_adjoint_eigenvalues(a1).double() - w64).abs().max()
             / w64.abs().max()).item()
    s64 = torch.linalg.svdvals(g1.double())
    err_s = ((singular_values(g1).double() - s64).abs().max() / s64[0]).item()
    check(err_w <= tol1 and err_s <= tol1,
          f"n={n1} vs f64 oracle: eigenvalues max err {err_w:.3e}, singular "
          f"values {err_s:.3e} (relative to the largest), both <= {tol1:.3e}")

    # the direct QR-iteration route (n < 512): the kernels sweep the full n
    n2 = DIRECT_N
    g2 = torch.randn(n2, n2, generator=gen, device=DEV)
    a2 = (g2 + g2.T) / 2
    (w2, v2, _), counts, reads = _counted(lambda: self_adjoint_evd(a2))
    add(counts)
    print(f"launches in self_adjoint_evd n={n2}: {counts}; host reads {reads}")
    check(counts["tridiag_sweep"] > 0, f"self_adjoint_evd n={n2} ran tridiag_sweep")
    _evd_checks(a2, w2, v2, f"self_adjoint_evd n={n2}")
    (u2, s2, vs2, _), counts, reads = _counted(lambda: svd(g2))
    add(counts)
    print(f"launches in svd n={n2}: {counts}; host reads {reads}")
    check(counts["bidiag_sweep"] > 0, f"svd n={n2} ran bidiag_sweep")
    _svd_checks(g2, u2, s2, vs2, f"svd n={n2}")

    # the tall SVD takes the QR preprocessing (m/n = 4 > 11/6)
    mt, nt_ = TALL
    gt = torch.randn(mt, nt_, generator=gen, device=DEV)
    (ut, st, vt, _), counts, reads = _counted(lambda: svd(gt))
    add(counts)
    print(f"launches in svd {mt}x{nt_}: {counts}; host reads {reads}")
    check(counts["bidiag_sweep"] > 0 and counts["qr_panel"] > 0,
          f"svd {mt}x{nt_} ran qr_panel and bidiag_sweep")
    _svd_checks(gt, ut, st, vt, f"svd {mt}x{nt_}")

    # times: the entry points, their yardsticks, then the layers at 4096
    _timed(lambda: self_adjoint_evd(a), f"self_adjoint_evd n={n}", flops.evd_flops(n))
    _timed(lambda: torch.linalg.eigh(a), f"library eigh n={n}")
    _timed(lambda: svd(g), f"svd n={n}", flops.svd_flops(n, n))
    _timed(lambda: torch.linalg.svd(g, full_matrices=False), f"library svd n={n}")
    for label, fn in ((f"self_adjoint_evd n={n2}", lambda: self_adjoint_evd(a2)),
                      (f"svd n={n2}", lambda: svd(g2))):
        wall = _timed(fn, label)
        busy = device_ms(fn)
        print(f"device busy in {label}: {busy:.4f} ms of {wall:.4f} ms "
              f"({busy / wall:.3f}; torch.profiler kernel spans)")
    _timed(lambda: torch.linalg.eigh(a2), f"library eigh n={n2}")
    _timed(lambda: torch.linalg.svd(g2, full_matrices=False), f"library svd n={n2}")
    _timed(lambda: svd(gt), f"svd {mt}x{nt_}", flops.svd_flops(mt, nt_))
    _timed(lambda: torch.linalg.svd(gt, full_matrices=False), f"library svd {mt}x{nt_}")
    d, e, hh, taus = tridiag_in_place(a)
    _, z, _ = tridiag_evd(d, e)
    layers = {
        "tridiag_in_place": cuda_ms(lambda: tridiag_in_place(a), 1, warmup=0),
        "tridiag_evd (D&C)": cuda_ms(lambda: tridiag_evd(d, e), 1, warmup=0),
        "tridiag_apply_q": cuda_ms(lambda: tridiag_apply_q(hh, taus, z), 1, warmup=0),
    }
    bd = bidiag_in_place(g)
    _, ub, vb, _ = bidiag_svd(bd[0], bd[1])
    layers.update({
        "bidiag_in_place": cuda_ms(lambda: bidiag_in_place(g), 1, warmup=0),
        "bidiag_svd (D&C)": cuda_ms(lambda: bidiag_svd(bd[0], bd[1]), 1, warmup=0),
        "bidiag_apply_ql + apply_qr_mat": cuda_ms(
            lambda: (bidiag_apply_ql(bd[2], bd[3], ub), bidiag_apply_qr_mat(bd[4], bd[5], vb)),
            1, warmup=0),
    })
    for k, ms in layers.items():
        print(f"time layer {k} n={n}: {ms:.4f} ms (one call)")
    print(f"launches in the spectral phase: {total}")
    return total


def _res(mat, x, rhs) -> float:
    """‖A x − b‖ / (‖A‖ ‖x‖), Frobenius norms."""
    return (torch.linalg.matrix_norm(mat @ x - rhs) / (
        torch.linalg.matrix_norm(mat) * torch.linalg.matrix_norm(x))).item()


def phase_facade() -> dict:
    """The facade as a user drives it, ``Mat(a).llt().solve(b)`` and its
    siblings, at n = 4096 with the tile GEMM switch on and f32_precision
    "highest": every front-door product above 128³ without a pinned
    precision goes to ``tile_matmul``. Each call is counted on its own;
    the counts of the switch-on calls are summed."""
    from faer_tpu_torch import Mat
    from faer_tpu_torch.core.config import config
    from faer_tpu_torch.ops.reductions import log_abs_det_diag

    gen = torch.Generator(device=DEV).manual_seed(SEED)
    n = N
    tol = 8 * n * EPS32
    a_spd, g, b = _inputs(n, gen)
    h = torch.randn(n, n, generator=gen, device=DEV)
    eye = torch.eye(n, device=DEV)
    total = {}
    config.use_tile_matmul = True
    config.f32_precision = "highest"

    def counted(key, fn):
        out, counts, _ = _counted(fn)
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        mm = counts["matmul"]
        print(f"launches in {key}: {counts}")
        check(mm == FACADE_MATMUL[key],
              f"{key}: {mm} tile_matmul launches, {FACADE_MATMUL[key]} predicted")
        return out, mm

    prod, mm = counted("Mat @ Mat", lambda: Mat(g) @ Mat(h))
    err = (prod.a - g @ h).abs().max().item() / _row_col_scale(g, h)
    check(mm > 0 and err <= F32_TOL, f"Mat @ Mat n={n}: {mm} tile_matmul launch, max err "
                                     f"vs torch.matmul {err:.3e} of max|a_i||b_j| <= "
                                     f"{F32_TOL:.3e}")
    g1 = torch.randn(ORACLE_N, ORACLE_N, generator=gen, device=DEV)
    h1 = torch.randn(ORACLE_N, ORACLE_N, generator=gen, device=DEV)
    p1, mm = counted("Mat @ Mat 1024", lambda: Mat(g1) @ Mat(h1))
    err = ((p1.a.double() - g1.double() @ h1.double()).abs().max().item()
           / _row_col_scale(g1, h1))
    check(mm > 0 and err <= F32_TOL, f"Mat @ Mat n={ORACLE_N} vs f64: max err {err:.3e} "
                                     f"of max|a_i||b_j| <= {F32_TOL:.3e}")

    llt, mm = counted("llt()", lambda: Mat(a_spd).llt())
    rec = rel_norm(llt.reconstruct(), a_spd)
    check(mm > 0 and rec <= tol, f"llt(): {mm} tile_matmul launches, |LLᵀ-A|/|A| "
                                 f"{rec:.3e} <= {tol:.3e}")
    x, mm = counted("llt().solve", lambda: llt.solve(b))
    r = _res(a_spd, x, b)
    check(r <= tol, f"llt().solve: {mm} launches, |Ax-b|/(|A||x|) {r:.3e} <= {tol:.3e}")
    inv, mm = counted("llt().inverse()", lambda: llt.inverse())
    r = _res(a_spd, inv, eye)
    check(r <= tol, f"llt().inverse(): {mm} launches, |AX-I|/(|A||X|) {r:.3e} <= {tol:.3e}")
    (det, logdet), mm = counted("llt().determinant()",
                                lambda: (llt.determinant(), llt.logdet()))
    sign, ref = torch.linalg.slogdet(a_spd.double())
    err = abs(logdet.item() - ref.item()) / abs(ref.item())
    check(sign.item() == 1 and det.item() > 0 and err <= tol,
          f"llt(): determinant {det.item():.4g}, logdet {logdet.item():.6f} "
          f"vs slogdet {ref.item():.6f}: rel err {err:.3e} <= {tol:.3e}")

    lu, mm = counted("partial_piv_lu()", lambda: Mat(g).partial_piv_lu())
    rec = rel_norm(lu.reconstruct(), g)
    check(mm > 0 and rec <= tol, f"partial_piv_lu(): {mm} tile_matmul launches, "
                                 f"|A[perm]-LU|/|A| {rec:.3e} <= {tol:.3e}")
    x, mm = counted("partial_piv_lu().solve", lambda: lu.solve(b))
    r = _res(g, x, b)
    check(r <= tol, f"partial_piv_lu().solve: {mm} launches, residual {r:.3e} <= {tol:.3e}")
    x, mm = counted("partial_piv_lu().solve_transpose", lambda: lu.solve_transpose(b))
    r = _res(g.T, x, b)
    check(r <= tol, f"solve_transpose: {mm} launches, |Aᵀx-b|/(|A||x|) {r:.3e} <= {tol:.3e}")
    inv, mm = counted("partial_piv_lu().inverse()", lambda: lu.inverse())
    r = _res(g, inv, eye)
    check(r <= tol, f"partial_piv_lu().inverse(): {mm} launches, |AX-I|/(|A||X|) "
                    f"{r:.3e} <= {tol:.3e}")
    det, mm = counted("partial_piv_lu().determinant()", lambda: lu.determinant())
    s_u, log_u = log_abs_det_diag(lu.U)
    sign_lu = s_u.item() * (1 - 2 * (int(lu.info.transposition_count) % 2))
    sign, ref = torch.linalg.slogdet(g.double())
    err = abs(log_u.item() - ref.item()) / abs(ref.item())
    check(float(torch.sign(det)) == sign.item() == sign_lu and err <= tol,
          f"partial_piv_lu(): determinant {det.item():.4g}, sign "
          f"{sign_lu:+.0f} vs slogdet {sign.item():+.0f}; log|det| of the factor "
          f"{log_u.item():.4f} vs {ref.item():.4f}: rel err {err:.3e} <= {tol:.3e}")

    x, mm = counted("qr().solve_lstsq", lambda: Mat(g).qr().solve_lstsq(b))
    r = _res(g, x, b)
    check(mm > 0 and r <= tol, f"qr().solve_lstsq n={n}: {mm} launches, residual "
                               f"{r:.3e} <= {tol:.3e}")
    mt, nt_ = TALL
    at = torch.randn(mt, nt_, generator=gen, device=DEV)
    bt = torch.randn(mt, 8, generator=gen, device=DEV)
    xt, mm = counted(f"qr().solve_lstsq {mt}x{nt_}",
                     lambda: Mat(at).qr().solve_lstsq(bt))
    rt = bt - at @ xt
    orth = (torch.linalg.matrix_norm(at.T @ rt) / (
        torch.linalg.matrix_norm(at) * torch.linalg.matrix_norm(rt))).item()
    check(mm > 0 and orth <= 8 * mt * EPS32,
          f"qr().solve_lstsq {mt}x{nt_}: {mm} launches, |Aᵀr|/(|A||r|) {orth:.3e} "
          f"<= {8 * mt * EPS32:.3e}")

    ns = FACADE_SPECTRAL_N
    gs = torch.randn(ns, ns, generator=gen, device=DEV)
    sym = (gs + gs.T) / 2
    eig, mm = counted(f"self_adjoint_eigen() {ns}", lambda: Mat(sym).self_adjoint_eigen())
    _evd_checks(sym, eig.eigenvalues, eig.eigenvectors, f"self_adjoint_eigen() n={ns}")
    sv, mm = counted(f"svd() {ns}", lambda: Mat(gs).svd())
    _svd_checks(gs, sv.U, sv.S, sv.V, f"svd() n={ns}")

    calls = {
        "Mat @ Mat": lambda: Mat(g) @ Mat(h),
        "Mat(spd).llt().solve(b)": lambda: Mat(a_spd).llt().solve(b),
        "Mat(g).partial_piv_lu().solve(b)": lambda: Mat(g).partial_piv_lu().solve(b),
        "Mat(g).qr().solve_lstsq(b)": lambda: Mat(g).qr().solve_lstsq(b),
    }
    config.use_tile_matmul = False
    for label, fn in calls.items():
        _, counts, _ = _counted(fn)
        check(counts["matmul"] == 0, f"switch off: {label} n={n} made no tile_matmul launch")
    for label, fn in calls.items():  # in turns on one card: off, on, on, off
        ms = []
        for on in (False, True, True, False):
            config.use_tile_matmul = on
            ms.append(cuda_ms(fn, 3))
        print(f"time facade {label} n={n}: switch off {ms[0]:.4f} / on {ms[1]:.4f} / "
              f"on {ms[2]:.4f} / off {ms[3]:.4f} ms (median of 3 each)")

    config.use_tile_matmul = True
    config.f32_precision = "high"
    p_hi = (Mat(g) @ Mat(h)).a
    err = (p_hi.double() - g.double() @ h.double()).abs().max().item() / _row_col_scale(g, h)
    x_hi = Mat(a_spd).llt().solve(b)
    r = _res(a_spd, x_hi, b)
    check(err <= BF16X3_TOL and r <= tol,
          f"f32_precision 'high' (bf16x3): Mat @ Mat n={n} max err vs f64 {err:.3e} of "
          f"max|a_i||b_j| <= {BF16X3_TOL:.3e}; llt().solve residual {r:.3e} <= {tol:.3e}")
    config.f32_precision = "highest"
    config.use_tile_matmul = False
    print(f"launches in the facade phase: {total}")
    return total


def phase_calu(gen) -> dict:
    """The tournament (CALU) leaf through ``lu_in_place``, with the module
    gate ``faer_tpu_torch.linalg.lu._CALU_GROUP`` set for the phase and
    restored after it. Each call is counted on its own; the counts are
    summed."""
    from faer_tpu_torch import lu_in_place, lu_reconstruct, lu_solve
    from faer_tpu_torch.linalg import lu as tlu
    from faer_tpu_torch.utils import flops

    total = {}

    def counted(label, fn, want):
        out, counts, _ = _counted(fn)
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        got = {k: counts[k] for k in want}
        print(f"launches in {label}: {counts}")
        check(got == want, f"{label}: launches {got}, predicted {want}")
        return out

    gate = tlu._CALU_GROUP
    try:
        # the tall-skinny factor: panels of 256, each leaf 64768–65536 rows
        m, n = CALU
        a = torch.randn(m, n, generator=gen, device=DEV)
        tlu._CALU_GROUP = CALU_GROUP
        lu, perm, info = counted(f"lu_in_place {m}x{n} (group {CALU_GROUP})",
                                 lambda: lu_in_place(a), CALU_LAUNCHES[CALU])
        tol = 8 * max(m, n) * EPS32
        rec = rel_norm(lu_reconstruct(lu, perm), a)
        lmax = torch.tril(lu, -1).abs().max().item()
        check(tuple(lu.shape) == (m, n) and bool(torch.isfinite(lu).all())
              and bool(info.success) and rec <= tol,
              f"CALU lu_in_place {m}x{n}: |A[perm]-LU|/|A| = {rec:.3e} <= {tol:.3e}; "
              f"max|L| = {lmax:.4f} (tournament pivots do not bound it by 1)")
        calu_ms = cuda_ms(lambda: lu_in_place(a), 3)
        tlu._CALU_GROUP = gate
        (lu0, perm0, _), counts, _ = _counted(lambda: lu_in_place(a))
        rec0 = rel_norm(lu_reconstruct(lu0, perm0), a)
        check(counts["lu_leaf"] == 4 and counts["lu_panel_v2"] == 0 and rec0 <= tol,
              f"default gate lu_in_place {m}x{n}: {counts['lu_leaf']} lu_leaf, "
              f"{counts['lu_panel_v2']} lu_panel_v2 launches; |A[perm]-LU|/|A| = "
              f"{rec0:.3e}")
        leaf_ms = cuda_ms(lambda: lu_in_place(a), 3)
        lib_ms = cuda_ms(lambda: torch.linalg.lu_factor_ex(a), 3)
        fl = flops.lu_flops(m, n)
        print(f"time lu_in_place {m}x{n}: CALU {calu_ms:.4f} ms "
              f"({fl / calu_ms / 1e6:.1f} GFLOP/s), default gate (lu_leaf) "
              f"{leaf_ms:.4f} ms ({fl / leaf_ms / 1e6:.1f} GFLOP/s), library "
              f"lu_factor_ex {lib_ms:.4f} ms")

        # a square factor and solve: 256-wide leaves of up to 4000 rows,
        # each past the gate a tournament of up to 4 groups
        n2, gate2 = CALU_SOLVE
        g2 = torch.randn(n2, n2, generator=gen, device=DEV)
        b2 = torch.randn(n2, 8, generator=gen, device=DEV)
        tlu._CALU_GROUP = gate2
        lu2, perm2, info2 = counted(f"lu_in_place {n2}x{n2} (group {gate2})",
                                    lambda: lu_in_place(g2), CALU_LAUNCHES[(n2, n2)])
        x = lu_solve(lu2, perm2, b2)
        tol2 = 8 * n2 * EPS32
        rec2 = rel_norm(lu_reconstruct(lu2, perm2), g2)
        res2 = _res(g2, x, b2)
        check(bool(info2.success) and bool(torch.isfinite(x).all()) and rec2 <= tol2
              and res2 <= tol2,
              f"CALU lu_in_place {n2}x{n2} + lu_solve (8 rhs): |A[perm]-LU|/|A| = "
              f"{rec2:.3e}, |Ax-b|/(|A||x|) = {res2:.3e}, both <= {tol2:.3e}; max|L| "
              f"{torch.tril(lu2, -1).abs().max().item():.4f}")
    finally:
        tlu._CALU_GROUP = gate
    print(f"launches in the calu phase: {total}")
    return total


def main() -> None:
    name = phase_device()
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from faer_tpu_torch.core.config import check_f32_policy

    check_f32_policy()
    print("f32 policy: full FP32 matmuls (allow_tf32 False, precision 'highest')")
    t0 = time.perf_counter()
    phase_build()
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    kern = phase_kernels(gen)
    paths = [phase_flagship(gen), phase_qr(gen), phase_off_route(gen),
             phase_spectral(gen), phase_facade(), phase_calu(gen)]
    # each kernel's launches over the paths' runs (trtri runs in several)
    launches = {k: sum(c[k] for c in paths) for k in paths[0]}
    sources = {
        "trtri": ("faer_tpu_torch/csrc/trtri.cu",
                  "faer_tpu/ops/pallas/panel_kernels.py:302"),
        "llt_panel": ("faer_tpu_torch/csrc/llt_panel.cu",
                      "faer_tpu/ops/pallas/llt_panel_v5.py:176"),
        "lu_panel": ("faer_tpu_torch/csrc/lu_panel_batched.cu",
                     "faer_tpu/ops/pallas/lu_panel_v5.py:157"),
        "qr_panel": ("faer_tpu_torch/csrc/qr_panel.cu",
                     "faer_tpu/ops/pallas/qr_panel_v5.py:144"),
        "llt_leaf": ("faer_tpu_torch/csrc/llt_panel.cu",
                     "faer_tpu/ops/pallas/leaf_v4.py:132"),
        "lu_leaf": ("faer_tpu_torch/csrc/lu_panel_batched.cu",
                    "faer_tpu/ops/pallas/leaf_v4.py:228"),
        "tridiag_sweep": ("faer_tpu_torch/csrc/tridiag_sweep.cu",
                          "faer_tpu/ops/pallas/panel_kernels.py:390"),
        "bidiag_sweep": ("faer_tpu_torch/csrc/bidiag_sweep.cu",
                         "faer_tpu/ops/pallas/panel_kernels.py:502"),
        "matmul": ("faer_tpu_torch/csrc/matmul.cu",
                   "faer_tpu/ops/pallas/matmul_kernel.py:92"),
        "syrk": ("faer_tpu_torch/csrc/syrk.cu",
                 "faer_tpu/ops/pallas/syrk_kernel.py:108"),
        "lu_panel_v2": ("faer_tpu_torch/csrc/lu_panel_batched.cu",
                        "faer_tpu/ops/pallas/lu_panel_v2.py:152"),
        "lu_panel_v3": ("faer_tpu_torch/csrc/lu_panel_batched.cu",
                        "faer_tpu/ops/pallas/lu_panel_v3.py:125"),
        "lu_panel_swap": ("faer_tpu_torch/csrc/lu_panel_swap.cu",
                          "faer_tpu/ops/pallas/panel_kernels.py:81"),
    }
    # on no path, as in the JAX package: syrk_lower_sub is unwired, the v3
    # and v1 LU panels are called by nothing
    off_path = {"syrk", "lu_panel_v3", "lu_panel_swap"}
    check(all(launches[k] > 0 for k in sources if k not in off_path),
          f"every kernel but the off-path {sorted(off_path)} ran on a main path")
    print(f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": [
        dict(name=k, route="cuda", source=src, replaces=rep,
             launches=launches[k], off_path=k in off_path, **kern[k])
        for k, (src, rep) in sources.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
