"""Drive the PyTorch port's main path once on one CUDA card and check it.

    python3 chip_smoke.py

Phases, each printing lines; any failure exits non-zero:

1. device: a CUDA card must be present (no CPU fallback); prints the card's
   name and power limit as nvidia-smi reports them;
2. build: compiles ``faer_tpu_torch/csrc/*.cu`` into ``build/faer_tpu_torch``
   and, beside it, the LU and LLT panel kernels' profile builds
   (``tools/torch_profile.py``'s, which can force the LU panel's grid route
   and the LLT panel's rows into global memory), and prints how many 16-
   and 8-CTA clusters of the QR and LU panel kernels the card places at
   once (``cudaOccupancyMaxActiveClusters``);
3. kernels: each hand-written kernel against its plain PyTorch version on
   the card, at the main paths' shapes, with the tolerance stated, and its
   time beside its plain version's, its bound and a library yardstick;
   ``llt_panel`` at b from 32 to 512 and m from b to 200 000, on both
   sides of its shared-memory edge at b = 256 and 512 (``llt_panel_cases``),
   regularized at b = 256 and 512, and on the main path's row-stride-1024
   views, each case's route printed, against ``llt_panel_plain`` (8·b·eps)
   and its own order ``llt_panel_blocked_plain`` (16·eps), count and ok
   equal, the rows in shared memory equal to the rows forced into global
   memory to the bit, and a tall slab's first rows to a short slab's; timed
   at (4096, 256) per call and on the device beside ``cholesky_ex`` +
   ``solve_triangular`` (two calls); ``trtri`` at n ∈ {1, 16, 17, 32, 100, 128}, unit and not, against its
   plain version, the kernel's own order and an f64 inverse, and batched
   over the diagonal blocks of a 4096 and a 4000 triangle read through
   contiguous, row-strided and transposed views (bit for bit single
   launches), timed per call and on the device beside
   ``solve_triangular(L, I)``; ``tile_matmul`` in its three modes at
   4096³, ragged, strided, on offset views, at long k and at the facade's
   thin products (split k), each case's plan printed, timed per call and
   on the device beside ``torch.matmul``; ``syrk_lower_sub`` in both modes
   at (3840, 256) with a K-major and an M-major A, ragged and at k = 257,
   the upper triangle C's values to the bit, timed per call and on the
   device beside ``torch.addmm``; ``lu_panel_swap`` equal to its plain
   version to the bit on separated and Gaussian panels on both of its
   routes, timed per call and on the device; the LU panel kernel
   (``lu_panel``, ``lu_leaf``, ``lu_panel_v2`` and its batch,
   ``lu_panel_v3``) on both sides of every route edge of
   ``csrc/lu_panel_batched.cu`` (``lu_cases``), each case's route
   printed, against ``lu_panel_plain`` (perm equal, 8·m·eps) and its own
   order ``lu_panel_blocked_plain`` (16·eps), the cluster route equal to
   the grid route forced onto the same shapes to the bit, the batch to
   single launches to the bit; ``qr_panel`` and the QR panel
   family (``qr_panel_v1``, ``qr_panel_v2``, ``qr_panel_v3``, ``qr_leaf``)
   on both sides of every route edge of ``csrc/qr_panel.cu`` (``qr_cases``:
   (128, 128) to (16384, 512), the cluster route's largest m at b = 128 and
   one past it), each case's route printed, against the plain version, the
   kernel's one-pass order and ``torch.geqrf``, the family equal to
   ``qr_panel`` to the bit; every panel wrapper on wide panels (m < b) at
   (64, 200) and (1000, 1024); the three wrappers of
   the blocked LLT diagonal-block kernel, ``llt_leaf``, ``llt_block`` and
   ``llt_block_v3``, at b ∈ {44, 80, 128, 200, 256, 337, 338, 512, 1024}
   on regularized blocks and on row-strided views at b ∈ {125, 338}, timed
   per call and on the device (CUDA-graph replay) beside ``cholesky_ex``;
   ``chase_probe`` at (b, g, steps) ∈ {(64, 1, 3), (64, 4, 24),
   (128, 8, 24)} and on both sides of its route edge (the largest b whose
   strip a thread-block cluster holds in shared memory, and the next, on a
   global copy), each case's route printed, and on a zero-tail window on
   both routes; timed at (128, 8, 24) per call and on the device; the
   batched QR kernels
   ``tridiag_qr_batched`` and ``bidiag_qr_batched`` (the whole iteration
   of many problems in one launch) on the 64 leaves of a 4096 problem, the
   ragged leaves of 4000, the bidiagonal's wide and square leaves, the
   direct route at the first size past the vectors' shared-memory edge
   (vectors in global memory; phase 7 drives the route at 384), a
   max_iters case and
   zero diagonals (both chases), each case's route printed, against their
   plain versions (on the first two and last two problems of a batch of
   leaves): d, e, iterations, converged and sweep steps equal to the bit,
   vectors within 8·n·eps; timed by graph replay beside batched
   ``eigh``/``svd`` of the same leaves as dense blocks; and their one-sweep
   entries (``tridiag_sweep``, ``bidiag_sweep``) equal to the plain sweeps
   to the bit at 64, 384 and 8192;
4. flagship step: ``flagship_step`` at n = 4096 f32 (the JAX package's bench
   size) with 8 right-hand sides on inputs made from seed 0, launch counts,
   reconstruction errors, solve residuals, a reference check at n = 1024
   against an f64 oracle, and CUDA-event timings of each factorization
   (``llt_factor`` beside ``cholesky_ex``, ``lu_in_place`` beside
   ``lu_factor_ex``) and solve, and per call the triangular solves of
   4096 × 8 and the whole step beside ``torch.linalg.solve_triangular``;
5. QR: ``qr_in_place`` then ``qr_solve_lstsq`` at n = 4096 (as ``bench.py``
   drives it), launch counts, ‖QR − A‖, QᵀQ − I, the solve residual, tall
   8192 × 2048 and 65536 × 512 least-squares solves, an f64 check at
   2048 × 512, and timings (the R solve beside ``solve_triangular``);
6. off-route: ``llt_factor`` and ``lu_in_place`` on shapes the fused route
   does not take (the recursive drivers and their leaf kernels), launch
   counts, reconstruction errors and timings;
7. spectral: ``self_adjoint_evd((g + gᵀ)/2)`` and ``svd(g)`` at n = 4096
   f32 (``tools/bench_spectral.py``'s cells) on inputs made from seed 0,
   one sweep-kernel launch and no host read per call (at 4096, 384,
   8192 × 2048 and in the wide ``_dnc``), residuals and orthogonality,
   eigenvalues and singular values against an f64 oracle at n = 1024, the
   direct QR-iteration route at n = 384, the tall SVD at 8192 × 2048 (QR
   preprocessing), the wide bidiagonal D&C ``_dnc(d, e, 1)`` on the golden
   fixture ``tests/data/svd/svd512.txt`` (‖UᵀU − I‖_F ≤ 2e-4·n), per-layer
   times, the D&C layers' leaf stage on the device (at 4096 and 1024)
   beside their merges (at 1024), and ``torch.linalg.eigh``/``svd``
   yardsticks;
8. facade: ``Mat`` and the solver objects at n = 4096 f32 (seed 0) with the
   tile GEMM switch on (``config.use_tile_matmul``, ``f32_precision =
   "highest"``): ``Mat @ Mat``, ``llt()`` with ``solve``, ``inverse``,
   ``determinant``/``logdet``, ``partial_piv_lu()`` with ``solve``,
   ``solve_transpose``, ``inverse``, ``determinant``, ``qr().solve_lstsq``
   at 4096 and 8192 × 2048, ``self_adjoint_eigen()`` (and its ``solve``
   of a 1-D right-hand side) and ``svd()`` at 1024; ``tile_matmul``
   launches per call, residuals, the same calls with
   the switch off (no launch), times with the switch off and on in turns,
   and the GEMM and ``llt().solve`` errors with ``f32_precision = "high"``;
9. calu: the tournament (CALU) leaf, ``lu_in_place`` on a Gaussian
   65536 × 1024 f32 (seed 0) with ``_CALU_GROUP`` = 4096 (4 leaves of 16
   groups, each leaf one batched ``lu_panel_v2`` launch and one more for
   its stacked candidates), launch counts against the code's prediction,
   ‖A[perm] − LU‖/‖A‖ and max|L|, ``lu_solve`` after ``lu_in_place`` on a
   4000² with the gate at 1024, and the 65536 × 1024 factor's time beside
   the default gate's (``lu_leaf`` leaves) and ``torch.linalg.lu_factor_ex``;
10. panel lab: ``tools/torch_qr_panels.py``, the QR panel lab (the
   counterpart of ``tools/r5qr.py`` and ``tools/r4lab.py``): ``qr_panel``,
   ``qr_panel_v1``, ``qr_panel_v2``, ``qr_panel_v3`` and ``qr_leaf`` (sb 8
   and 16) at (m, b) ∈ {4096, 2048, 1024} × {128, 256, 512} on one Gaussian
   4096² matrix: times, ‖QR − A‖/‖A‖ ≤ 8·m·eps, differences from
   ``qr_panel``, and each counter's launches against the tool's calls;
11. LLT block lab: ``tools/torch_llt_blocks.py`` (the counterpart of
   ``tools/r4parts.py``, ``r4lab.py`` and ``r4lab2.py``): ``llt_block``,
   ``llt_block_v3``, ``llt_leaf``, ``_llt_panel_recursive`` and
   ``cholesky_ex`` at b ∈ {128, 256, 512}, a regularized block, and twelve
   4096² factors whose leaves are ``llt_block``, ``llt_block_v3`` or
   ``llt_leaf`` at leaf width 128 or 256 and block 256 or 512, beside
   ``llt_factor``; residuals, and each counter against the tool's
   prediction. The three leaf wrappers launch one kernel, so the lab
   compares leaf widths and block sizes;
12. chase lab: ``tools/torch_chase.py`` (the counterpart of
   ``tools/r5chase.py``): ``chase_probe`` at b ∈ {64, 128}, g ∈ {1, 4, 8},
   steps ∈ {256, 1024}, µs per step and per window, and whether a
   two-stage reduction could pay at 4096 against phase 7's one-stage
   reduction and ``eigh``; launches against the tool's calls;
13. dense stack: at n = 4096, seed 0, inputs made on the card in float64
   and rounded to float32 for the float32 runs, through ``Mat`` and the
   solver objects: ``ldlt()`` of ``g gᵀ/n + I`` with ``solve`` (8 rhs),
   ``reconstruct`` and ``determinant``; ``piv_llt()`` of a PSD matrix of
   rank 3 072 (rank and reconstruction) and of ``g gᵀ/n + I`` (solve);
   ``lblt()`` of ``(g + gᵀ)/2``; ``full_piv_lu()`` and ``col_piv_qr()`` of
   a Gaussian ``g``; ``llt().rank_update`` and ``ldlt().rank_update`` with
   r = 8 columns, α = +1 then the downdate α = −1 back to A; all of them
   in float32 and float64, and the float64 ``llt()``, ``partial_piv_lu()``
   and ``qr()`` with their 8-rhs solves. Each reconstruction and residual
   within 8·n·eps of its dtype, each determinant's sign right, the ranks
   exact; every float32 call's launches equal to the count predicted from
   the drivers' control flow (``DENSE_LAUNCHES``), every float64 call's
   zero. Each call timed once by CUDA events, per call, beside the closest
   library call (``cholesky_ex``, ``ldl_factor``, ``lu_factor_ex``,
   ``geqrf``) on the same input in the same dtype. The factors are loops
   of small launches, set by the host; ``tools/torch_split.py dense`` times
   them on the device too (CUDA graphs);
14. general EVD and f64 spectral: at n = 1024 in float32 (ns = 64, AED
   window 96) and 512 in float64 (ns = 32, window 48) the Schur step as
   ``evd`` runs it (``hessenberg_blocked``, then multishift QR
   with AED, each window one ``real_schur`` launch), with ‖A − QTQᵀ‖/‖A‖,
   max|QᵀQ − I| and the eigenvalues against f64 ``numpy.linalg.eigvals``,
   each within 8·n·eps; ``evd`` and ``eigenvalues`` in each dtype
   (the residual and the eigenvalues within 8·n·eps of the dtype), each
   call timed once (host clock) with its AED and sweep shares, beside
   ``torch.linalg.eig`` and ``eigvals``; ``Mat(a).eigen()`` and
   ``.eigenvalues()`` at 127 (one direct ``real_schur`` launch) and 128
   (multishift); every ``real_schur`` launch equal to the AED windows and
   direct calls the drivers made (counted by wrappers); the float64
   ``self_adjoint_evd`` and ``svd`` at 1024 (D&C) and 384 (the direct QR
   route), each exactly one sweep launch and no host read, checked and
   timed beside ``eigh`` and ``svd`` in float64. Phase 3 holds
   ``real_schur`` against its plain version (T, Q, iterations, converged
   and chase steps to the bit) at the AED windows 48 and 96, a batch of 16s
   and both sides of its shared-memory edge in float32 and float64, its
   shared route against the global one, and times it at 96; and the
   float64 batched QR kernels against theirs on the 16 leaves of 1024;
15. generalized EVD: ``gevd`` at n = 1024 in float32 and float64 on one
   Gaussian pencil (the Hessenberg–triangular reduction, one ``hess_tri``
   launch after the QR of B; the QZ iteration, one ``real_qz`` launch;
   the pencil's eigenvectors), with ‖A − QSZᵀ‖/‖A‖, ‖B − QTZᵀ‖/‖B‖ and the
   orthogonality of Q and Z within 8·n·eps, the residual of A V diag(β) =
   B V diag(α), and every (α, β) against f64 ``scipy.linalg.eig`` within
   2·κ_i·η in the chordal metric; each call and its stages timed once; a B
   of rank 192 at 256 (64 β within n·eps·‖B‖ of 0); the reduction method
   at 512 beside ``torch.linalg.eig(torch.linalg.solve(B, A))``;
   ``gevd_self_adjoint`` at 1024; ``Mat(a).generalized_eigen(b)`` once.
   Phase 3 holds ``hess_tri`` and ``real_qz`` against their plain versions
   to the bit at 1, 2, 3, 16, 48, 96, both sides of each one's
   shared-memory edge, a rank-deficient B and a ragged batch, in float32
   and float64 (the plain versions in host processes while the card runs
   the kernels), and times both at 96 once those processes have ended;
   then past the kernels' 512 threads a CTA, at 1024 in float32 and 600
   in float64, whose plain versions run in four host processes beside
   phases 4–14 and are held against the kernels before phase 15;
16. complex input (item 10a): the complex64 and complex128 factorizations,
   solves, self-adjoint EVD and SVD through ``Mat`` and the solver objects,
   each call counted and timed beside its library call;
17. complex general EVD (item 10b-i), in a spawned process of its own
   beside phases 13–16 (its lines printed after phase 16): ``evd`` at
   n = 1024 (ns = 64, AED window 96) in complex64 and complex128 (the
   unitary Hessenberg reduction, multishift QR with AED, each window one
   ``complex_schur`` launch, the triangular eigenvectors), the Schur
   step's ‖A − QTQᴴ‖/‖A‖ and max|QᴴQ − I| within 8·n·eps, T upper
   triangular, the eigenvalues within 2·κ_i·η of f64 ``scipy.linalg.eig``
   (run in a host process of its own meanwhile), the residual within
   8·n·eps, two host reads an AED round, each call timed once with its
   layers beside ``torch.linalg.eig`` and ``eigvals``; ``Mat(a).eigen()``
   at 127 (one direct launch), 128 and 256 in complex64;
   ``batched.eigenvalues`` on 8 × 64² complex64. Phase 3 holds
   ``complex_schur`` against its plain version (T, Q, iterations,
   converged and chase steps to the bit) at the AED windows 48 and 96, a
   batch of 16s, n = 1 and 2, an iteration budget of 0, both sides of its
   shared-memory edge and a ragged batch, in complex64 and complex128 (the
   plain versions in host processes while the card runs the kernel), and
   times it at 48 and 96;
18. complex generalized EVD (item 10b-ii), in phase 17's process after it:
   ``gevd`` at n = 1024 (ns = 64, AED window 96) in complex64 and
   complex128 on one complex Gaussian pencil (the QR of B, one
   ``complex_hess_tri`` launch; multishift QZ with AED, every window one
   ``complex_qz`` launch and one ``complex_hess_tri`` launch on its kept
   block; the triangular pencil's eigenvectors), with ‖A − QSZᴴ‖/‖A‖,
   ‖B − QTZᴴ‖/‖B‖, max|QᴴQ − I|, max|ZᴴZ − I| and the pencil residual
   within 8·n·eps, S and T upper triangular, every (α, β) within 2·κ_i·η
   of f64 ``scipy.linalg.eig`` of the complex128 pencil (run in a host
   process of its own from the start of phase 17) in the chordal metric,
   two host reads an AED round, each call timed once with its layers
   beside ``torch.linalg.eig(torch.linalg.solve(B, A))``; ``qz`` at 127
   (one direct ``complex_qz`` launch, no host read) and 128 in complex64;
   ``method="reduction"`` at 512, ``gevd_self_adjoint`` at 1024 and
   ``Mat(a).generalized_eigen(b)`` at 256 in complex64. Phase 3 holds
   ``complex_hess_tri`` and ``complex_qz`` against their plain versions
   (the reduction's H, R, Q, Z and the QZ's S, T, Q, Z, iterations,
   converged and chase steps to the bit) at 1, 2, 3, 16, 48, 96, a budget
   of 0, both sides of each kernel's shared-memory edge, a B of rank 12 at
   16 and a ragged batch, in complex64 and complex128 (the plain versions
   in host processes while the card runs the kernels), the chain also at
   513 (past 512 threads a CTA; its plain version beside phases 4–14), and
   times both at 96.

Each path is driven with the launch counters set to 0 just before it and
read just after; each phase prints its own time. The second-to-last line is
a JSON object with one entry per kernel; the last is
``{"ok": true, "device": {...}}``.
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
# NVIDIA's data sheet, H100 SXM at 700 W: FP32 (and FP64) outside the tensor
# cores, bf16 dense on the tensor cores, HBM3
PEAK_F32_FLOPS = 67e12
PEAK_F64_FLOPS = 34e12  # FP64 outside the tensor cores
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
# launches the code predicts (PERF.md §6), trtri one batched launch per
# triangular solve and per inverse: per off-route factor, its leaves and
# trtri (LLT 4000: 16 panels of 256 (the last 160) with one inverse inside
# each halving and 15 couplings; 1000: 16 leaf panels of 64, 15 couplings;
# LU 4000²: 8 panels of 512 (the last 416) with one unit-lower solve inside
# each halving and 7 U12 inverses; 4096 × 1024: 4 leaf panels, 3 U12
# inverses; 1024 × 4096: 4, and 4 U12 inverses); in one qr_in_place +
# qr_solve_lstsq at N, 4 T factors of each of the 8 panels and 1 for the R
# solve; and in one flagship_step at N, 1 + 1 in llt_solve, 12 panel and 3
# strip inverses in lu_in_place, 1 + 1 in lu_solve
LLT_OFF_ROUTE = {4000: dict(llt_leaf=32, trtri=16 + 15),
                 1000: dict(llt_leaf=16, trtri=15)}
LU_OFF_ROUTE = {(4000, 4000): dict(lu_leaf=16, trtri=8 + 7),
                (4096, 1024): dict(lu_leaf=4, trtri=3),
                (1024, 4096): dict(lu_leaf=4, trtri=4)}
QR_TRTRI = 8 * 4 + 1
FLAGSHIP_TRTRI = 2 + 12 + 3 + 2
# phase 3's trtri: the checked sides; the timed (n, unit) blocks; the
# triangles whose 128-row diagonal blocks one batched launch inverts
TRTRI_SIZES = (1, 16, 17, 32, 100, 128)
TRTRI_TIMED = ((128, False), (128, True), (100, False), (100, True))
TRTRI_BATCHES = (4096, 4000)
TRTRI_REPS = 50
# operations per step of the sweep kernels' chains, counted from their source
SWEEP_STEP_FLOPS = {"tridiag_sweep": 28, "bidiag_sweep": 30}
# above this a call is timed once (its first call, host clock), not 1 +
# median of 3: the 4096 and 8192 × 2048 spectral calls (from 10 s, to make
# room for phase 15)
SPECTRAL_SLOW_S = 1.0
ORACLE_N = 1024  # spectral check against f64 eigvalsh / svdvals
DIRECT_N = 384  # below 512: the QR iteration without D&C
TALL = (8192, 2048)  # m/n > 11/6: the SVD's QR preprocessing
TILE = 128  # the Householder block, and the output tile side of syrk_lower_sub
TILE_REPS = 10  # phase 3's tile_matmul timings: per call and in a CUDA graph
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
# (trtri: one launch per inverse and per solve: the tall factor's 4 leaves'
# U11 inverses and 3 L11 inverses; the square one's 12 CALU leaves, 8
# panel couplings and 7 L11 inverses)
CALU_LAUNCHES = {CALU: dict(lu_panel_v2=8, lu_leaf=0, trtri=4 + 3),
                 (4000, 4000): dict(lu_panel_v2=24, lu_leaf=4, trtri=12 + 8 + 7)}
# phase 10's timing: each panel wrapper is called 1 + warmup + reps times a
# shape (tools/torch_qr_panels.py; 3 reps, from 10, to make room for phase 14)
LAB_REPS, LAB_WARMUP = 3, 1
WIDE = ((64, 200), (1000, 1024))  # phase 3's wide panels (m < b)
# phase 3's LLT blocks: the labs' sizes, ragged ones, both sides of the
# shared-memory edge (337), the largest; the regularized ones (b, the bad
# pivots, eps = delta); (b, b) views with a row stride of b + 3, as the
# recursive driver hands its leaves over, on both routes; the timed sizes,
# each per-call time the median of LLT_CALL_REPS calls and each device time
# a CUDA graph of LLT_GRAPH_REPS calls
LLT_BLOCKS = (128, 256, 512, 200, 80, 44, 337, 338, 1024)
LLT_REGULARIZED = ((128, (3, 20, 77), 1.0), (512, (3, 20, 509), 1.0),
                   (44, (3, 20, 41), 0.0))
LLT_STRIDED = (125, 338)
LLT_TIMED = (128, 256, 512)
LLT_CALL_REPS = 20
LLT_GRAPH_REPS = 30
# phase 3's chase cases (b, g, steps): one and eight cycles of the three
# windows; the values grow with the steps (the strip is not symmetric), so
# the kernel is held to its plain version at these short step counts only;
# chase_cases adds both sides of the kernel's route edge
CHASE_CASES = ((64, 1, 3), (64, 4, 24), (128, 8, 24))
CHASE_REPS = 20  # phase 3's chase timings: per call and in a CUDA graph
# phases 11 and 12: each timed call 1 + warmup + reps times (the LLT lab at
# 3 reps, from 10, and the chase lab at 3, from 5, to make room for phase 14)
LLT_LAB_REPS, LLT_LAB_WARMUP = 3, 1
CHASE_LAB_REPS, CHASE_LAB_WARMUP = 3, 1
# phase 13: the PSD rank of the pivoted LLT's input, the rank-update width
DENSE_RANK = 3072
DENSE_R = 8
# launches per float32 call of phase 13 at N (PERF.md §6), counted from the
# drivers' control flow, which does not depend on the data; every counter
# not named is 0, and every float64 call launches nothing: LDLT's 16 panels
# of 256 make 15 L21 solves, one batched trtri launch each; a solve of 8
# rhs, 2 (its two triangular solves); the column-pivoted QR's lstsq and
# reconstruct form the T factors of 128 panels of 32 (one trtri each) and
# the lstsq solves R once; llt() is the fused route (16 llt_panel calls)
DENSE_LAUNCHES = {
    "ldlt()": dict(trtri=15), "ldlt().solve": dict(trtri=2),
    "piv_llt().solve": dict(trtri=2), "lblt().solve": dict(trtri=2),
    "full_piv_lu().solve": dict(trtri=2),
    "col_piv_qr().solve_lstsq": dict(trtri=128 + 1),
    "col_piv_qr().reconstruct()": dict(trtri=128), "llt()": dict(llt_panel=16),
}
DENSE_WARM_N = 160  # each call once at this size first: loads and first allocations
# phase 3's real_schur cases (n, batch): the multishift driver's AED windows
# below n = 590 (48) and up to 3000 (96), a batch of the smallest blocks; the
# shared-memory edge and the next size join them (real_schur_cases)
SCHUR_CASES = ((48, 4), (96, 2), (16, 8))
SCHUR_REPS = 20  # the timed window: per call and in a CUDA graph
# operations of one chase step of the real_schur kernel at width n, counted
# from its source: the row update (n − i + 1 columns) and the column update
# (i + 4 rows of H) together n + 5 columns or rows, and Q's n rows, 12 flops
# each (w: 2 products, 2 sums; the three updates: 2, 3 and 3), plus 25 for
# the reflector; and per iteration the deflation test, 5 flops an entry of
# the subdiagonal
def schur_step_flops(n: int) -> int:
    return 12 * (2 * n + 5) + 25


# phase 3's hess_tri and real_qz cases (n, batch): the trivial sizes, a
# batch of 16s, 48 and 96; gevd_cases adds both sides of each kernel's
# shared-memory edge, the rank-deficient B and the ragged batch
GEVD_CASES = ((1, 2), (2, 2), (3, 3), (16, 3), (48, 1), (96, 1))
GEVD_RAGGED = (40, (40, 7, 1, 0, 33))  # (nmax, sizes)
GEVD_WORKERS = 6  # processes that run the plain versions on the host
# the most threads a CTA of the spectral kernels has (kMaxThreads of
# csrc/spectral_qr.cuh); phase 3's cases past it: the main path's width in
# float32, and 600 in float64 (their plain versions take minutes of a host
# core, so they run beside phases 4–14)
CTA_THREADS = 512
GEVD_WIDE = ((1024, torch.float32), (600, torch.float64))
GEVD_REPS = 5  # the timed pencil at 96: per call and in a CUDA graph


# operations of the hess_tri kernel's chain at n, counted from its source:
# pair (j, i) rotates pairs of entries in H's columns j..n−1, R's i..n−1 and
# Q's n rows, then in R's rows 0..i+1 and H's and Z's n rows, 5n − j + 2
# pairs, 6 flops each, plus 20 for the two rotations; column j has n − 2 − j
# pairs
def hess_tri_flops(n: int) -> int:
    return sum((n - 2 - j) * (6 * (5 * n - j + 2) + 20) for j in range(n - 2))


# operations of one chase step of the real_qz kernel at width n, counted
# from its source: the left reflector on 3 rows of H (n − i + 1 columns), of
# T (n − i) and of Qᵀ (n), 12 flops a column; the reversed reflector and the
# rotation on the columns of H (i + 4 rows), T (i + 3) and Zᵀ (n), 18 flops
# a row; 60 for the two reflectors and the rotation; with i at n/2, the
# mean over a sweep of the whole pencil; and per iteration the deflation
# tests, 6 flops a row
def qz_step_flops(n: int) -> int:
    i = n // 2
    return 12 * (3 * n - 2 * i + 1) + 18 * (n + 2 * i + 7) + 60


# phase 14: the general EVD at full width (ns = 64, AED window 96 by
# _params_for), the multishift route edge, and the f64 spectral calls (D&C
# at 1024, the direct QR route at DIRECT_N)
GEVD_N = 1024
# the float64 evd and eigenvalues run at 512 (at 1024 until phase 17 made
# room for itself: a cut of depth, ns = 32 and w = 48 there)
GEVD_F64_N = 512
GEVD_EDGE = (127, 128)
F64_SPECTRAL = (1024, DIRECT_N)
# phase 15: the generalized EVD at full width (one hess_tri and one real_qz
# launch a call); a B of rank 192 at 256 (64 infinite eigenvalues); the
# reduction method at 512; the self-adjoint-definite pencil at 1024; the
# facade once
GEVD_RANK = (256, 192)
GEVD_REDUCTION_N = 512
GEVD_SA_N = 1024
GEVD_FACADE_N = 256
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


def lower_floats(n: int, unit: bool = False) -> int:
    """The entries of an (n, n) lower triangle that a kernel must read: the
    diagonal too unless it is taken as 1 (``unit``)."""
    return n * (n - 1) // 2 if unit else n * (n + 1) // 2


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


def phase_build() -> dict:
    """Build the kernels, and beside them the LU and LLT panel kernels'
    profile builds (``tools/torch_profile.py``'s, which can force the LU
    panel's grid route and the LLT panel's rows into global memory) for
    phase 3's checks of each kernel's routes against each other. Returns
    those builds' libraries by kernel."""
    from faer_tpu_torch.ops.kernels import _build

    prof = _tool("torch_profile")
    builds = {}
    for kernel in ("lu", "llt_panel"):
        cmd, so = prof.profile_build(kernel)
        builds[kernel] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                               stderr=subprocess.STDOUT, text=True))
    _build.build(extra_flags=("-Xptxas", "-v"))
    _build.library()
    for kernel, (so, proc) in builds.items():
        out, _ = proc.communicate()
        check(proc.returncode == 0, f"the {kernel} kernel's profile build: nvcc returned "
                                    f"{proc.returncode} {out[-2000:]}")
    secs = _build.build_seconds
    print(f"build: {'reused' if secs is None else f'{secs:.1f} s'} -> "
          f"{_build._library_path().name}")
    # the full -Xptxas -v report goes beside the library
    with open(_build.BUILD_DIR / "ptxas.log", "w") as f:
        f.write(_build.build_log)
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print("ptxas:", line.strip())
    # how many 16- and 8-CTA clusters of the QR kernel (one CTA of 512
    # threads at the most shared memory on each SM) the card places at once
    import ctypes

    most, active = ctypes.c_int(), ctypes.c_int()
    for size in (16, 8):
        code = _build.library().faer_qr_panel_clusters(size, ctypes.byref(most),
                                                       ctypes.byref(active))
        check(code == 0 and most.value >= 1,
              f"qr_panel clusters: {active.value} of {size} CTAs at once "
              f"(cudaOccupancyMaxActiveClusters); the cluster route takes up to "
              f"{most.value} CTAs")
    # the same for the LU panel kernel (one CTA of 256 threads at the most
    # shared memory on each SM): how many panels of a batch run at once
    for size in (16, 8):
        code = _build.library().faer_lu_panel_clusters(size, ctypes.byref(most),
                                                       ctypes.byref(active))
        check(code == 0 and most.value >= 1,
              f"lu_panel clusters: {active.value} of {size} CTAs at once "
              f"(cudaOccupancyMaxActiveClusters); the cluster route takes up to "
              f"{most.value} CTAs")
    return {kernel: prof.load(kernel, so) for kernel, (so, _) in builds.items()}


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
    rounding. A wide panel (m < b) has an (m, m) L and an (m, b) U."""
    k = min(m, b)
    lo = (torch.rand(m, k, generator=gen, device=DEV) - 0.5) / b ** 0.5
    lo = torch.tril(lo, -1) + torch.eye(m, k, device=DEV)
    up = torch.triu(torch.randn(k, b, generator=gen, device=DEV), 1) / b ** 0.5
    up = up + torch.eye(k, b, device=DEV) * (
        1.0 + torch.rand(k, generator=gen, device=DEV))[:, None]
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


def _structured64(t, unit: bool) -> torch.Tensor:
    """The f64 lower-triangular matrix that ``trtri`` inverts for ``t``."""
    n = t.shape[0]
    return torch.tril(t.double(), -1) + (
        torch.eye(n, dtype=torch.float64, device=t.device) if unit
        else torch.diag(torch.diagonal(t).double()))


def _trtri_views(lo, gen) -> dict:
    """The same lower triangle contiguous, as an (n, n) view with row stride
    n + 3 (as a factorization's sub-block lies), and as the ``.mT`` view of its
    contiguous transpose (as an upper solve reads its operand)."""
    n = lo.shape[0]
    buf = torch.randn(n + 3, n + 3, generator=gen, device=DEV)
    buf[:n, :n] = lo
    return {"contiguous": lo.contiguous(), "row stride n+3": buf[:n, :n],
            "transposed": lo.mT.contiguous().mT}


def _trtri_kernel(gen) -> dict:
    """``trtri`` (row 1, ``csrc/trtri.cu``): one block at ``TRTRI_SIZES``,
    unit and not, within 8·n·eps·κ₂(L) (a forward error, relative to
    max|L⁻¹|) of its plain version, of the kernel's own order
    (``trtri_blocked_plain``) and of an f64 inverse, zero above the
    diagonal; then one batched launch over the 128-row diagonal blocks of a
    ``TRTRI_BATCHES`` triangle (32 blocks; 31 and a ragged 32) read through
    three views, each slot within the same bound of ``trtri_batched_plain``,
    every view's bits the same and each slot's the bits of a single launch.
    Timed per call (``cuda_ms``) and on the device (``graph_ms``) at
    ``TRTRI_TIMED`` and batched, beside ``solve_triangular(L, I)`` on one
    block and on the (32, 128, 128) batch."""
    from faer_tpu_torch.ops.kernels.trtri import (
        trtri, trtri_batched, trtri_batched_plain, trtri_blocked_plain, trtri_plain)

    errs = []
    for n in TRTRI_SIZES:
        for unit in (False, True):
            t = _trtri_block(n, unit, gen)
            got, want = trtri(t, unit=unit), trtri_plain(t, unit=unit)
            torch.cuda.synchronize()
            lo64 = _structured64(t, unit)
            tol = 8 * n * EPS32 * torch.linalg.cond(lo64).item()
            err, rel = _max_rel(got, want)
            _, relb = _max_rel(got, trtri_blocked_plain(t, unit=unit))
            _, rel64 = _max_rel(got.double(), torch.linalg.inv(lo64))
            errs.append(err)
            check(rel <= tol and relb <= tol and rel64 <= tol
                  and bool((torch.triu(got, 1) == 0).all()),
                  f"trtri n={n} unit={unit}: max abs err {err:.3e}, rel {rel:.3e} "
                  f"vs plain, {relb:.3e} vs the blocked order, {rel64:.3e} vs f64 "
                  f"<= tol {tol:.3e}")
    batches = {}
    for n in TRTRI_BATCHES:
        blocks = [(o, min(128, n - o)) for o in range(0, n, 128)]
        lo = torch.linalg.cholesky(_spd(n, gen)) + torch.triu(
            torch.randn(n, n, generator=gen, device=DEV), 1)
        views = _trtri_views(lo, gen)
        first = None
        for name, t in views.items():
            got = trtri_batched(t, blocks)
            torch.cuda.synchronize()
            if first is None:
                first, want = got, trtri_batched_plain(t, blocks)
                worst = 0.0
                for i, (o, sz) in enumerate(blocks):
                    lo64 = _structured64(t[o:o + sz, o:o + sz], False)
                    tol = 8 * sz * EPS32 * torch.linalg.cond(lo64).item()
                    err, rel = _max_rel(got[i, :sz, :sz], want[i, :sz, :sz])
                    errs.append(err)
                    worst = max(worst, rel / tol)
                check(worst <= 1.0 and not got[-1, blocks[-1][1]:].any(),
                      f"trtri_batched n={n}, {len(blocks)} blocks (last {blocks[-1][1]}): "
                      f"every slot within 8 s eps cond of the plain version (largest "
                      f"{worst:.3e} of its bound), zero past its size")
            singles = all(torch.equal(got[i, :sz, :sz], trtri(t[o:o + sz, o:o + sz]))
                          for i, (o, sz) in enumerate(blocks))
            check(torch.equal(got, first) and singles,
                  f"trtri_batched n={n} [{name}]: the bits of the contiguous view "
                  f"and of {len(blocks)} single launches")
        batches[n] = (views["contiguous"], blocks)

    row = dict(max_abs_err=max(errs))
    eye = torch.eye(128, device=DEV)
    for n, unit in TRTRI_TIMED:
        t = _trtri_block(n, unit, gen)
        call = lambda: trtri(t, unit=unit)
        ms, dev = cuda_ms(call, TRTRI_REPS), graph_ms(call, TRTRI_REPS)
        print(f"time trtri n={n} unit={unit}: per call {ms:.4f} ms, device {dev:.4f} ms")
        if (n, unit) == TRTRI_TIMED[0]:
            lib = lambda: torch.linalg.solve_triangular(torch.tril(t), eye, upper=False)
            row.update(ms=ms, device_ms=dev, plain_ms=cuda_ms(lambda: trtri_plain(t), 3),
                       library_ms=cuda_ms(lib, TRTRI_REPS),
                       library_device_ms=graph_ms(lib, TRTRI_REPS),
                       # the lower triangle read once, the (n, n) inverse written
                       **bound_of(128 ** 3 / 3, 4 * (lower_floats(128) + 128 * 128)))
    for n, (t, blocks) in batches.items():
        call = lambda: trtri_batched(t, blocks)
        ms, dev = cuda_ms(call, TRTRI_REPS), graph_ms(call, TRTRI_REPS)
        k = len(blocks)
        # each block's lower triangle read once, each 128 × 128 slot written once
        b = bound_of(sum(sz ** 3 / 3 for _, sz in blocks),
                     4 * sum(lower_floats(sz) + 128 * 128 for _, sz in blocks))
        print(f"time trtri_batched n={n} ({k} blocks): per call {ms:.4f} ms, device "
              f"{dev:.4f} ms; bound {b['bound_ms']:.6g} ms ({b['bound_by']})")
        if n == TRTRI_BATCHES[0]:
            stack = torch.stack([torch.tril(t[o:o + sz, o:o + sz]) for o, sz in blocks
                                 if sz == 128])
            lib = lambda: torch.linalg.solve_triangular(stack, eye, upper=False)
            row.update(batched_ms=ms, batched_device_ms=dev, batched_bound_ms=b["bound_ms"],
                       batched_library_ms=cuda_ms(lib, TRTRI_REPS),
                       batched_library_device_ms=graph_ms(lib, TRTRI_REPS))
    print(f"time solve_triangular(L, I) n=128: per call {row['library_ms']:.4f} ms, "
          f"device {row['library_device_ms']:.4f} ms; on the (32, 128, 128) batch "
          f"{row['batched_library_ms']:.4f} / {row['batched_library_device_ms']:.4f} ms; "
          f"trtri_plain {row['plain_ms']:.4f} ms; bound {row['bound_ms']:.6g} ms "
          f"({row['bound_by']}), batched {row['batched_bound_ms']:.6g} ms")
    return row


def _regularized_spd(b: int, bad, gen) -> torch.Tensor:
    """A = L Lᵀ − 1e-3·Σ e_k e_kᵀ over the ``bad`` columns k, where L's
    column k is 0 and its diagonal elsewhere in [1.5, 2.5]: the bad pivots
    are clearly negative and every other pivot is at least 2.25 under any
    rounding, whatever replaces a bad pivot. (With only L's diagonal 0 at
    k, a bad pivot replaced by 1 leaves L[:, k]'s products in the later
    pivots, and one of them can cancel to a tiny positive pivot whose
    rounding the factor amplifies.)"""
    lo = torch.tril(torch.randn(b, b, generator=gen, device=DEV) / b ** 0.5, -1)
    diag = 1.5 + torch.rand(b, generator=gen, device=DEV)
    lo = lo + torch.diag(diag)
    lo[:, bad] = 0.0
    a = lo @ lo.T
    a[bad, bad] -= 1e-3
    return a


def _llt_slab(m: int, b: int, gen) -> torch.Tensor:
    """An (m, b) LLT panel slab [A11; A21]: A11 = g gᵀ/b + I (cond ≤ 5 or
    so), A21 Gaussian."""
    return torch.cat([_spd(b, gen), torch.randn(m - b, b, generator=gen, device=DEV)])


def llt_pair(slab):
    """The LLT panel's yardstick, two library calls on the same slab:
    L11 = ``cholesky_ex(A11)``, then L21 = A21·L11⁻ᵀ by
    ``solve_triangular``."""
    b = slab.shape[1]
    l11 = torch.linalg.cholesky_ex(slab[:b])[0]
    return l11, torch.linalg.solve_triangular(l11.mT, slab[b:], upper=True, left=False)


# phase 3's LLT panels (m, b): b from 32 to 512 at 4096 rows, m from b to
# 200 000 at b = 256 (65536 and 200 000 past shared memory, the rows in
# global memory), ragged m, and the regularized ones (m, b, bad pivots);
# llt_panel_cases adds both sides of the shared-memory edge at b = 256 and
# 512. Each is held against llt_panel_plain and the kernel's own order.
LLT_PANEL_SHAPES = ((4096, 32), (4096, 128), (4096, 256), (4096, 512), (256, 256),
                    (1000, 256), (65536, 256), (200000, 256), (1000, 64), (4000, 256))
LLT_PANEL_REGULARIZED = ((4096, 256, (3, 128, 255)), (4096, 512, (3, 300, 509)))
# the main path's views, row stride 1024 (pblock[:, :256] of a 1024-wide
# strip copy, linalg/cholesky.py)
LLT_PANEL_VIEWS = ((3840, 256), (1024, 256), (4096, 512))
# where the rows-in-shared-memory route is held against the rows forced
# into global memory, to the bit
LLT_PANEL_ROUTE_SHAPES = ((4096, 256), (256, 256), (1000, 64), (4096, 512))


def llt_panel_cases():
    """LLT_PANEL_SHAPES with both sides of the kernel's shared-memory edge,
    found from its own route (bisection) at b = 256 and 512."""
    from faer_tpu_torch.ops.kernels.llt_panel import shared_edge

    edges = tuple((shared_edge(b) + d, b) for b in (256, 512) for d in (0, 1))
    return LLT_PANEL_SHAPES + edges


def _llt_against_references(a, label: str, eps: float = 0.0, delta: float = 0.0,
                            bad: int = 0) -> float:
    """Hold ``llt_panel`` on one slab against ``llt_panel_plain`` (the Pallas
    body's math: within 8·b·eps of max|strip|) and the kernel's own order
    ``llt_panel_blocked_plain`` (within 16·eps: the same operations in the
    same order, its fma emulated in f64, which can round twice), with count
    and ok equal (``bad`` counted pivots, ok false when there are any), one
    launch; print the route. Returns the largest absolute difference from
    the plain version."""
    from faer_tpu_torch.core.config import launch_counts, reset_launch_counts
    from faer_tpu_torch.ops.kernels.llt_panel import (
        llt_panel, llt_panel_blocked_plain, llt_panel_plain, route_label)

    m, b = a.shape
    reset_launch_counts()
    s1, c1, o1 = llt_panel(a, eps=eps, delta=delta)
    torch.cuda.synchronize()
    one = launch_counts()["llt_panel"] == 1
    s2, c2, o2 = llt_panel_plain(a, eps=eps, delta=delta)
    s3, c3, o3 = llt_panel_blocked_plain(a, eps=eps, delta=delta)
    tol, tight = 8 * b * EPS32, 16 * EPS32
    err, rel = _max_rel(s1, s2)
    rel3 = _max_rel(s1, s3)[1]
    tally = int(c1) == int(c2) == int(c3) == bad and bool(o1) == bool(o2) == bool(o3) == (bad == 0)
    check(one and tally and bool(torch.isfinite(s1).all()) and rel <= tol and rel3 <= tight,
          f"llt_panel {label} [{route_label(m, b)}]: count {int(c1)} ({int(c2)}, {int(c3)}), "
          f"ok {bool(o1)}, max abs err {err:.3e}, rel {rel:.3e} <= {tol:.3e}; vs the "
          f"kernel's order rel {rel3:.3e} <= {tight:.3e}, bitwise equal {torch.equal(s1, s3)}")
    return err


def _llt_routes_bitwise(lib, gen) -> None:
    """The rows-in-shared-memory route against the rows forced into global
    memory (the profile build of the same source,
    ``faer_llt_panel_profile_force_global(1)``) on the same slabs, to the
    bit; and a prefix of a tall slab (rows in global memory) against the
    whole (rows in shared memory): every row's arithmetic is the same."""
    import ctypes

    from faer_tpu_torch.ops.kernels.llt_panel import llt_panel, route

    P, I = ctypes.c_void_p, ctypes.c_int
    lib.faer_llt_panel_route.argtypes = [I, I, P, P, P]
    lib.faer_llt_panel_profile_force_global.argtypes = [I]
    stream = torch.cuda.current_stream().cuda_stream
    for m, b in LLT_PANEL_ROUTE_SHAPES:
        a = _llt_slab(m, b, gen)
        s1, c1, o1 = llt_panel(a)
        lib.faer_llt_panel_profile_force_global(1)
        ctas, rpc, nscratch = ctypes.c_int(), ctypes.c_int(), ctypes.c_longlong()
        code = lib.faer_llt_panel_route(m, b, ctypes.byref(ctas), ctypes.byref(rpc),
                                        ctypes.byref(nscratch))
        s2 = torch.empty(m, b, device=DEV)
        cnt_ok = torch.empty(2, dtype=torch.int32, device=DEV)
        scratch = torch.empty(nscratch.value, device=DEV)
        launch = lib.faer_llt_panel(a.data_ptr(), b, s2.data_ptr(), scratch.data_ptr(),
                                    nscratch.value, cnt_ok.data_ptr(), m, b, 0.0, 0.0, stream)
        lib.faer_llt_panel_profile_force_global(0)
        torch.cuda.synchronize()
        same = torch.equal(s1, s2) and int(c1) == int(cnt_ok[0]) and bool(o1) == bool(cnt_ok[1])
        check(route(m, b)[0] == "rows in shared memory" and code == 0 and launch == 0 and same,
              f"llt_panel ({m}, {b}): the rows in shared memory ({route(m, b)[1]} CTAs) equal "
              f"the rows forced into global memory ({ctas.value} CTAs) to the bit: {same}")
    a = _llt_slab(200000, 256, gen)
    whole, prefix = llt_panel(a)[0], llt_panel(a[:4096])[0]
    torch.cuda.synchronize()
    check(torch.equal(whole[:4096], prefix),
          f"llt_panel (200000, 256) [{route(200000, 256)[0]}]: its first 4096 rows equal "
          f"llt_panel (4096, 256) [{route(4096, 256)[0]}] to the bit")


def _llt_panel_kernel(gen, lib) -> dict:
    """``llt_panel`` on both sides of every route edge (``llt_panel_cases``),
    regularized, on the main path's row-strided views, the routes against
    each other; then timed at (4096, 256) per call and on the device beside
    the two-call yardstick ``llt_pair``."""
    from faer_tpu_torch.ops.kernels.llt_panel import llt_panel, llt_panel_plain
    from faer_tpu_torch.utils import flops

    errs = []
    for m, b in llt_panel_cases():
        a = _llt_slab(m, b, gen)
        errs.append(_llt_against_references(a, f"({m}, {b})"))
        if m > 10000:
            print(f"time llt_panel ({m}, {b}): kernel {cuda_ms(lambda: llt_panel(a), 3):.4f} "
                  f"ms, cholesky_ex + solve_triangular (two calls) "
                  f"{cuda_ms(lambda: llt_pair(a), 3):.4f} ms")
    for m, b, bad in LLT_PANEL_REGULARIZED:
        a = torch.cat([_regularized_spd(b, list(bad), gen),
                       torch.randn(m - b, b, generator=gen, device=DEV)])
        errs.append(_llt_against_references(a, f"({m}, {b}) regularized", eps=1.0,
                                            delta=1e-2, bad=len(bad)))
    for m, b in LLT_PANEL_VIEWS:
        strip = torch.full((m, 1024), float("nan"), device=DEV)
        strip[:, :b] = _llt_slab(m, b, gen)
        view = strip[:, :b]
        errs.append(_llt_against_references(view, f"({m}, {b}) row stride 1024"))
        same = torch.equal(llt_panel(view)[0], llt_panel(view.contiguous())[0])
        check(same, f"llt_panel ({m}, {b}): the row-stride-1024 view equals its contiguous "
                    f"copy to the bit")
    _llt_routes_bitwise(lib, gen)
    a = _llt_slab(4096, 256, gen)
    row = dict(max_abs_err=max(errs), ms=cuda_ms(lambda: llt_panel(a), 20),
               device_ms=graph_ms(lambda: llt_panel(a), 20),
               plain_ms=cuda_ms(lambda: llt_panel_plain(a), 3),
               library_ms=cuda_ms(lambda: llt_pair(a), 20),
               library_device_ms=graph_ms(lambda: llt_pair(a), 20),
               **bound_of(flops.llt_flops(256) + flops.trsm_flops(256, 4096 - 256),
                          2 * 4096 * 256 * 4))
    print(f"time llt_panel (4096, 256): per call {row['ms']:.4f} ms, device "
          f"{row['device_ms']:.4f} ms; library: cholesky_ex + solve_triangular (two calls) "
          f"{row['library_ms']:.4f} / {row['library_device_ms']:.4f} ms")
    return row


def phase_kernels(gen, profs) -> dict:
    from faer_tpu_torch.ops.householder import apply_block_on_left, form_block_t
    from faer_tpu_torch.ops.kernels.leaf import lu_leaf, lu_leaf_plain
    from faer_tpu_torch.ops.kernels.lu_panel import lu_panel, lu_panel_plain
    from faer_tpu_torch.ops.kernels.qr_panel import qr_panel, qr_panel_plain
    from faer_tpu_torch.utils import flops

    t0 = time.perf_counter()

    def mark(what: str) -> None:
        print(f"phase 3: {what} done, {time.perf_counter() - t0:.1f} s in", flush=True)

    res = {"trtri": _trtri_kernel(gen)}
    res["llt_panel"] = _llt_panel_kernel(gen, profs["llt_panel"])
    mark("trtri and llt_panel")

    # lu_panel on both sides of every route edge of csrc/lu_panel_batched.cu
    # (lu_cases), held against its two plain versions; then the cluster
    # route against the grid route forced onto the same shapes
    errs = []
    for m, b in lu_cases():
        pan = _separated_panel(m, b, gen)
        errs.append(_lu_against_references(pan, lu_panel, lu_panel_plain, "lu_panel"))
        if m > 10000:
            print(f"time lu_panel ({m}, {b}): kernel "
                  f"{cuda_ms(lambda: lu_panel(pan), 3):.4f} ms, lu_factor_ex "
                  f"{cuda_ms(lambda: torch.linalg.lu_factor_ex(pan), 3):.4f} ms")
    _lu_routes_bitwise(profs["lu"], gen)
    pan = torch.randn(4096, 256, generator=gen, device=DEV)
    res["lu_panel"] = dict(
        max_abs_err=max(errs), ms=cuda_ms(lambda: lu_panel(pan), 10),
        plain_ms=cuda_ms(lambda: lu_panel_plain(pan), 3),
        library_ms=cuda_ms(lambda: torch.linalg.lu_factor_ex(pan), 10),
        **bound_of(flops.lu_flops(4096, 256), 2 * 4096 * 256 * 4 + 4096 * 8))

    # qr_panel on both sides of every route edge (qr_cases), against the plain
    # version, the kernel's one-pass order and torch.geqrf (the same larfg
    # signs): R and the reflector tails V each within 8·m·eps relative to
    # their own largest entry, τ within 8·m·eps; Q = I − V T Vᵀ orthogonal,
    # and ‖Q·R − A‖/‖A‖, to 8·m·eps. Gaussian panels (m ≥ 4b, so κ ≤ 3) and
    # one with an all-zero column (τ = 0 there)
    errs = []
    for m, b, zero in qr_cases():
        a = _qr_case_panel(m, b, zero, gen)
        k1, t1 = qr_panel(a)
        torch.cuda.synchronize()
        errs.append(_qr_against_references(a, k1, t1, zero, f"qr_panel ({m}, {b})"))
        if m > 5000:  # the tall shapes, near and past the shared-memory edges
            print(f"time qr_panel ({m}, {b}): kernel "
                  f"{cuda_ms(lambda: qr_panel(a), 3):.4f} ms, geqrf "
                  f"{cuda_ms(lambda: torch.geqrf(a), 3):.4f} ms")
    pq = torch.randn(4096, 128, generator=gen, device=DEV)
    res["qr_panel"] = dict(
        max_abs_err=max(errs), ms=cuda_ms(lambda: qr_panel(pq), 10),
        plain_ms=cuda_ms(lambda: qr_panel_plain(pq), 3),
        library_ms=cuda_ms(lambda: torch.geqrf(pq), 10),
        **bound_of(flops.qr_flops(4096, 128), 2 * 4096 * 128 * 4 + 128 * 4))

    # lu_leaf: separated pivots, held like lu_panel
    errs = []
    for m, b in ((4000, 256), (1000, 64), (44, 44)):
        pan = _separated_panel(m, b, gen)
        errs.append(_lu_against_references(pan, lu_leaf, lu_leaf_plain, "lu_leaf"))
    pan = torch.randn(4000, 256, generator=gen, device=DEV)
    res["lu_leaf"] = dict(
        max_abs_err=max(errs), ms=cuda_ms(lambda: lu_leaf(pan), 10),
        plain_ms=cuda_ms(lambda: lu_leaf_plain(pan), 3),
        library_ms=cuda_ms(lambda: torch.linalg.lu_factor_ex(pan), 10),
        **bound_of(flops.lu_flops(4000, 256), 2 * 4000 * 256 * 4 + 4000 * 8))
    mark("lu_panel, qr_panel and lu_leaf")
    res.update(_lu_panel_family(gen))
    res.update(_qr_panel_family(gen))
    _qr_subnormal(gen)
    _wide_panels(gen)
    mark("the panel families and the wide panels")
    res.update(_qr_batched_kernels(gen))
    _qr_batched_kernels_f64(gen, res)
    mark("the sweep kernels")
    res.update(_real_schur_kernel(gen))
    mark("real_schur")
    res.update(_gevd_kernels(gen))
    mark("hess_tri and real_qz")
    res.update(_complex_schur_kernel(gen))
    mark("complex_schur")
    res.update(_complex_gevd_kernels(gen))
    mark("complex_hess_tri and complex_qz")
    res.update(_tile_kernels(gen))
    mark("the tile kernels")
    res.update(_llt_block_kernels(gen))
    res.update(_chase_kernel(gen))
    mark("the LLT blocks and chase_probe")
    for name, r in res.items():
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
        print(f"time {name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} "
              f"ms, library {lib}, bound {r['bound_ms']:.6g} ms ({r['bound_by']})")
    return res


def _lu_rec(a, packed, perm) -> float:
    """‖A[perm] − L·U‖ / ‖A‖ of a packed (m, b) panel factor (wide too)."""
    m, b = a.shape
    k = min(m, b)
    lo = torch.tril(packed[:, :k], -1) + torch.eye(m, k, device=DEV)
    return rel_norm(lo @ torch.triu(packed[:k]), a[perm])


# phase 3's LU panels (m, b), with lu_cases' route edges: the main path's
# (4096, 256) leaves and smaller, the off-route leaf (4000, 256), a narrow
# (1000, 64), the grid route at 40000 and 65536 rows (the default gate's
# tall leaves), and at 200000 rows, past the working blocks' room in
# shared memory one CTA an SM (the grid route with W in global memory)
LU_SHAPES = ((256, 256), (1024, 256), (4096, 256), (4000, 256), (1000, 64), (40000, 256),
             (65536, 256), (200000, 256))


def lu_cases():
    """LU_SHAPES with both sides of the LU panel kernel's cluster route edge,
    found from its own route (bisection): the largest m of the cluster route
    at b = 256 and 64, each and one past it."""
    from faer_tpu_torch.ops.kernels.lu_panel import cluster_edge

    e256, e64 = cluster_edge(256), cluster_edge(64)
    return LU_SHAPES + ((e256, 256), (e256 + 1, 256), (e64, 64), (e64 + 1, 64))


def _lu_against_references(a, kern, plain, name: str) -> float:
    """Hold one LU wrapper's factor of a panel with separated pivots against
    its plain version (the Pallas body's order: perm, nt and ok equal,
    packed within 8·m·eps of max|packed|) and against the kernel's own order
    ``lu_panel_blocked_plain`` (perm, nt and ok equal, packed within 16·eps:
    the same operations in the same order, its fma emulated in f64); print
    the route. Returns the largest absolute difference from the plain
    version."""
    from faer_tpu_torch.ops.kernels.lu_panel import lu_panel_blocked_plain, route_label

    m, b = a.shape
    (k1, p1, n1, o1), (k2, p2, n2, o2) = kern(a), plain(a)
    k3, p3, n3, o3 = lu_panel_blocked_plain(a)
    torch.cuda.synchronize()
    tol, tight = 8 * m * EPS32, 16 * EPS32
    err, rel = _max_rel(k1, k2)
    rel3 = _max_rel(k1, k3)[1]
    same = bool((p1 == p2).all()) and bool((p1 == p3).all())
    check(same and int(n1) == int(n2) == int(n3) and bool(o1) and bool(o2) and bool(o3)
          and rel <= tol and rel3 <= tight,
          f"{name} ({m}, {b}) [{route_label(m, b)}]: perm equal {same}, nt {int(n1)} vs "
          f"{int(n2)}, {int(n3)}, ok {bool(o1)}, max abs err {err:.3e}, rel {rel:.3e} <= "
          f"{tol:.3e}; vs the kernel's order rel {rel3:.3e} <= {tight:.3e}, bitwise equal "
          f"{torch.equal(k1, k3)}")
    return err


# the shapes at which the cluster route's result is held against the grid
# route's, forced by the profile build: the main path's leaf, 128 rows a
# CTA, ragged
LU_ROUTE_SHAPES = ((4096, 256), (2048, 256), (1000, 100))


def _lu_routes_bitwise(lib, gen) -> None:
    """The cluster route against the grid route on the same shapes, to the
    bit: ``lu_panel`` (cluster) against the profile build of the same
    source with ``faer_lu_panel_profile_force_grid(1)`` (every shape on the
    grid route), each row's arithmetic the same on both. packed, perm, nt
    and ok equal."""
    import ctypes

    from faer_tpu_torch.ops.kernels.lu_panel import lu_panel, route

    P, I = ctypes.c_void_p, ctypes.c_int
    lib.faer_lu_panel_route.argtypes = [I, I, I, P, P]
    lib.faer_lu_panel_profile_force_grid.argtypes = [I]
    stream = torch.cuda.current_stream().cuda_stream
    for m, b in LU_ROUTE_SHAPES:
        a = torch.randn(m, b, generator=gen, device=DEV)
        k1, p1, n1, o1 = lu_panel(a)
        lib.faer_lu_panel_profile_force_grid(1)
        ctas, nscratch = ctypes.c_int(), ctypes.c_longlong()
        code = lib.faer_lu_panel_route(1, m, b, ctypes.byref(ctas), ctypes.byref(nscratch))
        k2 = torch.empty(m, b, device=DEV)
        p2 = torch.empty(m, dtype=torch.long, device=DEV)
        n2 = torch.empty(1, dtype=torch.int32, device=DEV)
        o2 = torch.empty(1, dtype=torch.bool, device=DEV)
        scratch = torch.empty(nscratch.value, device=DEV)
        launch = lib.faer_lu_panel_batched(a.data_ptr(), m * b, b, k2.data_ptr(),
                                           p2.data_ptr(), n2.data_ptr(), o2.data_ptr(),
                                           scratch.data_ptr(), nscratch.value, 1, m, b, stream)
        lib.faer_lu_panel_profile_force_grid(0)
        torch.cuda.synchronize()
        same = (torch.equal(k1, k2) and torch.equal(p1, p2) and int(n1) == int(n2[0])
                and bool(o1) == bool(o2[0]))
        check(route(m, b)[0] == "cluster" and code == 0 and launch == 0 and same,
              f"lu_panel ({m}, {b}): the cluster route ({route(m, b)[1]} CTAs) equals the "
              f"grid route forced onto it ({ctas.value} CTAs) to the bit: {same}")


def _lu_panel_family(gen) -> dict:
    """``lu_panel_v2`` (one panel, and a batch in one launch), ``lu_panel_v3``
    and ``lu_panel_swap`` against their plain versions on separated pivots:
    perm, nt and ok exactly, packed within 8·m·eps of its largest entry, and
    ‖A[perm] − LU‖/‖A‖ ≤ 8·m·eps; ``lu_panel_swap`` packed to the bit, on
    Gaussian panels too (``LU_SWAP_GAUSSIAN``, both routes). Shapes: the
    CALU group (4096, 256), 16 of them in one batched launch, the v1
    kernel's measured shape (4096, 128), and ragged (1000, 100) panels.
    Timed on Gaussian panels beside ``torch.linalg.lu_factor_ex`` on the
    same panel (or the same batch), ``lu_panel_swap`` on the device too."""
    from faer_tpu_torch.ops.kernels.lu_panel import lu_panel_blocked_plain, route_label
    from faer_tpu_torch.ops.kernels.lu_panel_swap import lu_panel_swap, lu_panel_swap_plain
    from faer_tpu_torch.ops.kernels.lu_panel_swap import route as swap_route
    from faer_tpu_torch.ops.kernels.lu_panel_v2 import (
        lu_panel_v2, lu_panel_v2_batched, lu_panel_v2_batched_plain, lu_panel_v2_plain)
    from faer_tpu_torch.ops.kernels.lu_panel_v3 import lu_panel_v3, lu_panel_v3_plain
    from faer_tpu_torch.utils import flops

    def held(name, k1, p1, n1, o1, k2, p2, n2, o2, a) -> float:
        """Against the plain version; the kernels of csrc/lu_panel_batched.cu
        also against their own order, ``lu_panel_blocked_plain`` (16·eps);
        ``lu_panel_swap``, which repeats its plain version's operations one
        by one, to the bit (packed, perm, nt, ok), and its route printed."""
        m, b = a.shape
        tol, tight = 8 * m * EPS32, 16 * EPS32
        err, rel = _max_rel(k1, k2)
        rec = _lu_rec(a, k1, p1)
        same = bool((p1 == p2).all())
        if name == "lu_panel_swap":
            ours = torch.equal(k1, k2) and bool(o1) == bool(o2)
            tail = f"; bitwise equal {ours} [{swap_route(m, b, DEV)[0]} route]"
        else:
            k3, p3, n3, _ = lu_panel_blocked_plain(a)
            rel3 = _max_rel(k1, k3)[1]
            ours = bool((p1 == p3).all()) and int(n1) == int(n3) and rel3 <= tight
            tail = (f"; vs the kernel's order rel {rel3:.3e} <= {tight:.3e}, bitwise equal "
                    f"{torch.equal(k1, k3)}")
        check(same and ours and int(n1) == int(n2) and bool(o1) and bool(o2) and rel <= tol
              and rec <= tol,
              f"{name} ({m}, {b}): perm equal {same}, nt {int(n1)} vs {int(n2)}, ok "
              f"{bool(o1)}, max abs err {err:.3e}, rel {rel:.3e}; |A[perm]-LU|/|A| "
              f"{rec:.3e}; <= tol {tol:.3e}" + tail)
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
        if name == "lu_panel_swap":
            res[name]["graph_ms"] = graph_ms(lambda: kern(pan), 10)
    # lu_panel_swap to the bit on Gaussian panels too, on both routes (the
    # grid route with its rows in shared memory and in global memory), and
    # timed on the device (a CUDA graph) beside its per-call time
    for m, b in LU_SWAP_GAUSSIAN:
        a = torch.randn(m, b, generator=gen, device=DEV)
        out1, out2 = lu_panel_swap(a), lu_panel_swap_plain(a)
        torch.cuda.synchronize()
        same = all(torch.equal(x, y) for x, y in zip(out1[:2], out2[:2]))
        check(same and int(out1[2]) == int(out2[2]) and bool(out1[3]) == bool(out2[3]),
              f"lu_panel_swap ({m}, {b}) Gaussian [{swap_route(m, b, DEV)[0]} route]: packed, "
              f"perm, nt, ok equal to the plain version's to the bit: {same}")
    r = res["lu_panel_swap"]
    print(f"time lu_panel_swap (4096, 128): per call {r['ms']:.4f} ms, device "
          f"{r['graph_ms']:.4f} ms, lu_factor_ex {r['library_ms']:.4f} ms per call")

    # the batch: each panel held against its plain version, and equal to the
    # one-panel launch to the bit (the same arithmetic on every row); 16 x
    # (12288, 256) is a batch the grid route cannot hold one CTA an SM, so
    # it takes the cluster route past its edge where each panel alone takes
    # the grid route
    for g, m, b in ((16, 4096, 256), (5, 1000, 100), (16, 12288, 256)):
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
    for g, m in ((1, 4096), (16, 4096), (1, 40000), (1, 65536), (1, 200000), (16, 1000),
                 (16, 12288)):
        print(f"lu_panel_batched for {g} x ({m}, 256): {route_label(m, 256, None, g)} a panel")
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


# lu_panel_swap's Gaussian panels held to the bit: the cluster route's
# measured shape, the grid route with its rows in shared memory, and in
# global memory
LU_SWAP_GAUSSIAN = ((4096, 128), (4096, 256), (40000, 256))

QR_FAMILY = ("qr_panel_v1", "qr_panel_v2", "qr_panel_v3", "qr_leaf")
# phase 3's QR panels (m, b, all-zero column): small, the leaves of a 4096²
# QR, both sides of the cluster route's largest m at b = 128 (found from
# the kernel's own route, qr_panel.cluster_edge), the grid route with its
# rows in shared memory and past it, b = 256 and 512; a zero column on each
# route (the grid's in shared memory and in global memory too)
QR_SHAPES = ((128, 128, None), (200, 44, 5), (1000, 128, None), (3968, 128, None),
             (4096, 128, None), (4096, 256, None), (8192, 128, None), (8192, 128, 5),
             (57000, 128, None), (60000, 128, None), (60000, 128, 100), (16384, 512, None))


def qr_cases():
    """QR_SHAPES with the cluster route's edge at b = 128 and one past it."""
    from faer_tpu_torch.ops.kernels.qr_panel import cluster_edge

    edge = cluster_edge(128)
    return QR_SHAPES[:5] + ((edge, 128, None), (edge + 1, 128, None)) + QR_SHAPES[5:]


def _qr_case_panel(m: int, b: int, zero, gen) -> torch.Tensor:
    a = torch.randn(m, b, generator=gen, device=DEV)
    if zero is not None:
        a[:, zero] = 0.0
    return a


def _qr_against_references(a, k1, t1, zero, label: str) -> float:
    """Hold a packed panel factor (k1, t1) of a tall Gaussian panel against
    ``qr_panel_plain``, the kernel's one-pass order and ``torch.geqrf``, and
    check Q orthogonal and Q·R = A; print the route. A panel with an
    all-zero column is held against the host's LAPACK geqrf: the card's
    returns τ ≈ 2 there for tall panels (another valid reflector, not
    larfg's τ = 0). Returns the largest absolute difference from
    ``qr_panel_plain``'s packed panel."""
    from faer_tpu_torch.ops.householder import apply_block_on_left, form_block_t
    from faer_tpu_torch.ops.kernels.qr_panel import (
        qr_panel_onepass_plain, qr_panel_plain, route)

    m, b = a.shape
    name, ctas, _ = route(m, b)
    tol = 8 * m * EPS32
    refs = {"plain": qr_panel_plain(a), "one-pass": qr_panel_onepass_plain(a)}
    if zero is None:
        refs["geqrf"] = torch.geqrf(a)
    else:
        refs["host geqrf"] = tuple(x.to(DEV) for x in torch.geqrf(a.cpu()))
    r1, v1 = torch.triu(k1[:b]), torch.tril(k1, -1)
    errs = {}
    for ref, (k, t) in refs.items():
        errs[ref] = max(_max_rel(r1, torch.triu(k[:b]))[1],
                        _max_rel(v1, torch.tril(k, -1))[1], (t1 - t).abs().max().item())
    v = v1 + torch.eye(m, b, device=DEV)
    q = apply_block_on_left(v, form_block_t(v, t1), torch.eye(m, b, device=DEV),
                            adjoint=False)
    orth = (q.T @ q - torch.eye(b, device=DEV)).abs().max().item()
    rec = rel_norm(q @ r1, a)
    zero_ok = zero is None or (t1[zero].item() == 0.0
                               and bool((k1[zero:, zero] == 0).all()))
    check(max(*errs.values(), orth, rec) <= tol and zero_ok,
          f"{label}{' zero column' if zero is not None else ''} [{name} route, {ctas} "
          f"CTAs]: rel err (R, V, τ) vs " + ", ".join(f"{k} {e:.3e}" for k, e in errs.items())
          + f"; |QᵀQ-I| {orth:.3e}, |QR-A|/|A| {rec:.3e}; all <= {tol:.3e}")
    return (k1 - refs["plain"][0]).abs().max().item()


QR_TINY = 1e-20  # F2's scale: a Gaussian panel's squares are subnormal in f32


def _qr_subnormal(gen) -> None:
    """F2: the QR panel kernel on Gaussian panels scaled by 1e-20, whose
    f32 squares are subnormal, on the cluster route (4096, 128) and the
    grid route (one past the cluster edge at b = 128, and 60000 rows, past
    the grid's shared memory): R and V each within 2·b·eps of their own
    largest entry and τ within 2·b·eps of ``qr_panel_plain`` and of the
    kernel's one-pass order (whose column loop rescales as the kernel
    does), max|QᵀQ − I| and ‖QR − A‖/‖A‖ within 2·b·eps in f64 (the whole
    Q up to 8192 rows, its first b columns past that); every wrapper of
    the family equal to ``qr_panel`` to the bit. (The routes' sums run in
    different orders, so no two of them, and no plain version, are bitwise
    twins at any scale; the difference reaches the later columns through
    at most b reflectors, and this script's readings of phase 3's QR panels,
    at scale 1 as here, stay below 0.4·b·eps: 2·b·eps, 3.1e-5 at b = 128,
    is five times that.)"""
    from faer_tpu_torch.ops.kernels.qr_panel import (
        cluster_edge, qr_panel, qr_panel_onepass_plain, qr_panel_plain, route)

    for m, b in ((4096, 128), (cluster_edge(128) + 1, 128), (60000, 128)):
        a = torch.randn(m, b, generator=gen, device=DEV) * QR_TINY
        k1, t1 = qr_panel(a)
        refs = {"plain": qr_panel_plain(a), "one-pass": qr_panel_onepass_plain(a)}
        same = all(torch.equal(x, y) for name in QR_FAMILY
                   for x, y in zip(_qr_wrapper(name)[0](a), (k1, t1)))
        torch.cuda.synchronize()
        tol = 2 * b * EPS32
        errs = {ref: max(_max_rel(torch.triu(k1[:b]), torch.triu(k[:b]))[1],
                         _max_rel(torch.tril(k1, -1), torch.tril(k, -1))[1],
                         (t1 - t).abs().max().item()) for ref, (k, t) in refs.items()}
        orth, rec = (_qr_checks if m <= 8192 else _qr_checks_thin)(a, k1, t1)
        check(max(*errs.values(), orth, rec) <= tol and same,
              f"qr_panel ({m}, {b}) x {QR_TINY:g} [{route(m, b)[0]} route]: rel err (R, "
              "V, τ) vs " + ", ".join(f"{k} {e:.3e}" for k, e in errs.items())
              + f"; |QᵀQ-I| {orth:.3e}, |QR-A|/|A| {rec:.3e}"
              + (f" (f64, Q's first {b} columns)" if m > 8192 else " (f64)")
              + f"; all <= {tol:.3e} (2·b·eps); the family equal to the bit {same}")


def _qr_wrapper(name: str):
    """(wrapper, plain version) of a QR panel wrapper of the port."""
    import importlib

    mod = importlib.import_module("faer_tpu_torch.ops.kernels." + (
        "leaf" if name == "qr_leaf" else name))
    return getattr(mod, name), getattr(mod, f"{name}_plain")


def _qr_checks(a, packed, taus) -> tuple[float, float]:
    """(max|QᵀQ − I|, ‖Q·R − A‖/‖A‖) of a packed (m, b) panel factor in f64,
    Q = H_0 ⋯ H_{k−1} (m, m), R = triu(packed) (m, b)."""
    m, b = a.shape
    k = taus.shape[0]
    pk = packed.double()
    v = torch.tril(pk[:, :k], -1) + torch.eye(m, k, dtype=torch.float64, device=DEV)
    q = torch.eye(m, dtype=torch.float64, device=DEV)
    for j in range(k - 1, -1, -1):
        q -= taus[j].double() * torch.outer(v[:, j], v[:, j] @ q)
    orth = (q.T @ q - torch.eye(m, dtype=torch.float64, device=DEV)).abs().max().item()
    return orth, rel_norm(q @ torch.triu(pk), a.double())


def _qr_checks_thin(a, packed, taus) -> tuple[float, float]:
    """(max|Q₁ᵀQ₁ − I|, ‖Q·R − A‖/‖A‖) of a packed (m, b) panel factor in
    f64 for any m: Q₁ = Q[:, :b] and Q·R formed by applying the reflectors
    H_{k−1}, …, H_0 in turn to (m, b) blocks, never the (m, m) Q."""
    m, b = a.shape
    k = taus.shape[0]
    pk = packed.double()
    v = torch.tril(pk[:, :k], -1) + torch.eye(m, k, dtype=torch.float64, device=DEV)
    q1 = torch.eye(m, b, dtype=torch.float64, device=DEV)
    qr = torch.triu(pk)
    for j in range(k - 1, -1, -1):
        vj, tj = v[:, j], taus[j].double()
        q1 -= tj * torch.outer(vj, vj @ q1)
        qr -= tj * torch.outer(vj, vj @ qr)
    orth = (q1.T @ q1 - torch.eye(b, dtype=torch.float64, device=DEV)).abs().max().item()
    return orth, rel_norm(qr, a.double())


def _qr_panel_family(gen) -> dict:
    """``qr_panel_v1``, ``qr_panel_v2``, ``qr_panel_v3`` and ``qr_leaf``
    (rows 18, 14, 15, 7), which launch ``csrc/qr_panel.cu`` behind their own
    counters, at every phase-3 QR case (``qr_cases``: both sides of every
    route edge): equal to ``qr_panel``'s result to the bit (one kernel), and
    held like it against their own plain version, the kernel's one-pass
    order and ``torch.geqrf`` (R and V each within 8·m·eps of their own
    largest entry, τ within 8·m·eps, QᵀQ = I and Q·R = A to 8·m·eps). Timed
    at (4096, 128) and (4096, 256) beside ``torch.geqrf`` and the bound
    (2mb² − 2b³/3 FP32 operations, the panel read and written once)."""
    from faer_tpu_torch.ops.kernels.qr_panel import qr_panel
    from faer_tpu_torch.utils import flops

    res = {}
    cases = qr_cases()
    for name in QR_FAMILY:
        kern, plain = _qr_wrapper(name)
        errs = []
        for m, b, zero in cases:
            a = _qr_case_panel(m, b, zero, gen)
            (k1, t1), (k2, t2), (k0, t0) = kern(a), plain(a), qr_panel(a)
            torch.cuda.synchronize()
            same = torch.equal(k1, k0) and torch.equal(t1, t0)
            tol = 8 * m * EPS32
            err_own = max(_max_rel(torch.triu(k1[:b]), torch.triu(k2[:b]))[1],
                          _max_rel(torch.tril(k1, -1), torch.tril(k2, -1))[1],
                          (t1 - t2).abs().max().item())
            _qr_against_references(a, k1, t1, zero, f"{name} ({m}, {b})")
            check(same and err_own <= tol,
                  f"{name} ({m}, {b}): equal to qr_panel to the bit {same}; rel err vs "
                  f"its own plain version {err_own:.3e} <= {tol:.3e}")
            errs.append((k1 - k2).abs().max().item())
        for m, b in ((4096, 128), (4096, 256)):
            pan = torch.randn(m, b, generator=gen, device=DEV)
            r = dict(max_abs_err=max(errs), ms=cuda_ms(lambda: kern(pan), 10),
                     plain_ms=cuda_ms(lambda: plain(pan), 3),
                     library_ms=cuda_ms(lambda: torch.geqrf(pan), 10),
                     **bound_of(flops.qr_flops(m, b), 2 * m * b * 4 + b * 4))
            print(f"time {name} ({m}, {b}): kernel {r['ms']:.4f} ms, plain "
                  f"{r['plain_ms']:.4f} ms, geqrf {r['library_ms']:.4f} ms, bound "
                  f"{r['bound_ms']:.6g} ms ({r['bound_by']})")
            res.setdefault(name, r)  # the JSON line keeps (4096, 128)
    return res


def _wide_panels(gen) -> None:
    """Every panel wrapper on wide panels (m < b), which its Pallas kernel
    takes: min(m, b) steps inside the kernel, the whole (m, b) panel back.
    LU (``lu_panel``, ``lu_leaf``, ``lu_panel_v2`` and its batch of 3,
    ``lu_panel_v3``, ``lu_panel_swap``): separated pivots, so perm, nt and
    ok exactly, packed within 8·b·eps of its largest entry, A[perm] = L·U
    to 8·b·eps. QR (``qr_panel`` and the family): I + G/(4√m), κ ≤ 3, R and
    V within 8·b·eps of the plain version's and of the kernel's one-pass
    order, τ (length m) within 8·b·eps, QᵀQ = I and Q·R = A to 8·b·eps in
    f64, every wrapper equal to ``qr_panel`` to the bit."""
    import importlib

    from faer_tpu_torch.ops.kernels.qr_panel import qr_panel_onepass_plain, route

    lu = {"lu_panel": "lu_panel", "lu_leaf": "leaf", "lu_panel_v2": "lu_panel_v2",
          "lu_panel_v3": "lu_panel_v3", "lu_panel_swap": "lu_panel_swap",
          "lu_panel_v2_batched": "lu_panel_v2"}
    for m, b in WIDE:
        tol = 8 * b * EPS32
        for name, base in lu.items():
            mod = importlib.import_module(f"faer_tpu_torch.ops.kernels.{base}")
            kern, plain = getattr(mod, name), getattr(mod, f"{name}_plain")
            batched = name == "lu_panel_v2_batched"
            stack = torch.stack([_separated_panel(m, b, gen)
                                 for _ in range(3 if batched else 1)])
            got = kern(stack) if batched else tuple(x[None] for x in kern(stack[0]))
            want = plain(stack) if batched else tuple(x[None] for x in plain(stack[0]))
            torch.cuda.synchronize()
            for q, a in enumerate(stack):
                k1, p1, n1, o1 = (x[q] for x in got)
                k2, p2, n2, o2 = (x[q] for x in want)
                err, rel = _max_rel(k1, k2)
                rec = _lu_rec(a, k1, p1)
                same = bool((p1 == p2).all())
                check(tuple(k1.shape) == (m, b) and same and int(n1) == int(n2)
                      and bool(o1) and bool(o2) and rel <= tol and rec <= tol,
                      f"wide {name}{f' [{q}]' if batched else ''} ({m}, {b}): perm "
                      f"equal {same}, nt {int(n1)} vs {int(n2)}, ok {bool(o1)}, max abs "
                      f"err {err:.3e}, rel {rel:.3e}; |A[perm]-LU|/|A| {rec:.3e}; "
                      f"<= {tol:.3e}")
        a = torch.randn(m, b, generator=gen, device=DEV) / (4 * m ** 0.5)
        a += torch.eye(m, b, device=DEV)
        k0, t0 = _qr_wrapper("qr_panel")[0](a)
        refs = {"one-pass": qr_panel_onepass_plain(a)}
        for name in ("qr_panel",) + QR_FAMILY:
            kern, plain = _qr_wrapper(name)
            (k1, t1), refs["plain"] = kern(a), plain(a)
            torch.cuda.synchronize()
            errs = {ref: max(_max_rel(torch.triu(k1), torch.triu(k))[1],
                             _max_rel(torch.tril(k1, -1), torch.tril(k, -1))[1],
                             (t1 - t).abs().max().item()) for ref, (k, t) in refs.items()}
            orth, rec = _qr_checks(a, k1, t1)
            same = torch.equal(k1, k0) and torch.equal(t1, t0)
            check(tuple(k1.shape) == (m, b) and tuple(t1.shape) == (m,) and same
                  and max(*errs.values(), orth, rec) <= tol,
                  f"wide {name} ({m}, {b}) [{route(m, b)[0]} route]: rel err (R, V, τ) vs "
                  + ", ".join(f"{k} {e:.3e}" for k, e in errs.items())
                  + f"; |QᵀQ-I| {orth:.3e}, |QR-A|/|A| {rec:.3e}; all <= {tol:.3e}; "
                  f"equal to qr_panel to the bit {same}")


def _sweep_case(n: int, l: int, m: int, bidiag: bool, gen):
    """(d, e, lm, mu) of one sweep on block [l, m] with the driver's shift."""
    from faer_tpu_torch.ops.kernels.sweep import _shift, _wilkinson_shift

    d = torch.randn(n, generator=gen, device=DEV) + (2.0 if bidiag else 0.0)
    e = torch.randn(n - 1, generator=gen, device=DEV)
    mu = _shift(d, e, m) if bidiag else _wilkinson_shift(d[m - 1], e[m - 1], d[m])
    lm = torch.tensor([l, m], dtype=torch.int32, device=DEV)
    return d, e, lm, mu.reshape(1)


def _one_sweep_kernels(gen) -> None:
    """The one-sweep entries ``tridiag_sweep`` and ``bidiag_sweep`` against
    their plain versions at the D&C leaf shape (64), the direct route (384)
    and a length whose d and e do not fit the 48 KB of shared memory (8192:
    global memory), each on an inner block (l > 0, m < n−1), equal to the
    bit; timed at a full leaf sweep (0, 63) by graph replay
    (``graph_ms``), which gives the chain's latency a step."""
    from faer_tpu_torch.ops.kernels import sweep

    for name, bidiag in (("tridiag_sweep", False), ("bidiag_sweep", True)):
        kern, plain = getattr(sweep, name), getattr(sweep, f"{name}_plain")
        for n, l, m in ((64, 5, 60), (384, 7, 370), (8192, 3, 8000)):
            args = _sweep_case(n, l, m, bidiag, gen)
            got, want = kern(*args), plain(*args)
            torch.cuda.synchronize()
            same = all(torch.equal(g, w) for g, w in zip(got, want))
            outside = all(bool((r[:l] == v).all() and (r[m:] == v).all())
                          for r, v in zip(got[2:], (1.0, 0.0) * 2))
            check(same and outside,
                  f"{name} n={n} (l, m) = ({l}, {m}) "
                  f"[{'shared' if n <= 6144 else 'global'} memory]: equal to the "
                  f"plain sweep to the bit {same}, rotations identity outside "
                  f"[l, m) {outside}")
        full = {n: _sweep_case(n, 0, n - 1, bidiag, gen) for n in (64, 384)}
        ms = {n: graph_ms(lambda a=a: kern(*a), 50) for n, a in full.items()}
        per_step = (ms[384] - ms[64]) / (383 - 63) * 1e3
        print(f"time {name} (one sweep): device {ms[64]:.4f} ms (64 steps), "
              f"{ms[384]:.4f} ms (384 steps): chain latency {per_step:.4f} us per "
              f"step; wrapper call {cuda_ms(lambda: kern(*full[64]), 50):.4f} ms")


def _qr_batch_cases(bidiag: bool, gen) -> dict:
    """Phase 3's batches of the batched QR kernels: label -> (d, e, sizes[,
    sqre], max_sweeps_factor). The 64 leaves of a 4096 problem and the
    ragged ones (62, 63) of 4000, formed as the D&C forms them (the
    bidiagonal's wide upper leaves and square last one), the direct route
    at the first size past the vectors' shared-memory edge (in global
    memory), the 4096 leaves at one
    iteration a row (max_iters: not converged), and, for the bidiagonal,
    zero diagonals that take the row chase and the column chase."""
    from faer_tpu_torch.linalg import bidiag_dnc, tridiag_dnc
    from faer_tpu_torch.ops.kernels import _build, sweep

    def leaves(n):
        d = torch.randn(n, generator=gen, device=DEV)
        e = torch.randn(n - 1, generator=gen, device=DEV)
        return (bidiag_dnc._leaf_inputs(d, e, 0) if bidiag
                else tridiag_dnc._leaf_inputs(d, e))

    def one(n):
        d = torch.randn(1, n, generator=gen, device=DEV)
        e = torch.randn(1, n if bidiag else n - 1, generator=gen, device=DEV)
        if bidiag:
            e[0, -1] = 0.0
        sizes = torch.full((1,), n, dtype=torch.int32, device=DEV)
        return (d, e, sizes, torch.zeros_like(sizes)) if bidiag else (d, e, sizes)

    # the direct route at the first size whose vectors leave shared memory
    # (DIRECT_N until phase 17 needed the room: the plain sweeps run on the
    # card, ≈ n² chase steps of some thirty launches each; phase 7 drives
    # the route at DIRECT_N)
    kind = "bidiag" if bidiag else "tridiag"
    direct = 1 + _build.shared_edge(
        lambda n, dt: sweep.qr_batched_route(kind, n, dtype=dt), torch.float32, DIRECT_N)
    cases = {f"the 64 leaves of {N}": (*leaves(N), 30),
             "the ragged leaves of 4000": (*leaves(4000), 30),
             f"direct route n={direct}": (*one(direct), 30),
             f"the leaves of {N}, max_iters = n": (*leaves(N), 1)}
    if bidiag:
        d = torch.randn(3, 64, generator=gen, device=DEV)
        e = torch.randn(3, 64, generator=gen, device=DEV)
        d[0, 5] = d[2, 63] = d[1, 40] = 0.0  # row chase; column chase; wide
        sizes = torch.full((3,), 64, dtype=torch.int32, device=DEV)
        sqre = torch.tensor([0, 1, 0], dtype=torch.int32, device=DEV)
        cases["zero diagonals (row and column chases)"] = (d, e, sizes, sqre, 30)
    return cases


# leaves of a large batch held against the plain version on the card: the
# first two and the last two (a host core's plain version is not the card's
# to the bit: a sweep's rounding differs between the two, so it stays on
# the card)
QR_PLAIN_PICK = 4


def _qr_batched_kernels(gen) -> dict:
    """``tridiag_qr_batched`` and ``bidiag_qr_batched`` (rows 9 and 10:
    the whole QR iteration of many problems in one launch) against their
    plain versions on every case of ``_qr_batch_cases``, each case's route
    printed: d, e, iterations, converged and sweep steps equal to the bit
    (the same IEEE operations in the same order), the vectors within
    8·nmax·eps. The kernel runs each whole batch; the plain version, whose
    sweeps are some thirty PyTorch launches a chain step (≈ 8 s for four
    of the 64 leaves of N on an H100, ≈ 160 s for every case here), runs
    the batch's first two and last two problems (both leaf sizes of a
    ragged batch, wide and square leaves), and the problems are
    independent, so those are compared. Timed at the
    64 leaves of N by graph replay (inputs copied inside the graph: the
    kernel works in place), beside the plain version on its QR_PLAIN_PICK
    leaves (one call) and the library on all the leaves as dense blocks,
    one batched call a shape. The bound counts this run's work: the
    kernel's own sweep steps × (the chain's operations + its rotations ×
    rows × 6)."""
    from faer_tpu_torch.ops.kernels import sweep

    res = {}
    for kind, bidiag in (("tridiag", False), ("bidiag", True)):
        name = f"{kind}_sweep"
        kern = getattr(sweep, f"{kind}_qr_batched")
        plain = getattr(sweep, f"{kind}_qr_batched_plain")
        errs, timed = [], None
        for label, (*args, factor) in _qr_batch_cases(bidiag, gen).items():
            d, e, *ints = args
            batch, nmax = d.shape
            d1, e1 = d.clone(), e.clone()
            got = kern(d1, e1, *ints, max_sweeps_factor=factor)
            torch.cuda.synchronize()
            pick = torch.arange(batch, device=DEV)
            if batch > QR_PLAIN_PICK:  # the first and the last problems
                half = QR_PLAIN_PICK // 2
                pick = torch.cat([pick[:half], pick[-half:]])
            d2, e2 = d[pick], e[pick]
            t0 = time.perf_counter()
            want = plain(d2, e2, *(x[pick] for x in ints), max_sweeps_factor=factor)
            torch.cuda.synchronize()
            plain_s = time.perf_counter() - t0
            same = torch.equal(d1[pick], d2) and torch.equal(e1[pick], e2) and all(
                torch.equal(g[pick], w) for g, w in zip(got[-3:], want[-3:]))
            err = max((g[pick] - w).abs().max().item()
                      for g, w in zip(got[:-3], want[:-3]))
            its, conv = got[-3], got[-2]
            want_conv = factor >= 30
            check(same and err <= 8 * nmax * EPS32 and bool(conv.all()) == want_conv,
                  f"{kind}_qr_batched {label} [B={batch}, nmax={nmax}, vectors in "
                  f"{sweep.qr_batched_route(kind, nmax)} memory; {len(pick)} held "
                  f"against the plain version]: d, e, iterations, converged and sweep "
                  f"steps equal to the plain version's to the bit {same}; vectors max "
                  f"abs err {err:.3e} <= {8 * nmax * EPS32:.3e}; all {batch} converged "
                  f"{bool(conv.all())} ({int(its.sum())} iterations)")
            errs.append(err)
            if timed is None:
                timed = (args, got, plain_s * 1e3, len(pick))
        (d, e, *ints), got, plain_ms, n_plain = timed
        ms = graph_ms(lambda: kern(d.clone(), e.clone(), *ints), 3)
        sizes = ints[0].tolist()
        sqre = ints[1].tolist() if bidiag else [0] * len(sizes)
        steps = got[-1].tolist()
        # each step: the chain, and its rotations of the problem's rows
        # (tridiagonal: Z's n; bidiagonal: W's n + sqre and U's n)
        flops = sum(st * (SWEEP_STEP_FLOPS[name] + 6 * (2 * n + sq if bidiag else n))
                    for st, n, sq in zip(steps, sizes, sqre))
        nbytes = sum(4 * (2 * (2 * n - 1 + sq)  # d, e in and out
                          + ((n * n + (n + sq) ** 2) if bidiag else n * n) + 3)
                     for n, sq in zip(sizes, sqre))
        lib = _leaf_library_ms(d, e, ints, bidiag)
        print(f"time {kind}_qr_batched, the {len(sizes)} leaves of {N}: device {ms:.4f} "
              f"ms (graph replay), {sum(steps)} sweep steps; plain {plain_ms:.1f} ms on "
              f"{n_plain} of them; library on the leaves as dense blocks {lib:.4f} ms")
        res[name] = dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                         plain_problems=n_plain, library_ms=lib, **bound_of(flops, nbytes))
    _one_sweep_kernels(gen)
    return res


def _qr_batched_kernels_f64(gen, res: dict) -> None:
    """The float64 instantiations of ``tridiag_qr_batched`` and
    ``bidiag_qr_batched`` (the f64 spectral entry points' route) against
    their plain versions, as ``_qr_batched_kernels`` holds the float32 ones
    (d, e, iterations, converged and sweep steps to the bit, vectors within
    8·nmax·eps_f64): the 16 leaves of an f64 1024 D&C, the first and the
    last held against the plain version (the direct route's f64 call,
    whose plain version takes minutes on the card, runs in phase 14). The
    64 leaves of N in float64 timed by graph replay go into rows 9 and 10
    as ``ms_f64``."""
    from faer_tpu_torch.ops.kernels import sweep
    from faer_tpu_torch.linalg import bidiag_dnc, tridiag_dnc

    eps64 = torch.finfo(torch.float64).eps
    for kind, bidiag in (("tridiag", False), ("bidiag", True)):
        kern = getattr(sweep, f"{kind}_qr_batched")
        plain = getattr(sweep, f"{kind}_qr_batched_plain")

        def leaves(n):
            d = torch.randn(n, generator=gen, device=DEV, dtype=torch.float64)
            e = torch.randn(n - 1, generator=gen, device=DEV, dtype=torch.float64)
            return (bidiag_dnc._leaf_inputs(d, e, 0) if bidiag
                    else tridiag_dnc._leaf_inputs(d, e))

        for label, args in (("the 16 leaves of 1024", leaves(1024)),):
            d, e, *ints = args
            batch, nmax = d.shape
            dk, ek = d.clone(), e.clone()
            got = kern(dk, ek, *ints)
            torch.cuda.synchronize()
            pick = torch.tensor([0, batch - 1], device=DEV)
            dp, ep = d[pick], e[pick]
            want = plain(dp, ep, *(x[pick] for x in ints))
            same = torch.equal(dk[pick], dp) and torch.equal(ek[pick], ep) and all(
                torch.equal(g[pick], w) for g, w in zip(got[-3:], want[-3:]))
            err = max((g[pick] - w).abs().max().item() for g, w in zip(got[:-3], want[:-3]))
            check(same and err <= 8 * nmax * eps64 and bool(got[-2].all()),
                  f"{kind}_qr_batched f64 {label} [B={batch}, nmax={nmax}, vectors in "
                  f"{sweep.qr_batched_route(kind, nmax, dtype=torch.float64)} memory; "
                  f"{len(pick)} held against the plain version]: d, e, iterations, "
                  f"converged and sweep steps equal to the bit {same}; vectors max abs "
                  f"err {err:.3e} <= {8 * nmax * eps64:.3e}")
        d, e, *ints = leaves(N)
        ms = graph_ms(lambda: kern(d.clone(), e.clone(), *ints), 3)
        res[f"{kind}_sweep"]["ms_f64"] = ms
        print(f"time {kind}_qr_batched f64, the {d.shape[0]} leaves of {N}: device "
              f"{ms:.4f} ms (graph replay)")


def real_schur_cases() -> tuple:
    """(n, batch, dtype) of phase 3's real_schur checks: SCHUR_CASES in
    float32 and float64, and both sides of each dtype's shared-memory edge
    (the largest nmax whose H and Q the kernel keeps in shared memory, by
    bisection over its route, and the next, in global memory)."""
    from faer_tpu_torch.ops.kernels import real_schur as krs

    out = []
    for dt in (torch.float32, torch.float64):
        edge = krs.shared_edge(dt)
        out += [(n, b, dt) for n, b in SCHUR_CASES] + [(edge, 1, dt), (edge + 1, 1, dt)]
    return tuple(out)


def _schur_inputs(n: int, batch: int, dt, gen):
    h = torch.triu(torch.randn(batch, n, n, generator=gen, device=DEV,
                               dtype=torch.float64), -1).to(dt)
    q = torch.eye(n, device=DEV, dtype=dt).repeat(batch, 1, 1)
    return h, q, torch.full((batch,), n, dtype=torch.int32, device=DEV)


def _real_schur_kernel(gen) -> dict:
    """``real_schur_batched`` (the Francis double-shift iteration of every
    problem of a batch, one CTA each, one launch) against its plain
    version on every case of ``real_schur_cases``, each case's route
    printed: T, Q, iterations, converged and chase steps equal to the bit
    (the plain version runs on CPU copies: IEEE operations only, so the two
    devices round alike), every problem converged, ‖H − QTQᵀ‖/‖H‖ ≤
    8·n·eps; the shared-memory route equal to the global one forced onto
    the same inputs; timed at the AED window of GEVD_N (96) per call and
    on the device (CUDA graph) in both dtypes, beside the plain version on
    the card (one call) and ``torch.linalg.eigvals`` of the same window.
    The bound counts this run's work: the kernel's chase steps ×
    ``schur_step_flops`` + its iterations × 5 flops an entry of the
    subdiagonal over the FP32 (FP64) peak, and H, Q read and T, Q written
    once."""
    from faer_tpu_torch.ops.kernels import real_schur as krs

    errs = []
    for n, batch, dt in real_schur_cases():
        h, q, sizes = _schur_inputs(n, batch, dt, gen)
        got = krs.real_schur_batched(h, q, sizes)
        torch.cuda.synchronize()
        want = krs.real_schur_batched_plain(h.cpu(), q.cpu(), sizes.cpu())
        same = all(torch.equal(g.cpu(), w) for g, w in zip(got, want))
        t, qo = got[0].double(), got[1].double()
        rec = max(rel_norm(qo[b] @ t[b] @ qo[b].T, h[b].double()) for b in range(batch))
        tol = 8 * n * torch.finfo(dt).eps
        errs.append(0.0 if same else float("inf"))
        name = "f32" if dt == torch.float32 else "f64"
        check(same and bool(got[3].all()) and rec <= tol,
              f"real_schur_batched n={n} B={batch} {name} [H and Q in "
              f"{krs.route(n, dt)} memory]: T, Q, iterations, converged and chase steps "
              f"equal to the plain version's to the bit {same}; all converged "
              f"{bool(got[3].all())} ({got[2].tolist()} iterations, {got[4].tolist()} "
              f"steps); |H - QTQᵀ|/|H| {rec:.3e} <= {tol:.3e}")
    out = None
    for dt in (torch.float32, torch.float64):
        w = 96
        h, q, sizes = _schur_inputs(w, 1, dt, gen)
        got = krs.real_schur_batched(h, q, sizes)
        ms = cuda_ms(lambda: krs.real_schur_batched(h, q, sizes), SCHUR_REPS)
        dev_ms = graph_ms(lambda: krs.real_schur_batched(h, q, sizes), SCHUR_REPS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        krs.real_schur_batched_plain(h, q, sizes)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        lib = cuda_ms(lambda: torch.linalg.eigvals(h[0]), 5)
        its, steps = int(got[2][0]), int(got[4][0])
        flops = steps * schur_step_flops(w) + its * 5 * (w - 1)
        nbytes = 4 * w * w * h.element_size()
        name = "f32" if dt == torch.float32 else "f64"
        print(f"time real_schur_batched w={w} {name}: per call {ms:.4f} ms, device "
              f"{dev_ms:.4f} ms (graph replay), {its} iterations, {steps} chase steps "
              f"({dev_ms / max(steps, 1) * 1e3:.3f} us a step); plain {plain_ms:.1f} ms "
              f"(one call on the card); library eigvals of the window {lib:.4f} ms")
        if dt == torch.float32:
            out = dict(max_abs_err=max(errs), ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                       library_ms=lib, **bound_of(flops, nbytes))
        else:
            f64 = bound_of(flops, nbytes, PEAK_F64_FLOPS)
            out.update(ms_f64=ms, device_ms_f64=dev_ms, plain_ms_f64=plain_ms,
                       library_ms_f64=lib, bound_ms_f64=f64["bound_ms"],
                       bound_by_f64=f64["bound_by"])
    return {"real_schur": out}


# phase 3's complex_schur cases (n, batch, max_sweeps_factor): the complex
# multishift driver's AED windows below n = 590 (48) and up to 3000 (96),
# a batch of small blocks, the trivial sizes, and an iteration budget of 0;
# complex_schur_cases adds both sides of each dtype's shared-memory edge and
# the ragged batch COMPLEX_SCHUR_RAGGED
COMPLEX_SCHUR_CASES = ((48, 2, 30), (96, 1, 30), (16, 4, 30), (1, 2, 30), (2, 3, 30),
                       (48, 1, 0))
COMPLEX_SCHUR_RAGGED = (40, (40, 7, 1, 0, 33))  # (nmax, sizes)


# operations of one chase step of the complex_schur kernel at width n,
# counted from its source: the rotation of a pair of complex entries is 12
# products and 8 sums (rotate: 5 operations a real component), over the
# row phase's n − i + 1 columns, the column phase's i + 3 rows of H and n
# rows of Q, 2n + 4 pairs in all; plus 40 for the rotation (two scaled
# magnitudes, the norm, the phase and s); and per iteration the deflation
# test, 24 operations an entry of the subdiagonal (three scaled magnitudes)
def complex_schur_step_flops(n: int) -> int:
    return 20 * (2 * n + 4) + 40


def complex_schur_cases() -> tuple:
    """(nmax, sizes, max_sweeps_factor, dtype) of phase 3's complex_schur
    checks: COMPLEX_SCHUR_CASES in complex64 and complex128, both sides of
    each dtype's shared-memory edge (the largest nmax whose H and Q the
    kernel keeps in shared memory, by bisection over its route, and the
    next, in global memory), and the ragged batch."""
    from faer_tpu_torch.ops.kernels import complex_schur as kcs

    out = []
    for dt in (torch.complex64, torch.complex128):
        edge = kcs.shared_edge(dt)
        out += [(n, (n,) * b, f, dt) for n, b, f in COMPLEX_SCHUR_CASES]
        out += [(edge, (edge,), 30, dt), (edge + 1, (edge + 1,), 30, dt)]
        out += [(COMPLEX_SCHUR_RAGGED[0], COMPLEX_SCHUR_RAGGED[1], 30, dt)]
    return tuple(out)


def _complex_schur_inputs(nmax: int, sizes, dt, gen):
    """Complex Gaussian upper-Hessenberg problems (B, nmax, nmax) on the
    card (zeros past each problem's size), Q = I, and the int32 sizes."""
    rdt = dt.to_real()
    batch = len(sizes)
    h = torch.complex(torch.randn(batch, nmax, nmax, generator=gen, device=DEV, dtype=rdt),
                      torch.randn(batch, nmax, nmax, generator=gen, device=DEV, dtype=rdt))
    h = torch.triu(h, -1)
    for b, n in enumerate(sizes):
        h[b, n:] = 0
        h[b, :, n:] = 0
    q = torch.eye(nmax, device=DEV, dtype=dt).repeat(batch, 1, 1)
    return h.contiguous(), q, torch.tensor(sizes, dtype=torch.int32, device=DEV)


def _complex_schur_plain_case(h, q, sizes, factor):
    """A host process's job: ``complex_schur_batched_plain`` on the CPU
    copies, on one thread, with the seconds it took."""
    torch.set_num_threads(1)
    from faer_tpu_torch.ops.kernels import complex_schur as kcs

    t0 = time.perf_counter()
    out = kcs.complex_schur_batched_plain(h, q, sizes, max_sweeps_factor=factor)
    return out, time.perf_counter() - t0


def _complex_schur_kernel(gen) -> dict:
    """``complex_schur_batched`` (the single-shift complex Schur iteration
    of every problem of a batch, one CTA each, one launch) against its
    plain version on every case of ``complex_schur_cases``, each case's
    route printed: T, Q, iterations, converged and chase steps equal to the
    bit (the plain version runs on CPU copies in GEVD_WORKERS host
    processes while the card runs the kernels: IEEE operations on real
    numbers only, so the two devices round alike), every problem of a full
    budget converged with T upper triangular and ‖H − QTQᴴ‖/‖H‖ ≤ 8·n·eps,
    the budget of 0 not converged; timed at the AED windows 48 and 96 per
    call and on the device (CUDA graph of SCHUR_REPS calls) in both dtypes,
    µs per chase step, beside the plain version (the CPU route: one call on
    a host core, the 96 case of the checks) and ``torch.linalg.eigvals`` of
    the same window. The
    bound counts this run's work at 96: the kernel's chase steps ×
    ``complex_schur_step_flops`` + its iterations × 24 flops an entry of
    the subdiagonal over the FP32 (FP64) peak, and H, Q read and T, Q
    written once."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from faer_tpu_torch.ops.kernels import complex_schur as kcs

    cases = complex_schur_cases()
    inputs = [_complex_schur_inputs(nmax, sizes, dt, gen) for nmax, sizes, _, dt in cases]
    with ProcessPoolExecutor(GEVD_WORKERS,
                             mp_context=multiprocessing.get_context("spawn")) as pool:
        jobs = [pool.submit(_complex_schur_plain_case, h.cpu(), q.cpu(), sz.cpu(), f)
                for (h, q, sz), (_, _, f, _) in zip(inputs, cases)]
        got = [kcs.complex_schur_batched(h, q, sz, max_sweeps_factor=f)
               for (h, q, sz), (_, _, f, _) in zip(inputs, cases)]
        torch.cuda.synchronize()
        plains = [job.result() for job in jobs]
    errs, plain_96 = [], {}
    for (nmax, sizes, f, dt), (h, _, _), out, (want, secs) in zip(cases, inputs, got, plains):
        if sizes == (96,) and f:
            plain_96[dt] = secs * 1e3
        out = [x.cpu() for x in out]
        same = all(torch.equal(g, w) for g, w in zip(out, want))
        errs.append(0.0 if same else max((torch.view_as_real(g.to(torch.complex128)
                                                             - w.to(torch.complex128))
                                          .abs().max().item()) for g, w in zip(out[:2], want[:2])))
        live = [b for b, n in enumerate(sizes) if n >= 1]
        conv = bool(out[3][live].all()) if f else not bool(out[3][[b for b in live
                                                                     if sizes[b] > 1]].any())
        tol = 8 * nmax * torch.finfo(dt).eps
        rec, lower = 0.0, 0.0
        for b in live:
            n = sizes[b]
            if not f or n < 2:
                continue
            t, qo = out[0][b, :n, :n].to(torch.complex128), out[1][b, :n, :n].to(torch.complex128)
            hb = h[b, :n, :n].cpu().to(torch.complex128)
            rec = max(rec, (torch.linalg.matrix_norm(qo @ t @ qo.mH - hb)
                            / torch.linalg.matrix_norm(hb)).item())
            lower = max(lower, torch.tril(t, -1).abs().max().item())
        tag = "c64" if dt == torch.complex64 else "c128"
        check(same and conv and rec <= tol and lower == 0,
              f"complex_schur_batched nmax={nmax} sizes={list(sizes)} factor={f} {tag} [H and "
              f"Q in {kcs.route(nmax, dt)} memory]: T, Q, iterations, converged and chase "
              f"steps equal to the plain version's to the bit {same}; "
              f"{'all converged' if f else 'none converged (budget 0)'} {conv} "
              f"({out[2].tolist()} iterations, {out[4].tolist()} steps); upper triangular "
              f"{lower == 0}; |H - QTQᴴ|/|H| {rec:.3e} <= {tol:.3e}; plain {secs:.1f} s on "
              f"one host core")
    out = None
    for dt in (torch.complex64, torch.complex128):
        tag = "c64" if dt == torch.complex64 else "c128"
        peak = PEAK_F32_FLOPS if dt == torch.complex64 else PEAK_F64_FLOPS
        for w in (48, 96):
            h, q, sizes = _complex_schur_inputs(w, (w,), dt, gen)
            got = kcs.complex_schur_batched(h, q, sizes)
            ms = cuda_ms(lambda: kcs.complex_schur_batched(h, q, sizes), SCHUR_REPS)
            dev_ms = graph_ms(lambda: kcs.complex_schur_batched(h, q, sizes), SCHUR_REPS)
            lib = cuda_ms(lambda: torch.linalg.eigvals(h[0]), 5)
            plain_ms = plain_96.get(dt) if w == 96 else None
            its, steps = int(got[2][0]), int(got[4][0])
            flops = steps * complex_schur_step_flops(w) + its * 24 * (w - 1)
            bound = bound_of(flops, 4 * w * w * h.element_size(), peak)
            plain = "" if plain_ms is None else \
                f"; plain {plain_ms:.1f} ms (one call on a host core, another window of 96)"
            print(f"time complex_schur_batched w={w} {tag} [{kcs.route(w, dt)} memory]: per "
                  f"call {ms:.4f} ms, device {dev_ms:.4f} ms (graph replay), {its} iterations, "
                  f"{steps} chase steps ({dev_ms / max(steps, 1) * 1e3:.3f} us a step){plain}; "
                  f"library eigvals of the window {lib:.4f} ms; bound {bound['bound_ms']:.6g} "
                  f"ms ({bound['bound_by']})")
            if w != 96:
                continue
            if dt == torch.complex64:
                out = dict(max_abs_err=max(errs), ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                           library_ms=lib, **bound)
            else:
                out.update(ms_c128=ms, device_ms_c128=dev_ms, library_ms_c128=lib,
                           bound_ms_c128=bound["bound_ms"], bound_by_c128=bound["bound_by"])
    return {"complex_schur": out}


# phase 3's complex_hess_tri and complex_qz cases (n, batch, budget): the
# trivial sizes, a batch of 16s, the AED windows 48 and 96, a budget of 0;
# complex_gevd_cases adds both sides of each kernel's shared-memory edge, a
# B of low rank and the ragged batch; COMPLEX_GEVD_WIDE runs the chain past
# the kernels' 512 threads a CTA (its plain version beside phases 4–14)
COMPLEX_GEVD_CASES = ((1, 2, 30), (2, 2, 30), (3, 3, 30), (16, 3, 30), (48, 1, 30),
                      (96, 1, 30), (48, 1, 0))
COMPLEX_GEVD_RANK = (16, 12)  # (n, rank of B): four infinite eigenvalues
COMPLEX_GEVD_WIDE = 513


# operations of the complex_hess_tri kernel's chain at n, counted from its
# source: pair (j, i) rotates pairs of complex entries in H's columns
# j..n−1, R's i..n−1 and Q's n rows, then in R's rows 0..i+1 and H's and Z's
# n rows, 5n − j + 2 pairs, 20 flops each (rotate: 5 a real component),
# plus 80 for the two rotations (two scaled magnitudes, the norm, the
# phase and s each); column j has n − 2 − j pairs
def complex_hess_tri_flops(n: int) -> int:
    return sum((n - 2 - j) * (20 * (5 * n - j + 2) + 80) for j in range(n - 2))


# operations of one chase step of the complex_qz kernel at width n, counted
# from its source: the left rotation of H's rows (n − i + 1 columns), T's
# (n − i) and Q's n columns, the right one of H's columns (i + 3 rows), T's
# (i + 2) and Z's n rows: 4n + 6 pairs of complex entries, 20 flops each,
# plus 80 for the two rotations; and per iteration the deflation test, 24
# operations an entry of the subdiagonal (three scaled magnitudes)
def complex_qz_step_flops(n: int) -> int:
    return 20 * (4 * n + 6) + 80


def complex_gevd_cases() -> tuple:
    """(nmax, sizes, max_sweeps_factor, dtype, rank of B or None) of phase
    3's complex_hess_tri and complex_qz checks: COMPLEX_GEVD_CASES in
    complex64 and complex128, both sides of each kernel's shared-memory
    edge (the largest nmax whose four matrices it keeps in shared memory,
    by bisection over its route, and the next), B of low rank
    (COMPLEX_GEVD_RANK) and the ragged batch GEVD_RAGGED."""
    from faer_tpu_torch.ops.kernels import complex_qz as kcq

    out = []
    for dt in (torch.complex64, torch.complex128):
        edges = sorted({kcq.shared_edge(k, dt) + d for k in ("complex_hess_tri", "complex_qz")
                        for d in (0, 1)})
        out += [(n, (n,) * b, f, dt, None) for n, b, f in COMPLEX_GEVD_CASES]
        out += [(n, (n,), 30, dt, None) for n in edges]
        out += [(COMPLEX_GEVD_RANK[0], (COMPLEX_GEVD_RANK[0],), 30, dt, COMPLEX_GEVD_RANK[1]),
                (GEVD_RAGGED[0], GEVD_RAGGED[1], 30, dt, None)]
    return tuple(out)


def _complex_gevd_inputs(nmax: int, batch: int, dt, rank, gen):
    """The complex Givens chain's inputs on the card, (h, r, q, z) (batch,
    nmax, nmax) in ``dt``: the QR of a complex Gaussian B (a product of
    nmax × rank and rank × nmax Gaussians when ``rank`` is given), Q₀ᴴA for
    a complex Gaussian A, Z = I."""
    def cg(*shape):
        return torch.complex(*(torch.randn(*shape, generator=gen, device=DEV,
                                           dtype=torch.float64) for _ in range(2)))

    a, b = cg(batch, nmax, nmax), cg(batch, nmax, nmax)
    if rank is not None:
        b = cg(batch, nmax, rank) @ cg(batch, rank, nmax)
    q, r = torch.linalg.qr(b)
    z = torch.eye(nmax, device=DEV, dtype=torch.complex128).repeat(batch, 1, 1)
    return tuple(x.to(dt).contiguous() for x in (q.mH @ a, torch.triu(r), q, z))


def _complex_gevd_plain_case(mats, factor):
    """A host process's job: the plain versions of ``complex_hess_tri_batched``
    and ``complex_qz_batched`` on the CPU copies ``mats`` = (h, r, q, z,
    sizes), on one thread, the second on the first's output as on the card;
    with the seconds each took."""
    torch.set_num_threads(1)
    from faer_tpu_torch.ops.kernels import complex_qz as kcq

    *m, sizes = mats
    t0 = time.perf_counter()
    red = kcq.complex_hess_tri_batched_plain(*m, sizes)
    t1 = time.perf_counter()
    qz = kcq.complex_qz_batched_plain(*red, sizes, max_sweeps_factor=factor)
    return red, qz, t1 - t0, time.perf_counter() - t1


def _check_complex_gevd_case(nmax, sizes, factor, dt, rank, mats, red, qz, plain,
                             errs: dict) -> None:
    """One case of phase 3's complex_hess_tri and complex_qz checks: the
    kernels' outputs ``red`` and ``qz`` (``qz`` None: the chain alone)
    against their plain versions' ``plain`` = (reduction, QZ) to the bit,
    each kernel's largest difference folded into ``errs``; H Hessenberg and
    R triangular; under a full budget every problem converged, S and T
    triangular and, on a full pencil, Q S Zᴴ and Q T Zᴴ within 8·n·eps of
    Q₀H₀ and Q₀R₀ (A and B); under a budget of 0 none converged."""
    from faer_tpu_torch.ops.kernels import complex_qz as kcq

    def diff(g, w):
        return 0.0 if torch.equal(g, w) else (torch.view_as_real(
            g.to(torch.complex128) - w.to(torch.complex128)).abs().max().item())

    red = [x.cpu() for x in red]
    same_red = all(torch.equal(g, w) for g, w in zip(red, plain[0]))
    errs["complex_hess_tri"] = max(errs["complex_hess_tri"],
                                   *(diff(g, w) for g, w in zip(red, plain[0])))
    shape = all(not bool(torch.tril(red[0][b, :n, :n], -2).any())
                and not bool(torch.tril(red[1][b, :n, :n], -1).any())
                for b, n in enumerate(sizes) if n >= 1)
    ok, detail = same_red and shape, ""
    tag = "c64" if dt == torch.complex64 else "c128"
    tol = 8 * nmax * torch.finfo(dt).eps
    full = len(set(sizes)) == 1 and nmax > 1
    a0 = b0 = None
    if full:  # A = Q₀H₀, B = Q₀R₀
        q0, h0, r0 = (x.to(torch.complex128).to(DEV) for x in (mats[2], mats[0], mats[1]))
        a0, b0 = q0 @ h0, q0 @ r0

    def rec(s, t, q, z):
        s, t, q, z = (x.to(torch.complex128).to(DEV) for x in (s, t, q, z))
        return max(((q @ x @ z.mH - y).norm(dim=(-2, -1)) / y.norm(dim=(-2, -1))).max().item()
                   for x, y in ((s, a0), (t, b0)))

    if full and qz is None:
        r_red = rec(*red)
        ok = ok and r_red <= tol
        detail = f"; |A - QHZᴴ|, |B - QRZᴴ| relative {r_red:.3e} <= {tol:.3e}"
    same_qz = None
    if qz is not None:
        qz = [x.cpu() for x in qz]
        same_qz = all(torch.equal(g, w) for g, w in zip(qz, plain[1]))
        errs["complex_qz"] = max(errs["complex_qz"],
                                 *(diff(g, w) for g, w in zip(qz[:4], plain[1][:4])))
        live = [b for b, n in enumerate(sizes) if n >= 1]
        conv = bool(qz[5][live].all()) if factor else \
            not bool(qz[5][[b for b in live if sizes[b] > 1]].any())
        ok = ok and same_qz and conv
        if factor:
            tri = all(not bool(torch.tril(qz[k][b, :n, :n], -1).any())
                      for k in (0, 1) for b, n in enumerate(sizes) if n >= 1)
            ok = ok and tri
            detail = f"; S, T triangular {tri}"
            if full:
                r_qz = rec(*qz[:4])
                ok = ok and r_qz <= tol
                detail += f"; |A - QSZᴴ|, |B - QTZᴴ| relative {r_qz:.3e} <= {tol:.3e}"
            if rank is not None:
                floor = nmax * torch.finfo(dt).eps * torch.linalg.matrix_norm(
                    b0[0], ord=2).item()
                small = int((torch.diagonal(qz[1][0]).abs() <= floor).sum())
                ok = ok and small == nmax - rank
                detail += f"; B of rank {rank}: {small} β within n·eps·|B|₂ of 0 ({nmax - rank})"
        detail += (f"; {'all' if factor else 'none (budget 0)'} converged {conv} "
                   f"({qz[4].tolist()} iterations, {qz[6].tolist()} chase steps)")
    check(ok, f"complex_hess_tri + complex_qz nmax={nmax} sizes={list(sizes)} factor={factor} "
              f"{tag} [complex_hess_tri in {kcq.route('complex_hess_tri', nmax, dt)}, complex_qz "
              f"in {kcq.route('complex_qz', nmax, dt)} memory, "
              f"{min(CTA_THREADS, (nmax + 31) // 32 * 32)} threads a CTA]: reduction and QZ equal "
              f"to the plain versions to the bit {same_red}, {same_qz}; H Hessenberg, R "
              f"triangular {shape}{detail}")


def _complex_gevd_kernels(gen) -> dict:
    """``complex_hess_tri_batched`` (the complex Hessenberg–triangular
    Givens chain) and ``complex_qz_batched`` (the complex QZ, on the first's
    output), one CTA a problem and one launch each, against their plain
    versions on every case of ``complex_gevd_cases``, each case's routes
    printed (:func:`_check_complex_gevd_case`; the plain versions run on CPU
    copies in GEVD_WORKERS host processes while the card runs the kernels:
    IEEE operations on real numbers only, so the two devices round alike).
    Once those processes have ended, each kernel timed at 96 per call and
    on the device (CUDA graph) in both dtypes, µs a Givens pair or chase
    step, beside its plain version (one call on a host core, the check's
    pencil of 96) and scipy.linalg.qz of the same pencil on the host
    (PyTorch has no QZ). The bounds count this run's work:
    ``complex_hess_tri_flops``, and the QZ's chase steps ×
    ``complex_qz_step_flops`` + its iterations × 24 flops an entry of the
    subdiagonal, over the FP32 (FP64) peak; the four matrices read and
    written once."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    import scipy.linalg

    from faer_tpu_torch.ops.kernels import complex_qz as kcq

    cases = complex_gevd_cases()
    inputs = [_complex_gevd_inputs(nmax, len(sizes), dt, rank, gen)
              for nmax, sizes, _, dt, rank in cases]
    sizes_all = [torch.tensor(sz, dtype=torch.int32, device=DEV) for _, sz, _, _, _ in cases]
    with ProcessPoolExecutor(GEVD_WORKERS,
                             mp_context=multiprocessing.get_context("spawn")) as pool:
        jobs = [pool.submit(_complex_gevd_plain_case, tuple(x.cpu() for x in (*mats, sz)), f)
                for mats, sz, (_, _, f, _, _) in zip(inputs, sizes_all, cases)]
        got = []
        for mats, sz, (_, _, f, _, _) in zip(inputs, sizes_all, cases):
            red = kcq.complex_hess_tri_batched(*mats, sz)
            got.append((red, kcq.complex_qz_batched(*red, sz, max_sweeps_factor=f)))
        torch.cuda.synchronize()
        plains = [job.result() for job in jobs]
    errs = {"complex_hess_tri": 0.0, "complex_qz": 0.0}
    plain_96 = {}
    for (nmax, sizes, f, dt, rank), mats, (red, qz), (pred, pqz, t_red, t_qz) in zip(
            cases, inputs, got, plains):
        if sizes == (96,) and f:
            plain_96[dt] = (t_red * 1e3, t_qz * 1e3)
        _check_complex_gevd_case(nmax, sizes, f, dt, rank, mats, red, qz, (pred, pqz), errs)
    res = {}
    for dt in (torch.complex64, torch.complex128):
        n = 96
        mats = _complex_gevd_inputs(n, 1, dt, None, gen)
        sz = torch.full((1,), n, dtype=torch.int32, device=DEV)
        red = kcq.complex_hess_tri_batched(*mats, sz)
        out = kcq.complex_qz_batched(*red, sz)
        its, steps = int(out[4][0]), int(out[6][0])
        times = {}
        for name, fn in (("complex_hess_tri", lambda: kcq.complex_hess_tri_batched(*mats, sz)),
                         ("complex_qz", lambda: kcq.complex_qz_batched(*red, sz))):
            times[name] = (cuda_ms(fn, GEVD_REPS), graph_ms(fn, GEVD_REPS))
        q0, h0, r0 = (x[0].to(torch.complex128).cpu().numpy() for x in (mats[2], mats[0], mats[1]))
        a64, b64 = q0 @ h0, q0 @ r0
        scipy_ms = statistics.median(_host_ms(lambda: scipy.linalg.qz(a64, b64))
                                     for _ in range(3))
        nbytes = 8 * n * n * mats[0].element_size()
        peak = PEAK_F32_FLOPS if dt == torch.complex64 else PEAK_F64_FLOPS
        bounds = {"complex_hess_tri": bound_of(complex_hess_tri_flops(n), nbytes, peak),
                  "complex_qz": bound_of(steps * complex_qz_step_flops(n)
                                         + its * 24 * (n - 1), nbytes, peak)}
        plain_ms = dict(zip(("complex_hess_tri", "complex_qz"), plain_96.get(dt, (None, None))))
        tag = "c64" if dt == torch.complex64 else "c128"
        for name, (ms, dev) in times.items():
            extra = (f", {its} iterations, {steps} chase steps "
                     f"({dev / max(steps, 1) * 1e3:.3f} us a step)" if name == "complex_qz" else
                     f" ({dev / ((n - 1) * (n - 2) / 2) * 1e3:.3f} us a pair)")
            pm = plain_ms[name]
            plain = "" if pm is None else \
                f"; plain {pm:.1f} ms (one call on a host core, another pencil of 96)"
            print(f"time {name} n={n} {tag} [{kcq.route(name, n, dt)} memory]: per call "
                  f"{ms:.4f} ms, device {dev:.4f} ms (graph replay){extra}{plain}; "
                  f"scipy.linalg.qz of the pencil {scipy_ms:.3f} ms (host CPU); bound "
                  f"{bounds[name]['bound_ms']:.6g} ms ({bounds[name]['bound_by']})")
            if dt == torch.complex64:
                res[name] = dict(ms=ms, device_ms=dev, plain_ms=pm, library_ms=None,
                                 scipy_cpu_ms=scipy_ms, **bounds[name])
            else:
                res[name].update(ms_c128=ms, device_ms_c128=dev, plain_ms_c128=pm,
                                 scipy_cpu_ms_c128=scipy_ms,
                                 bound_ms_c128=bounds[name]["bound_ms"],
                                 bound_by_c128=bounds[name]["bound_by"])
    for name in res:
        res[name]["max_abs_err"] = errs[name]
    return res


def _gevd_plain_case(mats):
    """A host process's job: the plain versions of ``hess_tri_batched`` and
    ``real_qz_batched`` on the CPU copies ``mats`` = (h, r, q, z, sizes), on
    one thread, the second on the first's output as on the card."""
    torch.set_num_threads(1)
    from faer_tpu_torch.ops.kernels import hess_tri as kh
    from faer_tpu_torch.ops.kernels import real_qz as kq

    *m, sizes = mats
    red = kh.hess_tri_batched_plain(*m, sizes)
    return red, kq.real_qz_batched_plain(*red, sizes)


def gevd_cases() -> tuple:
    """(nmax, sizes, dtype, rank-deficient B) of phase 3's hess_tri and
    real_qz checks: GEVD_CASES in float32 and float64, both sides of each
    kernel's shared-memory edge (the largest nmax whose four matrices it
    keeps in shared memory, by bisection over its route, and the next), a
    pencil whose B has a zero column at 48 (the infinite-eigenvalue step),
    and the ragged batch GEVD_RAGGED."""
    from faer_tpu_torch.ops.kernels import hess_tri as kh
    from faer_tpu_torch.ops.kernels import real_qz as kq

    out = []
    for dt in (torch.float32, torch.float64):
        edges = sorted({e + d for e in (kh.shared_edge(dt), kq.shared_edge(dt)) for d in (0, 1)})
        out += [(n, (n,) * b, dt, False) for n, b in GEVD_CASES]
        out += [(n, (n,), dt, False) for n in edges]
        out += [(48, (48,), dt, True), (GEVD_RAGGED[0], GEVD_RAGGED[1], dt, False)]
    return tuple(out)


def _gevd_inputs(nmax: int, batch: int, dt, rank_deficient: bool, gen):
    """The Givens chain's inputs on the card, (h, r, q, z) (batch, nmax,
    nmax) in ``dt``: the QR of a Gaussian B (a zero column 3 when
    ``rank_deficient``), Q₀ᵀA for a Gaussian A, Z = I."""
    a = torch.randn(batch, nmax, nmax, generator=gen, device=DEV, dtype=torch.float64)
    b = torch.randn(batch, nmax, nmax, generator=gen, device=DEV, dtype=torch.float64)
    if rank_deficient:
        b[:, :, min(3, nmax - 1)] = 0
    q, r = torch.linalg.qr(b)
    z = torch.eye(nmax, device=DEV, dtype=torch.float64).repeat(batch, 1, 1)
    return tuple(x.to(dt).contiguous() for x in (q.mT @ a, torch.triu(r), q, z))


def _gevd_kernels(gen) -> dict:
    """``hess_tri_batched`` (the Hessenberg–triangular Givens chain) and
    ``real_qz_batched`` (the QZ iteration, on the first's output), one CTA
    a problem and one launch each, against their plain versions on every
    case of ``gevd_cases``, each case's routes printed: the reduction's H,
    R, Q, Z and the QZ's S, T, Q, Z, iterations, converged and chase steps
    equal to the bit (the plain versions run on CPU copies in
    GEVD_WORKERS host processes while the card runs the kernels: IEEE
    operations only, so the two devices round alike); every problem
    converged; on the full pencils Q S Zᵀ and Q T Zᵀ within 8·n·eps of
    Q₀H₀ and Q₀R₀ (A and B), the rank-deficient B's T with one zero on its
    diagonal (:func:`_check_gevd_case`). Once those processes have ended,
    each kernel timed at 96 per call and on the device (CUDA
    graph) in both dtypes, beside its plain version on the card (one call,
    float32) and scipy.linalg.qz of the same pencil on the host (PyTorch
    has no QZ). The bounds count this run's work: ``hess_tri_flops``, and the QZ's
    chase steps × ``qz_step_flops`` + its iterations × 6 flops a row, over
    the FP32 (FP64) peak; the four matrices read and written once."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    import scipy.linalg

    from faer_tpu_torch.ops.kernels import hess_tri as kh
    from faer_tpu_torch.ops.kernels import real_qz as kq

    cases = gevd_cases()
    inputs = [_gevd_inputs(nmax, len(sizes), dt, rd, gen) for nmax, sizes, dt, rd in cases]
    sizes_all = [torch.tensor(sz, dtype=torch.int32, device=DEV) for _, sz, _, _ in cases]
    res = {}
    with ProcessPoolExecutor(GEVD_WORKERS,
                             mp_context=multiprocessing.get_context("spawn")) as pool:
        jobs = [pool.submit(_gevd_plain_case, tuple(x.cpu() for x in (*mats, sz)))
                for mats, sz in zip(inputs, sizes_all)]
        got = []
        for mats, sz in zip(inputs, sizes_all):
            red = kh.hess_tri_batched(*mats, sz)
            got.append((red, kq.real_qz_batched(*red, sz)))
        torch.cuda.synchronize()
        plains = [job.result() for job in jobs]
    # the timed pencil at 96, once the host processes have ended
    for dt in (torch.float32, torch.float64):
        n = 96
        mats = _gevd_inputs(n, 1, dt, False, gen)
        sz = torch.full((1,), n, dtype=torch.int32, device=DEV)
        red = kh.hess_tri_batched(*mats, sz)
        out = kq.real_qz_batched(*red, sz)
        its, steps = int(out[4][0]), int(out[6][0])
        times = {}
        for name, fn, plain in (
                ("hess_tri", lambda: kh.hess_tri_batched(*mats, sz),
                 lambda: kh.hess_tri_batched_plain(*mats, sz)),
                ("real_qz", lambda: kq.real_qz_batched(*red, sz),
                 lambda: kq.real_qz_batched_plain(*red, sz))):
            ms = cuda_ms(fn, GEVD_REPS)
            dev = graph_ms(fn, GEVD_REPS)
            plain_ms = None
            if dt == torch.float32:  # the plain version on the card, f32 only
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                plain()
                torch.cuda.synchronize()
                plain_ms = (time.perf_counter() - t0) * 1e3
            times[name] = (ms, dev, plain_ms)
        a64 = (mats[2][0].double() @ mats[0][0].double()).cpu().numpy()
        b64 = (mats[2][0].double() @ mats[1][0].double()).cpu().numpy()
        scipy_ms = statistics.median(_host_ms(lambda: scipy.linalg.qz(a64, b64)) for _ in range(3))
        esize = torch.finfo(dt).bits // 8
        nbytes = 8 * n * n * esize
        peak = PEAK_F32_FLOPS if dt == torch.float32 else PEAK_F64_FLOPS
        bounds = {"hess_tri": bound_of(hess_tri_flops(n), nbytes, peak),
                  "real_qz": bound_of(steps * qz_step_flops(n) + its * 6 * n, nbytes, peak)}
        tag = "f32" if dt == torch.float32 else "f64"
        for name, (ms, dev, plain_ms) in times.items():
            extra = f", {its} iterations, {steps} chase steps ({dev / max(steps, 1) * 1e3:.3f} us a step)" \
                if name == "real_qz" else f" ({dev / ((n - 1) * (n - 2) / 2) * 1e3:.3f} us a pair)"
            plain = "" if plain_ms is None else \
                f"; plain {plain_ms:.1f} ms (one call on a host core, another window of 96)"
            print(f"time {name} n={n} {tag}: per call {ms:.4f} ms, device {dev:.4f} ms "
                  f"(graph replay){extra}{plain}; scipy.linalg.qz of the pencil "
                  f"{scipy_ms:.3f} ms (host CPU); bound {bounds[name]['bound_ms']:.6g} ms "
                  f"({bounds[name]['bound_by']})")
            if dt == torch.float32:
                res[name] = dict(ms=ms, device_ms=dev, plain_ms=plain_ms, library_ms=None,
                                 scipy_cpu_ms=scipy_ms, **bounds[name])
            else:
                res[name].update(ms_f64=ms, device_ms_f64=dev, scipy_cpu_ms_f64=scipy_ms,
                                 bound_ms_f64=bounds[name]["bound_ms"],
                                 bound_by_f64=bounds[name]["bound_by"])
    errs = {"hess_tri": 0.0, "real_qz": 0.0}
    for (nmax, sizes, dt, rd), mats, (red, qz), plain in zip(cases, inputs, got, plains):
        _check_gevd_case(nmax, sizes, dt, rd, mats, red, qz, plain, errs)
    for name in res:
        res[name]["max_abs_err"] = errs[name]
    return res


def _check_gevd_case(nmax, sizes, dt, rd, mats, red, qz, plain, errs: dict) -> None:
    """One case of phase 3's hess_tri and real_qz checks: the kernels'
    outputs ``red`` and ``qz`` against their plain versions' ``plain`` =
    (reduction, QZ) to the bit, each kernel's largest difference folded
    into ``errs``; every problem converged; on a full pencil Q S Zᵀ and
    Q T Zᵀ within 8·n·eps of Q₀H₀ and Q₀R₀ (A and B), and a rank-deficient
    B's T with one zero on its diagonal."""
    from faer_tpu_torch.ops.kernels import hess_tri as kh
    from faer_tpu_torch.ops.kernels import real_qz as kq

    pred, pqz = plain
    red, qz = [x.cpu() for x in red], [x.cpu() for x in qz]
    same_red = all(torch.equal(g, w) for g, w in zip(red, pred))
    same_qz = all(torch.equal(g, w) for g, w in zip(qz, pqz))
    for name, g, w, same in (("hess_tri", red, pred, same_red), ("real_qz", qz[:4], pqz[:4], same_qz)):
        errs[name] = max(errs[name], 0.0 if same else max(
            (x.double() - y.double()).abs().max().item() for x, y in zip(g, w)))
    live = [b for b, n in enumerate(sizes) if n >= 1]
    conv = bool(qz[5][live].all())
    tag = "f32" if dt == torch.float32 else "f64"
    detail = ""
    ok = same_red and same_qz and conv
    if len(set(sizes)) == 1 and nmax > 1:  # a full pencil: A = Q₀H₀, B = Q₀R₀
        tol = 8 * nmax * torch.finfo(dt).eps
        q0, h0, r0 = (x.double().to(DEV) for x in (mats[2], mats[0], mats[1]))
        s, t, q, z = (x.double().to(DEV) for x in qz[:4])
        a, b = q0 @ h0, q0 @ r0
        rec = max(((q @ x @ z.mT - y).norm(dim=(-2, -1)) / y.norm(dim=(-2, -1))).max().item()
                  for x, y in ((s, a), (t, b)))
        ok = ok and rec <= tol
        detail = f"; |A - QSZᵀ|, |B - QTZᵀ| relative {rec:.3e} <= {tol:.3e}"
        if rd:
            zeros = int((torch.diagonal(qz[1][0]) == 0).sum())
            ok = ok and zeros == 1
            detail += f"; B of rank n - 1: {zeros} zero on T's diagonal (1)"
    check(ok, f"hess_tri + real_qz nmax={nmax} sizes={list(sizes)} {tag} [hess_tri in "
              f"{kh.route(nmax, dt)}, real_qz in {kq.route(nmax, dt)} memory, "
              f"{min(CTA_THREADS, (nmax + 31) // 32 * 32)} threads a CTA]: reduction "
              f"and QZ equal to the plain versions to the bit {same_red}, {same_qz}; all "
              f"converged {conv} ({qz[4].tolist()} iterations, {qz[6].tolist()} chase "
              f"steps){detail}")


def _gevd_plain_daemon(name: str, mats, sizes, conn) -> None:
    """A host process's job: the plain version of ``hess_tri_batched``
    (``name`` "hess_tri"), of ``real_qz_batched`` ("real_qz") or of
    ``complex_hess_tri_batched`` ("complex_hess_tri") on the CPU copies
    ``mats``, on one thread; its outputs sent down ``conn`` as arrays,
    with the seconds it took."""
    torch.set_num_threads(1)
    from faer_tpu_torch.ops.kernels import complex_qz as kcq
    from faer_tpu_torch.ops.kernels import hess_tri as kh
    from faer_tpu_torch.ops.kernels import real_qz as kq

    fn = {"hess_tri": kh.hess_tri_batched_plain, "real_qz": kq.real_qz_batched_plain,
          "complex_hess_tri": kcq.complex_hess_tri_batched_plain}[name]
    t0 = time.perf_counter()
    out = [x.numpy() for x in fn(*mats, sizes)]
    conn.send((out, time.perf_counter() - t0))
    conn.close()


def start_gevd_wide() -> list:
    """Phase 3's hess_tri and real_qz cases past the kernels' CTA_THREADS
    (GEVD_WIDE, the first at the main path's width): each thread takes two
    entries of every row, the CTA reductions span 16 warps, the four
    matrices sit in global memory. The kernels run on the card (inputs
    from a generator of their own, seed SEED + 3), and the plain version
    of each on the same inputs (the QZ's on the kernel's reduction) starts
    in a spawned daemon process of its own, one thread each, to run beside
    phases 4–14: [(nmax, dtype, inputs, reduction, QZ, [(process,
    receiving end of its pipe)] × 2)], the tensors on the CPU, for
    :func:`finish_gevd_wide`. Last, ``complex_hess_tri`` at
    COMPLEX_GEVD_WIDE in complex64 the same way (the chain alone: QZ None,
    one process)."""
    import multiprocessing

    from faer_tpu_torch.ops.kernels import complex_qz as kcq
    from faer_tpu_torch.ops.kernels import hess_tri as kh
    from faer_tpu_torch.ops.kernels import real_qz as kq

    ctx = multiprocessing.get_context("spawn")
    gen = torch.Generator(device=DEV).manual_seed(SEED + 3)
    pending = []

    def start(name, args, sz):
        recv, send = ctx.Pipe(duplex=False)
        proc = ctx.Process(target=_gevd_plain_daemon, daemon=True,
                           args=(name, args, sz.cpu(), send))
        proc.start()
        send.close()
        return proc, recv

    for n, dt in GEVD_WIDE:
        mats = _gevd_inputs(n, 1, dt, False, gen)
        sz = torch.full((1,), n, dtype=torch.int32, device=DEV)
        red = kh.hess_tri_batched(*mats, sz)
        qz = kq.real_qz_batched(*red, sz)
        mats, red, qz = ([x.cpu() for x in xs] for xs in (mats, red, qz))
        jobs = [start("hess_tri", mats, sz), start("real_qz", red, sz)]
        pending.append((n, dt, mats, red, qz, jobs))
    n = COMPLEX_GEVD_WIDE
    mats = _complex_gevd_inputs(n, 1, torch.complex64, None, gen)
    sz = torch.full((1,), n, dtype=torch.int32, device=DEV)
    red = [x.cpu() for x in kcq.complex_hess_tri_batched(*mats, sz)]
    mats = [x.cpu() for x in mats]
    pending.append((n, torch.complex64, mats, red, None, [start("complex_hess_tri", mats, sz)]))
    return pending


def finish_gevd_wide(pending: list, kern: dict) -> None:
    """Wait for :func:`start_gevd_wide`'s plain versions and their
    processes; check each case as phase 3 does (:func:`_check_gevd_case`),
    and fold each kernel's largest difference into ``kern``'s
    max_abs_err."""
    errs = {name: kern[name]["max_abs_err"]
            for name in ("hess_tri", "real_qz", "complex_hess_tri", "complex_qz")}
    for n, dt, mats, red, qz, jobs in pending:
        plain, secs = [], []
        for proc, recv in jobs:
            out, sec = recv.recv()
            plain.append([torch.from_numpy(x) for x in out])
            secs.append(sec)
            proc.join()
        if dt.is_complex:
            print(f"time plain complex_hess_tri n={n} c64: {secs[0]:.1f} s (one host core, "
                  f"beside phases 4–14)")
            _check_complex_gevd_case(n, (n,), 30, dt, None, mats, red, None,
                                     (plain[0], None), errs)
            continue
        print(f"time plain hess_tri, real_qz n={n} {'f32' if dt == torch.float32 else 'f64'}: "
              f"{secs[0]:.1f} s, {secs[1]:.1f} s (one host core each, beside phases 4–14)")
        _check_gevd_case(n, (n,), dt, False, mats, red, qz, plain, errs)
    for name, err in errs.items():
        kern[name]["max_abs_err"] = err


def _host_ms(fn) -> float:
    """One call of the host function ``fn``, in ms (host clock)."""
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


def _leaf_library_ms(d, e, ints, bidiag: bool) -> float:
    """``torch.linalg.eigh`` (tridiagonal) or ``torch.linalg.svd``
    (bidiagonal) of the batch's problems as dense blocks, one batched call
    a shape, per call (CUDA events, median of 3): summed over the shapes."""
    sizes = ints[0].tolist()
    sqre = ints[1].tolist() if bidiag else [0] * len(sizes)
    groups = {}
    for b, (n, sq) in enumerate(zip(sizes, sqre)):
        groups.setdefault((n, sq), []).append(b)
    total = 0.0
    for (n, sq), rows in groups.items():
        idx = torch.tensor(rows, device=DEV)
        dd = torch.diag_embed(d[idx, :n])
        if bidiag:
            t = torch.cat([dd, dd.new_zeros(len(rows), n, sq)], dim=2)
            k = torch.arange(n - 1 + sq, device=DEV)
            t[:, k, k + 1] = e[idx, :n - 1 + sq]
            total += cuda_ms(lambda t=t: torch.linalg.svd(t, full_matrices=False), 3)
        else:
            t = dd + torch.diag_embed(e[idx, :n - 1], 1) + torch.diag_embed(e[idx, :n - 1], -1)
            total += cuda_ms(lambda t=t: torch.linalg.eigh(t), 3)
    return total


def _row_col_scale(a, b) -> float:
    """max_i ‖a_i‖₂ · max_j ‖b_j‖₂, a bound on every (|A||B|)_ij."""
    return (a.float().norm(dim=1).max() * b.float().norm(dim=0).max()).item()


def _plan_of(x, y):
    """The plan ``tile_matmul`` takes for ``x``·``y`` under the current
    ``config.f32_precision``, as one line."""
    from faer_tpu_torch.core.config import config
    from faer_tpu_torch.ops.kernels import matmul as kmm

    p = kmm.plan_tile_matmul(x.shape[0], y.shape[1], x.shape[1], x.dtype,
                             config.tile_precision(), x.stride(), y.stride(),
                             x.data_ptr(), y.data_ptr(), kmm._sms(x.device))
    return (f"{p.route} {p.tile[0]}x{p.tile[1]}x{p.bk} split {p.split}, "
            f"A {p.a}, B {p.b}")


def _offset_view(x):
    """The values of ``x`` in a view that starts one element past an aligned
    base, in x's own layout (a transposed view stays one): neither TMA nor a
    16-byte copy can take it."""
    t = x.mT if x.stride(0) == 1 and x.stride(1) != 1 else x
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    v = flat[1:].view(t.shape)
    v.copy_(t)
    return v.mT if t is not x else v


def tile_matmul_rows(gen):
    """(mode, label, x, y, call, library call) of the timed ``tile_matmul``
    cases: each mode at 4096³ and at the facade's two thin products, the
    Householder Vᵀ·B (128, 4096)·(4096, 3968) and an 8-column Vᵀ·b, both
    with a ``.mT`` lhs, beside ``torch.matmul`` on the same operands
    (``tools/torch_split.py matmul`` times the same rows)."""
    from faer_tpu_torch.core.config import config
    from faer_tpu_torch.ops.kernels.matmul import tile_matmul

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=DEV)

    v = randn(N, TILE)
    ops = {f"{N}^3": (randn(N, N), randn(N, N)),
           f"Vᵀ·B ({TILE}, {N})·({N}, {N - TILE}), .mT lhs": (v.mT, randn(N, N - TILE)),
           f"Vᵀ·b ({TILE}, {N})·({N}, 8), .mT lhs": (v.mT, randn(N, 8))}
    for mode in ("highest", "high", "bf16"):
        prec = "highest" if mode == "bf16" else mode
        for label, (x, y) in ops.items():
            if mode == "bf16":  # the layout kept: a .mT view stays one
                x, y = x.bfloat16(), y.bfloat16()

            def call(x=x, y=y, prec=prec):
                config.f32_precision = prec
                return tile_matmul(x, y)

            yield mode, label, x, y, call, (lambda x=x, y=y: torch.matmul(x, y))


# phase 3's syrk_lower_sub cases (label, m, k, A M-major): the trailing
# update of a 4096 LLT at block 256 with a row-major (K-major) A, as the
# main path would hand it over, and with an M-major one; ragged; a k that is
# not a multiple of 4 (A's rows not 16-byte aligned)
SYRK_CASES = (("K-major", N - 256, 256, False), ("M-major", N - 256, 256, True),
              ("K-major", 300, 200, False), ("K-major", 300, 257, False))


def _tile_kernels(gen) -> dict:
    """``tile_matmul`` in its three modes (f32 "highest" and "high", bf16)
    and ``syrk_lower_sub`` in its two, against their plain versions: the
    GEMM at 4096³ (the facade's product), a ragged (3000, 1000)·(1000, 2050),
    both with transposed (strided) operands, views one element past an
    aligned base (no TMA, no 16-byte copy), long k ((256, 16384)·(16384,
    256), split; (2048, 16384)·(16384, 2048), one CTA a tile over all of k)
    and the main path's thin products (a QR block apply Vᵀ·B and an 8-column
    Vᵀ·b, split; an 8-column TRSM update, an LLT trailing update); each
    case's plan printed. The SYRK at ``SYRK_CASES``: (3840, 256), the
    trailing update of a 4096 LLT at block 256, with a K-major and an
    M-major A, a ragged (300, 200) and (300, 257), each case's read of A
    printed, the upper triangle C's values bit for bit. Limits ``F32_TOL``
    and ``BF16X3_TOL``; bf16x3 is also held against f64, and a bf16 result
    against the plain f32 one, past one bf16 rounding of each entry. Timed,
    per call and on the device beside ``torch.matmul``, at 4096³ and the
    two Vᵀ products in each mode (``tile_matmul_rows``), and the SYRK at
    (3840, 256) beside ``torch.addmm``."""
    from faer_tpu_torch.core.config import config
    from faer_tpu_torch.ops.kernels.matmul import tile_matmul, tile_matmul_plain
    from faer_tpu_torch.ops.kernels.syrk import syrk_lower_sub, syrk_lower_sub_plain, syrk_read

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=DEV)

    n = N
    a, b = randn(n, n), randn(n, n)
    ar, br = randn(3000, 1000), randn(1000, 2050)
    ao, bo = randn(1000, 1000), randn(1000, 1000)
    v, w = randn(n, TILE), randn(n - 256, 256)
    cases = {f"{n}^3": (a, b), "(3000, 1000)·(1000, 2050)": (ar, br),
             f"{n}^3 .mT operands": (b.mT, a.mT),
             "(2050, 1000)·(1000, 3000) .mT operands": (br.mT, ar.mT),
             "(1000, 1000)² offset views": (_offset_view(ao), _offset_view(bo)),
             "(1000, 1000)² offset .mT views": (_offset_view(bo.mT), _offset_view(ao.mT)),
             "long k (256, 16384)·(16384, 256)": (randn(256, 16384), randn(16384, 256)),
             "long k (2048, 16384)·(16384, 2048)": (randn(2048, 16384), randn(16384, 2048)),
             f"QR apply (128, {n})·({n}, {n - TILE}), .mT lhs": (v.mT, randn(n, n - TILE)),
             f"Vᵀ·b (128, {n})·({n}, 8), .mT lhs": (v.mT, randn(n, 8)),
             f"TRSM update ({n - TILE}, 128)·(128, 8)": (randn(n - TILE, TILE), randn(TILE, 8)),
             f"LLT update ({n - 256}, 256)·(256, {n - 256}), .mT rhs": (w, w.mT)}
    errs = []
    for mode in ("highest", "high", "bf16"):
        config.f32_precision = "highest" if mode == "bf16" else mode
        lim = BF16X3_TOL if mode == "high" else F32_TOL
        for label, (x, y) in cases.items():
            if mode == "bf16":  # the layout kept, an offset view's offset too
                x, y = ((_offset_view(t.bfloat16()) if "offset" in label else t.bfloat16())
                        for t in (x, y))
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
                check(ok, f"tile_matmul {mode} {label} -> {str(out)[6:]} [{_plan_of(x, y)}]: "
                          f"max abs err {msg} <= {lim:.3e}")
    timed = {}
    for mode, label, x, y, call, lib in tile_matmul_rows(gen):
        m, k = x.shape
        nn = y.shape[1]
        flops = 2 * m * k * nn
        nbytes = (m * k + k * nn) * x.element_size() + m * nn * x.element_size()
        peak = PEAK_F32_FLOPS if mode == "highest" else PEAK_BF16_FLOPS
        passes = 3 if mode == "high" else 1
        r = dict(ms=cuda_ms(call, TILE_REPS), graph_ms=graph_ms(call, TILE_REPS),
                 library_ms=cuda_ms(lib, TILE_REPS), library_graph_ms=graph_ms(lib, TILE_REPS),
                 **bound_of(passes * flops, nbytes, peak))
        plan = _plan_of(x, y)
        if label == f"{n}^3":
            r["plain_ms"] = cuda_ms(lambda: tile_matmul_plain(x, y), 3)
            timed[mode] = r
        print(f"time tile_matmul {mode} {label} [{plan}]: per call {r['ms']:.4f} ms, "
              f"device {r['graph_ms']:.4f} ms ({flops / r['graph_ms'] / 1e9:.2f} TFLOP/s); "
              f"torch.matmul {r['library_ms']:.4f} / {r['library_graph_ms']:.4f} ms; bound "
              f"{r['bound_ms']:.6g} ms ({r['bound_by']}, {passes} "
              f"pass{'es' if passes > 1 else ''})"
              + (f"; plain {r['plain_ms']:.4f} ms" if "plain_ms" in r else ""))
    config.f32_precision = "highest"
    res = {"matmul": dict(max_abs_err=max(errs), **timed["highest"])}

    errs, timed = [], {}
    for mode in ("highest", "high"):
        config.f32_precision = mode
        tol = BF16X3_TOL if mode == "high" else F32_TOL
        for label, m, k, m_major in SYRK_CASES:
            c = randn(m, m)
            x = randn(k, m).mT if m_major else randn(m, k)
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
            read = "split" if mode == "high" else syrk_read(x)
            check(ok, f"syrk_lower_sub {mode} ({m}, {k}) {label} [A read {read}]: lower max "
                      f"abs err {msg} <= {tol:.3e}; upper triangle C's values bit for bit "
                      f"{kept}")
            if m != n - 256 or (m_major and mode == "high"):
                continue
            # the function's work: the lower triangle with its diagonal,
            # m(m+1)/2 dot products of length k; its bytes: A read once, the
            # whole C read and the whole result written
            passes = 3 if mode == "high" else 1
            peak = PEAK_BF16_FLOPS if mode == "high" else PEAK_F32_FLOPS
            r = dict(ms=cuda_ms(lambda: syrk_lower_sub(c, x), 20),
                     graph_ms=graph_ms(lambda: syrk_lower_sub(c, x), 20),
                     plain_ms=cuda_ms(lambda: syrk_lower_sub_plain(c, x), 5),
                     library_ms=cuda_ms(lambda: torch.addmm(c, x, x.mT, alpha=-1), 20),
                     library_graph_ms=graph_ms(lambda: torch.addmm(c, x, x.mT, alpha=-1), 20),
                     **bound_of(passes * m * (m + 1) * k, (2 * m * m + m * k) * 4, peak))
            if not m_major:
                timed[mode] = r
            print(f"time syrk_lower_sub {mode} ({m}, {k}) {label}: per call {r['ms']:.4f} ms, "
                  f"device {r['graph_ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, torch.addmm "
                  f"{r['library_ms']:.4f} / {r['library_graph_ms']:.4f} ms, bound "
                  f"{r['bound_ms']:.6g} ms ({r['bound_by']}, {passes} "
                  f"pass{'es' if passes > 1 else ''})")
    config.f32_precision = "highest"
    res["syrk"] = dict(max_abs_err=max(errs), **timed["highest"])
    return res


def _mirrored(a):
    """The symmetric matrix of ``a``'s lower triangle, in full storage."""
    lo = torch.tril(a)
    return lo + torch.tril(lo, -1).mT


def _llt_block_kernels(gen) -> dict:
    """``llt_leaf``, ``llt_block`` and ``llt_block_v3`` (rows 6, 17, 19), the
    three wrappers of the one blocked kernel ``csrc/llt_block.cu``, on
    mirrored SPD blocks (cond ≤ 5) at ``LLT_BLOCKS`` (shared memory up to
    b = 337, L2 above) and on the regularized blocks ``LLT_REGULARIZED``
    (``_regularized_spd``: with eps = delta = 1 three pivots replaced and
    counted; with eps = 0 each negative pivot becomes 1, uncounted), and on
    (b, b) views of (b + 3, b + 3) blocks at ``LLT_STRIDED`` (the recursive
    driver's leaves are such views), which must also give the bits of a
    contiguous copy: L within
    8·b·eps of its largest entry from each wrapper's plain version and
    within b·eps from the kernel's own order (``llt_block_blocked_plain``),
    ‖LLᵀ − A‖/‖A‖ ≤ 8·b·eps in f64, count and ok as wanted, zeros above
    the diagonal. Timed at b ∈ {128, 256, 512} beside ``cholesky_ex`` two
    ways: per call (``cuda_ms``, what a caller pays, the host's wrapper
    included) and on the device (``graph_ms``), with the bound (b³/3 FP32
    operations, the block read and L written once); the JSON rows keep
    b = 128, row 6's shape."""
    from faer_tpu_torch.ops.kernels.leaf import llt_leaf, llt_leaf_plain
    from faer_tpu_torch.ops.kernels.llt_block import (
        llt_block, llt_block_blocked_plain, llt_block_plain, llt_block_v3,
        llt_block_v3_plain, route)

    kernels = {"llt_leaf": (llt_leaf, llt_leaf_plain),
               "llt_block": (llt_block, llt_block_plain),
               "llt_block_v3": (llt_block_v3, llt_block_v3_plain)}
    errs = {name: [] for name in kernels}
    cases = ([(b, None, 0.0, False) for b in LLT_BLOCKS]
             + [(b, bad, eps, False) for b, bad, eps in LLT_REGULARIZED]
             + [(b, None, 0.0, True) for b in LLT_STRIDED])
    for b, bad, eps, strided in cases:
        if bad is None:
            full = _mirrored(_spd(b + 3 if strided else b, gen))
            a, reg, want = full[:b, :b], {}, (0, True)
        else:
            a = _mirrored(_regularized_spd(b, torch.tensor(bad, device=DEV), gen))
            reg = dict(eps=eps, delta=eps)
            want = (len(bad) if eps > 0 else 0, False)
        l3, c3, o3 = llt_block_blocked_plain(a, **reg)
        for name, (kern, plain) in kernels.items():
            (l1, c1, o1), (l2, c2, o2) = kern(a, **reg), plain(a, **reg)
            torch.cuda.synchronize()
            tol = 8 * b * EPS32
            err, rel = _max_rel(l1, l2)
            _, rel3 = _max_rel(l1, l3)
            l64 = l1.double()
            resid = rel_norm(l64 @ l64.T, a.double())
            errs[name].append(err)
            tallies = (int(c1), bool(o1))
            same = not strided or torch.equal(l1, kern(a.contiguous(), **reg)[0])
            check(rel <= tol and rel3 <= b * EPS32 and (bad is not None or resid <= tol)
                  and tallies == (int(c2), bool(o2)) == (int(c3), bool(o3)) == want
                  and bool((torch.triu(l1, 1) == 0).all()) and same,
                  f"{name} b={b}{f' eps=delta={eps:g}' if bad else ''}"
                  f"{' row stride b+3 (= a contiguous copy)' if strided else ''} "
                  f"[{route(b)}]: max abs err {err:.3e}, rel {rel:.3e} vs plain "
                  f"(<= {tol:.3e}), {rel3:.3e} vs the blocked order (<= "
                  f"{b * EPS32:.3e}), |LLᵀ-A|/|A| {resid:.3e}; (count, ok) {tallies}")
    res = {}
    for b in LLT_TIMED:
        a = _mirrored(_spd(b, gen))
        chol = lambda: torch.linalg.cholesky_ex(a)
        lib_ms, lib_dev = cuda_ms(chol, LLT_CALL_REPS), graph_ms(chol, LLT_GRAPH_REPS)
        print(f"time cholesky_ex b={b}: per call {lib_ms:.4f} ms, device "
              f"{lib_dev:.4f} ms")
        for name, (kern, plain) in kernels.items():
            r = dict(max_abs_err=max(errs[name]), ms=cuda_ms(lambda: kern(a), LLT_CALL_REPS),
                     device_ms=graph_ms(lambda: kern(a), LLT_GRAPH_REPS),
                     plain_ms=cuda_ms(lambda: plain(a), 3) if b == LLT_TIMED[0] else None,
                     library_ms=lib_ms, library_device_ms=lib_dev,
                     # the lower triangle read once, the (b, b) factor written
                     **bound_of(b ** 3 / 3, 4 * (lower_floats(b) + b * b)))
            print(f"time {name} b={b} [{route(b)}]: per call {r['ms']:.4f} ms, "
                  f"device {r['device_ms']:.4f} ms; cholesky_ex {lib_ms:.4f} / "
                  f"{lib_dev:.4f} ms; bound {r['bound_ms']:.6g} ms ({r['bound_by']})"
                  + ("" if r["plain_ms"] is None else f"; plain {r['plain_ms']:.4f} ms"))
            res.setdefault(name, r)
    return res


def chase_step_flops(b: int) -> int:
    """Operations of one chase window step, counted from ``_window_step``:
    ‖x‖² 2b, v b, u = τ W v 4b² + 2b, vᵀu 2b, w̃ 4b, the rank-2 update 16b²."""
    return 20 * b * b + 11 * b


def chase_cases() -> tuple:
    """CHASE_CASES with both sides of the chase kernel's route edge on this
    card: the largest b whose strip a cluster holds in shared memory, and
    the next, whose strip the cluster keeps in a global copy."""
    from faer_tpu_torch.ops.kernels.band_chase import device_facts, shared_edge

    edge = shared_edge(*device_facts())
    return CHASE_CASES + ((edge, 1, 24), (edge + 1, 1, 24))


def _chase_zero_tail(b: int, g: int, gen):
    """A strip whose every first window has α = 0.75 and rows 2..b of
    column 0 zero: tail_sq = 0, so τ = 0 and one step is the identity."""
    band = torch.randn(g * 4 * b, 2 * b, generator=gen, device=DEV)
    for gi in range(g):
        band[gi * 4 * b + 1, 0] = 0.75
        band[gi * 4 * b + 2:gi * 4 * b + b + 1, 0] = 0.0
    return band


def _chase_kernel(gen) -> dict:
    """``chase_probe`` (row 20), one thread-block cluster a strip, against
    its plain version at ``chase_cases`` (each case's route printed: the
    strip's columns in the shared memory of the cluster's CTAs up to the
    edge, in a global copy past it) within 8·2b·eps of the output's largest
    entry (the values grow with the steps, so only short runs are held), one
    launch a call; on a zero-tail window (α = 0.75, rows 2..b of column 0
    zero: τ = 0) on both routes, which one step must leave unchanged to the
    bit. Timed at (128, 8, 24) per call and on the device (a CUDA graph);
    no PyTorch call computes a chase step; the bound counts
    ``chase_step_flops`` and the strip read and written once (PERF.md §6
    gives the chain latency per step from phase 12)."""
    from faer_tpu_torch.core.config import launch_counts, reset_launch_counts
    from faer_tpu_torch.ops.kernels.band_chase import chase_probe, chase_probe_plain, route

    errs = []
    cases = chase_cases()
    for b, g, steps in cases:
        band = torch.randn(g * 4 * b, 2 * b, generator=gen, device=DEV)
        reset_launch_counts()
        got = chase_probe(band, b=b, steps=steps, g=g)
        torch.cuda.synchronize()
        one = launch_counts()["chase_probe"] == 1
        want = chase_probe_plain(band, b=b, steps=steps, g=g)
        top = want.abs().max().item()
        err = (got - want).abs().max().item()
        errs.append(err)
        tol = 8 * 2 * b * EPS32 * top
        p = route(b, g)
        check(one and bool(torch.isfinite(got).all()) and err <= tol,
              f"chase_probe b={b} g={g} steps={steps} [{p.route}, {p.ctas} CTAs of {p.cw} "
              f"columns]: max abs err {err:.3e} <= {tol:.3e} (8·2b·eps of max|out| {top:.4g}); "
              f"one launch {one}; bitwise equal {torch.equal(got, want)}")
    for b in (64, cases[-1][0]):
        g = 2
        band = _chase_zero_tail(b, g, gen)
        one = chase_probe(band, b=b, steps=1, g=g)
        got = chase_probe(band, b=b, steps=3, g=g)
        want = chase_probe_plain(band, b=b, steps=3, g=g)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        tol = 8 * 2 * b * EPS32 * want.abs().max().item()
        check(torch.equal(one, band) and err <= tol,
              f"chase_probe zero-tail window b={b} g={g} [{route(b, g).route}]: one step leaves "
              f"the strip unchanged {torch.equal(one, band)}; 3 steps max abs err {err:.3e} "
              f"<= {tol:.3e}")
    b, g, steps = CHASE_CASES[-1]
    band = torch.randn(g * 4 * b, 2 * b, generator=gen, device=DEV)
    call = lambda: chase_probe(band, b=b, steps=steps, g=g)
    p = route(b, g)
    r = dict(max_abs_err=max(errs), ms=cuda_ms(call, CHASE_REPS),
             device_ms=graph_ms(call, CHASE_REPS),
             plan=f"{p.route}, {p.ctas} CTAs of {p.cw} columns",
             plain_ms=cuda_ms(lambda: chase_probe_plain(band, b=b, steps=steps, g=g), 3),
             library_ms=None,  # no PyTorch call computes a chase step
             **bound_of(steps * g * chase_step_flops(b), 2 * g * 8 * b * b * 4))
    print(f"time chase_probe b={b} g={g} steps={steps} [{r['plan']}]: per call {r['ms']:.4f} "
          f"ms, device {r['device_ms']:.4f} ms ({r['device_ms'] * 1e3 / steps:.3f} us/step), "
          f"plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.6g} ms ({r['bound_by']})")
    return {"chase_probe": r}


def _time_solves(lo, b, label: str) -> None:
    """Per-call times of ``solve_lower_triangular`` with ``lo`` and
    ``solve_upper_triangular`` with ``lo``ᵀ (contiguous), each beside
    ``torch.linalg.solve_triangular`` on the same inputs."""
    from faer_tpu_torch.ops.triangular_solve import (
        solve_lower_triangular, solve_upper_triangular)

    n, k = b.shape
    up = lo.mT.contiguous()
    for name, fn, tri, upper in (("solve_lower_triangular", solve_lower_triangular, lo, False),
                                 ("solve_upper_triangular", solve_upper_triangular, up, True)):
        ms = cuda_ms(lambda: fn(tri, b), 5)
        lib = cuda_ms(lambda: torch.linalg.solve_triangular(tri, b, upper=upper), 5)
        print(f"time {name} {n}x{k} ({label}): {ms:.4f} ms; library "
              f"solve_triangular {lib:.4f} ms")


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
          and counts["trtri"] == FLAGSHIP_TRTRI,
          f"llt_panel and lu_panel ran {n // 256} times each, trtri "
          f"{FLAGSHIP_TRTRI} times (one launch per solve and per inverse)")
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
    lib = {"llt_factor": ("cholesky_ex", lambda: torch.linalg.cholesky_ex(a_spd)),
           "lu_in_place": ("lu_factor_ex", lambda: torch.linalg.lu_factor_ex(g))}
    for k, ms in t.items():
        beside = f"; library {lib[k][0]} {cuda_ms(lib[k][1], 5):.4f} ms" if k in lib else ""
        print(f"time {k} n={n}: {ms:.4f} ms, {fl[k] / ms / 1e6:.1f} GFLOP/s{beside}")
    _time_solves(l, b, "L from llt_factor")
    print(f"time flagship_step n={n}: "
          f"{cuda_ms(lambda: flagship_step(a_spd, g, b), 5):.4f} ms")
    return counts


def phase_qr(gen) -> dict:
    """The QR path as ``bench.py`` drives it: ``qr_in_place``, then
    ``qr_solve_lstsq``."""
    from faer_tpu_torch import (
        qr_compute_q, qr_in_place, qr_reconstruct, qr_solve_lstsq)
    from faer_tpu_torch.core.config import launch_counts, reset_launch_counts
    from faer_tpu_torch.ops.triangular_solve import solve_upper_triangular
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
          f"{QR_TRTRI} times (32 in the T factors, 1 in the R solve)")
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
    # the R solve of qr_solve_lstsq (its right-hand side does not change the time)
    r, r_up = packed[:n, :n], torch.triu(packed[:n, :n])
    print(f"time the R solve n={n} (8 rhs): "
          f"{cuda_ms(lambda: solve_upper_triangular(r, b), 5):.4f} ms; library "
          f"solve_triangular "
          f"{cuda_ms(lambda: torch.linalg.solve_triangular(r_up, b, upper=True), 5):.4f} ms")
    print(f"library geqrf n={n}: {cuda_ms(lambda: torch.geqrf(a), 3):.4f} ms, "
          f"{mt}x{nt_}: {cuda_ms(lambda: torch.geqrf(at), 3):.4f} ms, "
          f"{ms2}x{ns2}: {cuda_ms(lambda: torch.geqrf(a2), 3):.4f} ms")
    return counts


def phase_off_route(gen) -> dict:
    """``llt_factor`` and ``lu_in_place`` on shapes off the fused route:
    the recursive drivers and their ``llt_leaf`` / ``lu_leaf`` kernels.
    Each factorization's leaves and ``trtri`` launches are checked against
    the code's counts; the counts are summed."""
    from faer_tpu_torch import llt_factor, llt_reconstruct, lu_in_place, lu_reconstruct
    from faer_tpu_torch.core.config import launch_counts, reset_launch_counts
    from faer_tpu_torch.utils import flops

    total = {}
    for n, want in LLT_OFF_ROUTE.items():
        a = _spd(n, gen)
        torch.cuda.synchronize()
        reset_launch_counts()
        l, info = llt_factor(a)
        torch.cuda.synchronize()
        counts = launch_counts()
        total = {k: total.get(k, 0) + v for k, v in counts.items()}
        rec = rel_norm(llt_reconstruct(l), a)
        tol = 8 * n * EPS32
        check(all(counts[k] == v for k, v in want.items()) and counts["llt_panel"] == 0
              and bool(info.success) and rec <= tol,
              f"llt_factor n={n}: launches {counts} (want {want}), |LLᵀ-A|/|A| = {rec:.3e} "
              f"<= {tol:.3e}")
        ms = cuda_ms(lambda: llt_factor(a), 3)
        print(f"time llt_factor n={n}: {ms:.4f} ms, "
              f"{flops.llt_flops(n) / ms / 1e6:.1f} GFLOP/s; library cholesky_ex "
              f"{cuda_ms(lambda: torch.linalg.cholesky_ex(a), 3):.4f} ms")
    for (m, n), want in LU_OFF_ROUTE.items():
        g = torch.randn(m, n, generator=gen, device=DEV)
        torch.cuda.synchronize()
        reset_launch_counts()
        lu, perm, info = lu_in_place(g)
        torch.cuda.synchronize()
        counts = launch_counts()
        total = {k: total.get(k, 0) + v for k, v in counts.items()}
        rec = rel_norm(lu_reconstruct(lu, perm), g)
        tol = 8 * max(m, n) * EPS32
        check(all(counts[k] == v for k, v in want.items()) and counts["lu_panel"] == 0
              and tuple(lu.shape) == (m, n) and bool(info.success) and rec <= tol,
              f"lu_in_place {m}x{n}: launches {counts} (want {want}), |A[perm]-LU|/|A| = "
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
    tol = 8 * n * torch.finfo(a.dtype).eps
    res = (torch.linalg.matrix_norm(a @ v - v * w[None, :])
           / torch.linalg.matrix_norm(a)).item()
    orth = (v.T @ v - torch.eye(n, device=DEV, dtype=a.dtype)).abs().max().item()
    check(tuple(w.shape) == (n,) and tuple(v.shape) == (n, n)
          and bool(torch.isfinite(v).all()) and bool((w[1:] >= w[:-1]).all()),
          f"{label}: finite, of the expected shapes, ascending")
    check(res <= tol and orth <= tol,
          f"{label}: |AV - VΛ|/|A| = {res:.3e}, max|VᵀV - I| = {orth:.3e}, "
          f"both <= {tol:.3e}")


def _svd_checks(a, u, s, v, label: str) -> None:
    m, n = a.shape
    k = min(m, n)
    tol = 8 * max(m, n) * torch.finfo(a.dtype).eps
    res = rel_norm((u * s[None, :]) @ v.T, a)
    eye = torch.eye(k, device=DEV, dtype=a.dtype)
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


def _one_launch(label: str, name: str, counts: dict, reads: int) -> None:
    """A spectral call's whole QR iteration (every D&C leaf, or the direct
    route's one problem) is one launch of the batched kernel, and nothing
    is read on the host."""
    print(f"launches in {label}: {counts}; host reads {reads}")
    check(counts[name] == 1 and reads == 0,
          f"{label}: {counts[name]} {name} launch (1 predicted), {reads} host reads (0)")


def _wide_dnc_check() -> dict:
    """The wide (n, n+1) bidiagonal D&C ``_dnc(d, e, 1)`` on the golden
    fixture ``tests/data/svd/svd512.txt`` (the reference's hard-convergence
    regression, an (n+1)×n lower bidiagonal read as its transpose), under
    the reference's bounds (``tests/test_bidiag_dnc.py:107-126``): ‖UᵀU −
    I‖_F ≤ 2e-4·n, ‖WᵀW − I‖_F ≤ 2e-4·(n+1), ‖U Σ Wᵀ − B‖ ≤ 2e-4·‖B‖, and
    no zero column of U. Returns the call's launch counts."""
    from faer_tpu_torch.linalg.bidiag_dnc import _dnc

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "tests", "data", "svd", "svd512.txt")
    vals = {"diag": [], "subdiag": []}
    cur = None
    with open(path) as f:
        for line in f:
            line = line.strip().rstrip(",")
            if line in vals:
                cur = vals[line]
            elif line:
                cur.append(float(line))
    d64 = torch.tensor(vals["diag"], dtype=torch.float64, device=DEV)
    e64 = torch.tensor(vals["subdiag"], dtype=torch.float64, device=DEV)
    n = d64.shape[0]
    (u, s, w), counts, reads = _counted(lambda: _dnc(d64.float(), e64.float(), 1))
    b = torch.zeros(n, n + 1, dtype=torch.float64, device=DEV)
    idx = torch.arange(n, device=DEV)
    b[idx, idx], b[idx, idx + 1] = d64, e64
    sig = torch.zeros(n, n + 1, dtype=torch.float64, device=DEV)
    sig[idx, idx] = s[:n].double()
    un, wn = u.double(), w.double()
    fro = torch.linalg.matrix_norm
    orth_u = fro(un.T @ un - torch.eye(n, dtype=torch.float64, device=DEV)).item()
    orth_w = fro(wn.T @ wn - torch.eye(n + 1, dtype=torch.float64, device=DEV)).item()
    rec = (fro(un @ sig @ wn.T - b) / max(1.0, fro(b).item())).item()
    min_col = un.norm(dim=0).min().item()
    _one_launch("_dnc(svd512.txt, sqre=1)", "bidiag_sweep", counts, reads)
    check(orth_u <= 2e-4 * n and orth_w <= 2e-4 * (n + 1) and rec <= 2e-4
          and min_col >= 0.5,
          f"_dnc svd512.txt ({n}, {n + 1}): |UᵀU-I|_F {orth_u:.3e} <= "
          f"{2e-4 * n:.3e}, |WᵀW-I|_F {orth_w:.3e}, |UΣWᵀ-B|/|B| {rec:.3e}, "
          f"smallest column norm of U {min_col:.6f}")
    return counts


def phase_spectral(gen) -> tuple[dict, dict]:
    """The spectral path as ``tools/bench_spectral.py`` drives it:
    ``self_adjoint_evd((g + gᵀ)/2)`` and ``svd(g)``. Returns the launch
    counts and the times, ms, of ``tridiag_in_place`` and ``eigh`` at N."""
    from faer_tpu_torch import (
        self_adjoint_eigenvalues, self_adjoint_evd, singular_values, svd)
    from faer_tpu_torch.linalg import bidiag_dnc, tridiag_dnc
    from faer_tpu_torch.linalg.bidiag import (
        bidiag_apply_ql, bidiag_apply_qr_mat, bidiag_in_place)
    from faer_tpu_torch.linalg.bidiag_svd import bidiag_svd
    from faer_tpu_torch.linalg.tridiag import tridiag_apply_q, tridiag_in_place
    from faer_tpu_torch.linalg.tridiag_evd import tridiag_evd
    from faer_tpu_torch.utils import flops

    total = {}
    t0 = time.perf_counter()

    def mark(what: str) -> None:
        print(f"phase 7: {what} done, {time.perf_counter() - t0:.1f} s in", flush=True)

    def add(counts):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v

    def first_call(fn):
        """fn once under ``_counted``, and that first call's time (host
        clock, ending in a synchronize): the time ``_timed`` reports for a
        call past SPECTRAL_SLOW_S, so the slow calls run once."""
        t = time.perf_counter()
        out = _counted(fn)
        return (*out, (time.perf_counter() - t) * 1e3)

    def report(label, ms, flops_):
        rate = f", {flops_ / ms / 1e6:.1f} GFLOP/s" if ms > SPECTRAL_SLOW_S * 1e3 else ""
        how = "one call, host clock" if ms > SPECTRAL_SLOW_S * 1e3 else "first call, host clock"
        print(f"time {label}: {ms:.4f} ms ({how}, the checked call){rate}")

    n = N
    g = torch.randn(n, n, generator=gen, device=DEV)
    a = (g + g.T) / 2
    (w, v, info), counts, reads, evd_ms = first_call(lambda: self_adjoint_evd(a))
    add(counts)
    _one_launch(f"self_adjoint_evd n={n}", "tridiag_sweep", counts, reads)
    print(f"info converged {bool(info.converged)}, iterations {int(info.iterations)}")
    check(bool(info.converged), f"self_adjoint_evd n={n} converged")
    _evd_checks(a, w, v, f"self_adjoint_evd n={n}")
    (u, s, vs, sinfo), counts, reads, svd_ms = first_call(lambda: svd(g))
    add(counts)
    _one_launch(f"svd n={n}", "bidiag_sweep", counts, reads)
    check(bool(sinfo.converged), f"svd n={n} converged")
    _svd_checks(g, u, s, vs, f"svd n={n}")

    mark("the 4096 calls and their checks")
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

    mark("the f64 oracle at 1024")
    # the direct QR-iteration route (n < 512): the kernels sweep the full n
    n2 = DIRECT_N
    g2 = torch.randn(n2, n2, generator=gen, device=DEV)
    a2 = (g2 + g2.T) / 2
    (w2, v2, info2), counts, reads = _counted(lambda: self_adjoint_evd(a2))
    add(counts)
    _one_launch(f"self_adjoint_evd n={n2}", "tridiag_sweep", counts, reads)
    check(bool(info2.converged), f"self_adjoint_evd n={n2} converged")
    _evd_checks(a2, w2, v2, f"self_adjoint_evd n={n2}")
    (u2, s2, vs2, sinfo2), counts, reads = _counted(lambda: svd(g2))
    add(counts)
    _one_launch(f"svd n={n2}", "bidiag_sweep", counts, reads)
    check(bool(sinfo2.converged), f"svd n={n2} converged")
    _svd_checks(g2, u2, s2, vs2, f"svd n={n2}")

    mark("the direct route at 384")
    # the tall SVD takes the QR preprocessing (m/n = 4 > 11/6)
    mt, nt_ = TALL
    gt = torch.randn(mt, nt_, generator=gen, device=DEV)
    (ut, st, vt, _), counts, reads, tall_ms = first_call(lambda: svd(gt))
    add(counts)
    _one_launch(f"svd {mt}x{nt_}", "bidiag_sweep", counts, reads)
    check(counts["qr_panel"] > 0, f"svd {mt}x{nt_} ran qr_panel {counts['qr_panel']} times")
    _svd_checks(gt, ut, st, vt, f"svd {mt}x{nt_}")
    add(_wide_dnc_check())

    mark("the tall SVD and the wide D&C")
    # times: the entry points (the 4096 and tall calls: their checked first
    # calls, to save a second run of each), their yardsticks, then the
    # layers at 4096
    report(f"self_adjoint_evd n={n}", evd_ms, flops.evd_flops(n))
    eigh_ms = _timed(lambda: torch.linalg.eigh(a), f"library eigh n={n}")
    report(f"svd n={n}", svd_ms, flops.svd_flops(n, n))
    _timed(lambda: torch.linalg.svd(g, full_matrices=False), f"library svd n={n}")
    for label, fn in ((f"self_adjoint_evd n={n2}", lambda: self_adjoint_evd(a2)),
                      (f"svd n={n2}", lambda: svd(g2))):
        wall = _timed(fn, label)
        busy = device_ms(fn)
        print(f"device busy in {label}: {busy:.4f} ms of {wall:.4f} ms "
              f"({busy / wall:.3f}; torch.profiler kernel spans)")
    _timed(lambda: torch.linalg.eigh(a2), f"library eigh n={n2}")
    _timed(lambda: torch.linalg.svd(g2, full_matrices=False), f"library svd n={n2}")
    report(f"svd {mt}x{nt_}", tall_ms, flops.svd_flops(mt, nt_))
    _timed(lambda: torch.linalg.svd(gt, full_matrices=False), f"library svd {mt}x{nt_}")
    mark("the timed calls")
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
    mark("the layers")
    # the D&C layers on the device: the leaf stage (one launch, in a CUDA
    # graph) at N, and at ORACLE_N beside the merges (the layer's kernel
    # spans less the leaves'): torch.profiler takes minutes to collect a
    # 4096 layer's spans, which tools/torch_split.py spectral measures
    d1, e1, _, _ = tridiag_in_place(a1)
    bd1 = bidiag_in_place(g1)
    for size, (dd, ee), (bd0, bd1_) in ((n, (d, e), bd[:2]), (n1, (d1, e1), bd1[:2])):
        nrm = torch.maximum(bd0.abs().max(), bd1_.abs().max())
        stages = {"tridiag_evd": (lambda: tridiag_dnc._leaf_stage(dd, ee),
                                  lambda: tridiag_evd(dd, ee)),
                  "bidiag_svd": (lambda: bidiag_dnc._leaf_stage(bd0 / nrm, bd1_ / nrm, 0),
                                 lambda: bidiag_svd(bd0, bd1_))}
        for k, (leaf_fn, layer_fn) in stages.items():
            leaf = graph_ms(leaf_fn, 3)
            text = f"time {k} (D&C) n={size} on the device: leaf stage {leaf:.4f} ms (graph replay)"
            if size == n1:
                busy = device_ms(layer_fn)
                text += (f", merges {busy - leaf:.4f} ms (the layer's kernel spans "
                         f"{busy:.4f} ms less the leaf stage)")
            print(text)
    mark("the leaf stages and merges")
    print(f"launches in the spectral phase: {total}")
    return total, {"tridiag_in_place": layers["tridiag_in_place"], "eigh": eigh_ms}


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
    # a 1-D right-hand side gives a 1-D solution, the 2-D solve's column
    b1 = torch.randn(ns, generator=gen, device=DEV)
    x1, x2 = eig.solve(b1), eig.solve(b1[:, None])
    r = _res(sym, x1[:, None], b1[:, None])
    gap = ((x1 - x2[:, 0]).abs().max() / x2.abs().max()).item()
    check(tuple(x1.shape) == (ns,) and r <= 8 * ns * EPS32 and gap <= 8 * ns * EPS32,
          f"self_adjoint_eigen().solve(b), b of shape ({ns},): x of shape "
          f"{tuple(x1.shape)}, |Ax-b|/(|A||x|) {r:.3e}, against the (n, 1) solve "
          f"{gap:.3e}; <= {8 * ns * EPS32:.3e}")
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


def _dense_inputs(n: int, gen) -> dict:
    """Phase 13's float64 inputs, made on the card."""
    g = torch.randn(n, n, generator=gen, device=DEV, dtype=torch.float64)
    h = torch.randn(n, DENSE_RANK, generator=gen, device=DEV, dtype=torch.float64)
    eye = torch.eye(n, device=DEV, dtype=torch.float64)
    return dict(spd=g @ g.T / n + eye, psd=h @ h.T / n,
                sym=(g + g.T) / 2, g=g,
                b=torch.randn(n, 8, generator=gen, device=DEV, dtype=torch.float64),
                w=torch.randn(n, DENSE_R, generator=gen, device=DEV,
                              dtype=torch.float64))


def _full_piv_check(r):
    """Full pivoting bounds L: every multiplier is at most 1 in size."""
    f = r["full_piv_lu()"]
    big = torch.tril(f.lu, -1).abs().max().item()
    return (bool(torch.isfinite(f.lu).all()) and big <= 1.0,
            f"finite, max|L| = {big:.6f} <= 1, rank() {int(f.rank().item())}")


def _col_piv_check(r):
    """Each real reflector has τ = 0 (identity) or τ in [1, 2]."""
    f = r["col_piv_qr()"]
    t = f.taus
    ok = bool(((t == 0) | ((t >= 1) & (t <= 2))).all())
    return (bool(torch.isfinite(f.packed).all()) and ok,
            f"finite, every tau 0 or in [1, 2], rank() {int(f.rank().item())}")


def _dense_calls(x: dict, dt) -> list:
    """Phase 13's calls in order: (key, call, check, library yardstick).
    A call takes the results so far (by key) and returns its own; a check
    takes the results and returns (value, limit, text) or a bool and text."""
    from faer_tpu_torch import Mat

    n = x["g"].shape[0]
    tol = 8 * n * float(torch.finfo(dt).eps)
    a = {k: v.to(dt) for k, v in x.items()}
    spd, psd, sym, g, b, w = (a[k] for k in ("spd", "psd", "sym", "g", "b", "w"))
    upd = spd + w @ w.T
    sign_g = torch.linalg.slogdet(x["g"])[0].item()

    def rec(key, mat):
        return lambda r: (rel_norm(r[key], mat), tol, "reconstruction |rec - A|/|A|")

    def res(key, mat):
        return lambda r: (_res(mat, r[key], b), tol, "residual |Ax-b|/(|A||x|)")

    def det_sign(key, want):
        def chk(r):
            d = r[key].item()
            return (d > 0) == (want > 0) and d != 0, f"determinant {d:.4g}, sign of {want:+.0f}"
        return chk

    lib_chol = ("cholesky_ex", lambda: torch.linalg.cholesky_ex(spd))
    calls = [
        ("ldlt()", lambda r: Mat(spd).ldlt(),
         lambda r: (bool(r["ldlt()"].info.success), "success"),
         ("ldl_factor", lambda: torch.linalg.ldl_factor(spd))),
        ("ldlt().reconstruct()", lambda r: r["ldlt()"].reconstruct(),
         rec("ldlt().reconstruct()", spd), None),
        ("ldlt().solve", lambda r: r["ldlt()"].solve(b), res("ldlt().solve", spd), None),
        ("ldlt().determinant()", lambda r: r["ldlt()"].determinant(),
         det_sign("ldlt().determinant()", 1.0), None),
        ("ldlt().rank_update(+1)", lambda r: r["ldlt()"].rank_update(w, 1.0),
         lambda r: (rel_norm(r["ldlt().rank_update(+1)"].reconstruct(), upd), tol,
                    "|rec - (A + WWᵀ)|/|A + WWᵀ|"),
         ("ldl_factor of A + WWᵀ", lambda: torch.linalg.ldl_factor(upd))),
        ("ldlt().rank_update(-1)", lambda r: r["ldlt().rank_update(+1)"].rank_update(w, -1.0),
         lambda r: (rel_norm(r["ldlt().rank_update(-1)"].reconstruct(), spd), tol,
                    "downdate back to A: |rec - A|/|A|"), None),
        ("llt()", lambda r: Mat(spd).llt(),
         lambda r: (rel_norm(r["llt()"].reconstruct(), spd), tol, "|LLᵀ - A|/|A|"), lib_chol),
        ("llt().rank_update(+1)", lambda r: r["llt()"].rank_update(w, 1.0),
         lambda r: (rel_norm(r["llt().rank_update(+1)"].reconstruct(), upd), tol,
                    "|rec - (A + WWᵀ)|/|A + WWᵀ|"),
         ("cholesky_ex of A + WWᵀ", lambda: torch.linalg.cholesky_ex(upd))),
        ("llt().rank_update(-1)", lambda r: r["llt().rank_update(+1)"].rank_update(w, -1.0),
         lambda r: (rel_norm(r["llt().rank_update(-1)"].reconstruct(), spd), tol,
                    "downdate back to A: |rec - A|/|A|"), None),
        ("piv_llt() rank 3072", lambda r: Mat(psd).piv_llt(),
         lambda r: (int(r["piv_llt() rank 3072"].rank.item()) == DENSE_RANK,
                    f"rank {int(r['piv_llt() rank 3072'].rank.item())} == {DENSE_RANK}"),
         ("cholesky_ex (fails: PSD)", lambda: torch.linalg.cholesky_ex(psd))),
        ("piv_llt() rank 3072 .reconstruct()",
         lambda r: r["piv_llt() rank 3072"].reconstruct(),
         rec("piv_llt() rank 3072 .reconstruct()", psd), None),
        ("piv_llt()", lambda r: Mat(spd).piv_llt(),
         lambda r: (int(r["piv_llt()"].rank.item()) == n, "full rank"), lib_chol),
        ("piv_llt().solve", lambda r: r["piv_llt()"].solve(b), res("piv_llt().solve", spd), None),
        ("lblt()", lambda r: Mat(sym).lblt(),
         lambda r: (int((r["lblt()"].subdiag != 0).sum().item()) > 0,
                    f"{int((r['lblt()'].subdiag != 0).sum().item())} 2x2 pivots"),
         ("ldl_factor", lambda: torch.linalg.ldl_factor(sym))),
        ("lblt().reconstruct()", lambda r: r["lblt()"].reconstruct(),
         rec("lblt().reconstruct()", sym), None),
        ("lblt().solve", lambda r: r["lblt()"].solve(b), res("lblt().solve", sym), None),
        ("full_piv_lu()", lambda r: Mat(g).full_piv_lu(), _full_piv_check,
         ("lu_factor_ex", lambda: torch.linalg.lu_factor_ex(g))),
        ("full_piv_lu().reconstruct()", lambda r: r["full_piv_lu()"].reconstruct(),
         rec("full_piv_lu().reconstruct()", g), None),
        ("full_piv_lu().solve", lambda r: r["full_piv_lu()"].solve(b),
         res("full_piv_lu().solve", g), None),
        ("full_piv_lu().determinant()", lambda r: r["full_piv_lu()"].determinant(),
         det_sign("full_piv_lu().determinant()", sign_g), None),
        ("col_piv_qr()", lambda r: Mat(g).col_piv_qr(), _col_piv_check,
         ("geqrf", lambda: torch.geqrf(g))),
        ("col_piv_qr().reconstruct()", lambda r: r["col_piv_qr()"].reconstruct(),
         rec("col_piv_qr().reconstruct()", g), None),
        ("col_piv_qr().solve_lstsq", lambda r: r["col_piv_qr()"].solve_lstsq(b),
         res("col_piv_qr().solve_lstsq", g), None),
    ]
    if dt == torch.float64:
        calls += [
            ("llt().solve", lambda r: r["llt()"].solve(b), res("llt().solve", spd), None),
            ("partial_piv_lu()", lambda r: Mat(g).partial_piv_lu(),
             lambda r: (rel_norm(r["partial_piv_lu()"].reconstruct(), g), tol,
                        "|A[perm] - LU|/|A|"),
             ("lu_factor_ex", lambda: torch.linalg.lu_factor_ex(g))),
            ("partial_piv_lu().solve", lambda r: r["partial_piv_lu()"].solve(b),
             res("partial_piv_lu().solve", g), None),
            ("partial_piv_lu().determinant()",
             lambda r: r["partial_piv_lu()"].determinant(),
             det_sign("partial_piv_lu().determinant()", sign_g), None),
            ("qr()", lambda r: Mat(g).qr(),
             lambda r: (rel_norm(r["qr()"].reconstruct(), g), tol, "|QR - A|/|A|"),
             ("geqrf", lambda: torch.geqrf(g))),
            ("qr().solve_lstsq", lambda r: r["qr()"].solve_lstsq(b),
             res("qr().solve_lstsq", g), None),
        ]
    return calls


def phase_dense_stack(gen) -> dict:
    """The rest of the dense stack and the float64 factorizations through
    ``Mat`` and the solver objects at n = N: each call counted on its own
    (every counter set to 0 just before it and read just after), checked,
    and timed once by CUDA events; the counts summed."""
    from faer_tpu_torch.core.config import (
        KERNELS, host_reads, launch_counts, reset_launch_counts)

    total = dict.fromkeys(KERNELS, 0)
    x = _dense_inputs(N, gen)
    w_n = DENSE_WARM_N
    warm = {k: v[:w_n, :w_n] if v.shape[1] == N else v[:w_n] for k, v in x.items()}
    for dt in (torch.float32, torch.float64):
        r = {}
        for key, fn, _, _ in _dense_calls(warm, dt):
            r[key] = fn(r)
    torch.cuda.synchronize()
    for dt in (torch.float32, torch.float64):
        name = "f32" if dt == torch.float32 else "f64"
        r = {}
        for key, fn, chk, lib in _dense_calls(x, dt):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            reset_launch_counts()
            start.record()
            r[key] = fn(r)
            stop.record()
            torch.cuda.synchronize()
            counts, reads = launch_counts(), host_reads()
            ms = start.elapsed_time(stop)
            for k, v in counts.items():
                total[k] += v
            want = dict.fromkeys(KERNELS, 0)
            if dt == torch.float32:
                want.update(DENSE_LAUNCHES.get(key, {}))
            got = {k: v for k, v in counts.items() if v}
            check(counts == want, f"{key} {name}: launches {got or 'none'}, host reads "
                                  f"{reads}; predicted "
                                  f"{ {k: v for k, v in want.items() if v} or 'none'}")
            out = chk(r)
            if len(out) == 3:
                val, lim, text = out
                check(val <= lim, f"{key} {name} n={N}: {text} {val:.3e} <= {lim:.3e}")
            else:
                check(out[0], f"{key} {name} n={N}: {out[1]}")
            line = f"time {key} {name} n={N}: {ms:.4f} ms per call"
            if lib is not None:
                line += f"; library {lib[0]} {cuda_ms(lib[1], 1):.4f} ms"
            print(line, flush=True)
        del r
    return total


def _eig_ratio(w, ref, kappa, eta: float) -> float:
    """How far the eigenvalues ``w`` lie from the reference ``ref`` (both
    complex, on the card), against each reference eigenvalue's own bound
    2·κ_i·η: the first-order perturbation bound κ_i·η (κ_i = ‖x_i‖‖y_i‖/
    |y_iᴴx_i|, its condition number; η the Schur step's measured backward
    error, :func:`_schur_backward`), doubled for the reference's own error
    of the same kind. The largest ratio, each eigenvalue matched to the
    nearest of the other set in both directions. A sorted comparison can
    pair the wrong eigenvalues where two real parts lie closer than their
    errors, and a bound without κ fails on the near-collisions of a random
    matrix's spectrum, which move by √eps."""
    # the distances themselves (torch.cdist's product form cancels near 0)
    dist = (w.to(torch.complex128)[:, None] - ref.to(torch.complex128)[None, :]).abs()
    tol = 2 * kappa * eta
    near_ref = dist.min(dim=1)  # each computed eigenvalue's nearest reference
    near_w = dist.min(dim=0)  # each reference eigenvalue's nearest computed one
    return max((near_ref.values / tol[near_ref.indices]).max().item(),
               (near_w.values / tol).max().item())


def _schur_backward(a, t, q) -> tuple[float, float, float]:
    """The Schur step's A = Q T Qᴴ in float64 (complex128 for complex
    input): ‖A − QTQᴴ‖_F/‖A‖_F, max|QᴴQ − I| and the backward error η =
    ‖A − QTQᴴ‖₂ + ‖A‖₂‖QᴴQ − I‖₂ of T's eigenvalues (T's eigenvalues are
    those of Q T Q⁻¹ = A − E − Q T F Qᴴ + O(‖F‖²), E = A − QTQᴴ, F = QᴴQ −
    I)."""
    wide = torch.complex128 if a.is_complex() else torch.float64
    ad, td, qd = a.to(wide), t.to(wide), q.to(wide)
    e = ad - qd @ td @ qd.mH
    f = qd.mH @ qd - torch.eye(a.shape[0], device=a.device, dtype=wide)
    e2, a2, f2 = (torch.linalg.matrix_norm(x, ord=2).item() for x in (e, ad, f))
    return (torch.linalg.matrix_norm(e).item() / torch.linalg.matrix_norm(ad).item(),
            f.abs().max().item(), e2 + a2 * f2)


def phase_general_evd(gen) -> dict:
    """The general real EVD and the f64 spectral entry points.

    * ``evd`` and ``eigenvalues`` in float32 at GEVD_N and in float64 at
      GEVD_F64_N (the leading block of the same matrix), each
      call's Schur step (``hessenberg_blocked`` then
      ``_real_schur_dispatch``: multishift QR, every AED window one
      ``real_schur`` launch) with ‖A − QTQᵀ‖/‖A‖ and max|QᵀQ − I| within
      8·n·eps of its dtype, the eigenvalues against f64
      ``numpy.linalg.eigvals`` within 2·κ_i·η (:func:`_eig_ratio`, η the
      step's measured backward error), ``evd``'s ‖AV − VΛ‖/(‖A‖‖V‖)
      within 8·n·eps; each call's time (host clock, one call) and layers,
      beside ``torch.linalg.eig`` and ``eigvals`` in the same dtype;
    * ``Mat(a).eigen()`` and ``Mat(a).eigenvalues()`` at the route edge
      (127: one direct ``real_schur`` launch; 128: multishift);
    * ``self_adjoint_evd`` and ``svd`` in float64 at F64_SPECTRAL (D&C,
      and the direct QR route), each exactly one sweep launch and no host
      read, against ``eigh``/``svd`` in float64.

    Every ``real_schur`` launch is one AED window or one direct call:
    ``_aed`` and the direct ``real_schur`` are counted by wrappers. Returns
    the summed launch counts."""
    import numpy as np

    from faer_tpu_torch import Mat, eigenvalues, evd, self_adjoint_evd, svd
    from faer_tpu_torch.core import dtypes
    from faer_tpu_torch.linalg import eigvec, real_schur as trs, schur_multishift as tms
    from faer_tpu_torch.linalg import evd as tevd

    total = {}
    calls = {"aed": 0, "direct": 0, "aed_ms": 0.0, "sweep": 0, "sweep_ms": 0.0,
             "hess": 0, "hess_ms": 0.0, "schur": 0, "schur_ms": 0.0, "vecs": 0,
             "vecs_ms": 0.0}
    schur_out = []  # the Schur step's (t, q, info) of the last call

    def wrap(mod, name, key):
        fn = getattr(mod, name)

        def counted(*args, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            calls[key] += 1
            if key + "_ms" in calls:
                calls[key + "_ms"] += (time.perf_counter() - t) * 1e3
            if key == "schur":
                schur_out[:] = [out]
            return out
        setattr(mod, name, counted)
        return fn

    saved = [(tms, "_aed", wrap(tms, "_aed", "aed")),
             (trs, "real_schur", wrap(trs, "real_schur", "direct")),
             (tms, "_sweep", wrap(tms, "_sweep", "sweep")),
             (tevd, "hessenberg_blocked", wrap(tevd, "hessenberg_blocked", "hess")),
             (tevd, "_real_schur_dispatch", wrap(tevd, "_real_schur_dispatch", "schur")),
             (eigvec, "quasi_triangular_eigenvectors_pair",
              wrap(eigvec, "quasi_triangular_eigenvectors_pair", "vecs"))]

    def run(label, fn, dt):
        """fn once with every counter at 0 (the wrappers' too), timed by
        the host clock: (result, ms, counts, host reads)."""
        for k in calls:
            calls[k] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, counts, reads = _counted(fn)
        ms = (time.perf_counter() - t0) * 1e3
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        launches = counts["real_schur"]
        check(launches == calls["aed"] + calls["direct"] and launches > 0
              and counts["tridiag_sweep"] == counts["bidiag_sweep"] == 0,
              f"{label}: {launches} real_schur launches = {calls['aed']} AED windows + "
              f"{calls['direct']} direct calls; {calls['sweep']} multishift sweeps; "
              f"{reads} host reads")
        print(f"time {label}: {ms:.4f} ms (one call, host clock); layers: "
              f"hessenberg_blocked {calls['hess_ms']:.1f} ms, the Schur step "
              f"{calls['schur_ms']:.1f} ms (AED {calls['aed_ms']:.1f} ms in {calls['aed']} "
              f"windows, sweeps {calls['sweep_ms']:.1f} ms in {calls['sweep']}), "
              f"eigenvectors {calls['vecs_ms']:.1f} ms")
        return out, ms

    try:
        import scipy.linalg

        a_all = torch.randn(GEVD_N, GEVD_N, generator=gen, device=DEV, dtype=torch.float64)
        for dt, n in ((torch.float32, GEVD_N), (torch.float64, GEVD_F64_N)):
            a64 = a_all[:n, :n].contiguous()
            # the reference: f64 LAPACK eigenvalues (numpy.linalg.eigvals) and
            # their condition numbers from scipy's left and right vectors
            an = a64.cpu().numpy()
            ref = torch.from_numpy(np.linalg.eigvals(an)).to(DEV)
            lw, yl, xr = scipy.linalg.eig(an, left=True, right=True)
            kappa_np = (np.linalg.norm(yl, axis=0) * np.linalg.norm(xr, axis=0)
                        / np.abs(np.sum(yl.conj() * xr, axis=0)))
            # scipy's order to numpy's: each of numpy's eigenvalues takes the
            # condition number of scipy's nearest one
            kappa = torch.from_numpy(kappa_np[np.abs(np.asarray(ref.cpu())[:, None]
                                                     - lw[None, :]).argmin(axis=1)]).to(DEV)
            anorm2 = torch.linalg.matrix_norm(a64, ord=2).item()
            print(f"reference n={n}: f64 numpy.linalg.eigvals, condition numbers from "
                  f"scipy.linalg.eig: median {kappa.median().item():.3g}, largest "
                  f"{kappa.max().item():.3g}; |A|₂ {anorm2:.6g}")
            name = "f32" if dt == torch.float32 else "f64"
            eps = torch.finfo(dt).eps
            tol = 8 * n * eps
            a = a64.to(dt)
            for label, fn in ((f"evd n={n} {name}", lambda: evd(a)),
                              (f"eigenvalues n={n} {name}", lambda: eigenvalues(a))):
                out, _ = run(label, fn, dt)
                # the Schur step of that call (A = Q T Qᵀ, Q from the
                # Hessenberg reduction and the multishift iteration)
                t, qs, sinfo = schur_out[0]
                rec, orth, eta = _schur_backward(a, t, qs)
                check(bool(sinfo.converged) and rec <= tol and orth <= tol
                      and not bool(torch.tril(t, -2).any()),
                      f"{label}, the Schur step: converged in {int(sinfo.iterations)} rounds, "
                      f"quasi-triangular; |A - QTQᵀ|/|A| {rec:.3e}, max|QᵀQ - I| {orth:.3e}, "
                      f"both <= {tol:.3e}; backward error η = |A - QTQᵀ|₂ + |A|₂|QᵀQ - I|₂ "
                      f"{eta:.3e} (|A|₂ {anorm2:.6g})")
                w = out[0] if label.startswith("evd") else out
                ratio = _eig_ratio(w, ref, kappa, eta)
                check(w.dtype == dtypes.complex_dtype_of(dt) and ratio <= 1,
                      f"{label}: eigenvalues vs f64 numpy.linalg.eigvals within {ratio:.3e} "
                      f"of their bounds 2·κ_i·η")
                if label.startswith("evd"):
                    _, v, info = out
                    vd = v.to(torch.complex128)
                    res = (torch.linalg.matrix_norm(a64.to(torch.complex128) @ vd
                                                    - vd * w[None, :])
                           / (torch.linalg.matrix_norm(a64) * torch.linalg.matrix_norm(vd))
                           ).item()
                    check(bool(info.converged) and res <= tol,
                          f"{label}: |AV - VΛ|/(|A||V|) {res:.3e} <= {tol:.3e}")
            lib = cuda_ms(lambda: torch.linalg.eig(a), 1)
            libv = cuda_ms(lambda: torch.linalg.eigvals(a), 1)
            print(f"time library n={n} {name}: torch.linalg.eig {lib:.4f} ms, eigvals "
                  f"{libv:.4f} ms (one call each, CUDA events)")
        # the multishift route edge through the facade: 127 takes one direct
        # real_schur launch
        for n2 in GEVD_EDGE:
            a2 = torch.randn(n2, n2, generator=gen, device=DEV)
            eig, _ = run(f"Mat(a).eigen() n={n2} f32", lambda: Mat(a2).eigen(),
                         torch.float32)
            w2, v2, info2 = eig.eigenvalues, eig.eigenvectors, eig.info
            n_direct, n_aed = calls["direct"], calls["aed"]
            wv2 = Mat(a2).eigenvalues()
            check(torch.equal(wv2, w2), f"Mat(a).eigenvalues() n={n2} f32: the "
                                        f"eigenvalues of Mat(a).eigen(), to the bit")
            tol2 = 8 * n2 * EPS32
            vd = v2.to(torch.complex128)
            res = (torch.linalg.matrix_norm(a2.double().to(torch.complex128) @ vd
                                            - vd * w2[None, :])
                   / (torch.linalg.matrix_norm(a2.double()) * torch.linalg.matrix_norm(vd))
                   ).item()
            direct = n2 < tevd._MULTISHIFT_MIN_N
            check(bool(info2.converged) and res <= tol2 and n_direct == int(direct)
                  and (n_aed == 0) == direct,
                  f"Mat(a).eigen() n={n2} f32 ({'direct real_schur' if direct else 'multishift'}): "
                  f"|AV - VΛ|/(|A||V|) {res:.3e} <= {tol2:.3e}")
    finally:
        for mod, fname, fn in saved:
            setattr(mod, fname, fn)

    # the f64 spectral entry points: one sweep launch, no host read
    for n3 in F64_SPECTRAL:
        g = torch.randn(n3, n3, generator=gen, device=DEV, dtype=torch.float64)
        a3 = (g + g.T) / 2
        tol3 = 8 * n3 * torch.finfo(torch.float64).eps
        for label, fn, kernel in ((f"self_adjoint_evd n={n3} f64", lambda: self_adjoint_evd(a3),
                                   "tridiag_sweep"),
                                  (f"svd n={n3} f64", lambda: svd(g), "bidiag_sweep")):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out, counts, reads = _counted(fn)
            ms = (time.perf_counter() - t0) * 1e3
            for k, v in counts.items():
                total[k] = total.get(k, 0) + v
            _one_launch(label, kernel, counts, reads)
            if kernel == "tridiag_sweep":
                w3, v3, info3 = out
                _evd_checks(a3, w3, v3, label)
                ref3 = torch.linalg.eigvalsh(a3)
                err = ((w3 - ref3).abs().max() / ref3.abs().max()).item()
                lib = cuda_ms(lambda: torch.linalg.eigh(a3), 1)
                libname = "eigh"
            else:
                u3, s3, vs3, info3 = out
                _svd_checks(g, u3, s3, vs3, label)
                ref3 = torch.linalg.svdvals(g)
                err = ((s3 - ref3).abs().max() / ref3[0]).item()
                lib = cuda_ms(lambda: torch.linalg.svd(g, full_matrices=False), 1)
                libname = "svd"
            check(bool(info3.converged) and err <= tol3,
                  f"{label}: converged, values vs torch.linalg f64 {err:.3e} <= {tol3:.3e}")
            print(f"time {label}: {ms:.4f} ms (one call, host clock); library {libname} "
                  f"{lib:.4f} ms")
    print(f"launches in the general EVD phase: {total}")
    return total


# phase 17: the complex general EVD at full width (ns = 64, AED window 96
# by _params_for) in complex64 and complex128, the multishift route edge in
# complex64, the facade at CEVD_FACADE_N and a batch of small problems
CEVD_N = 1024
CEVD_FACADE_N = 256
CEVD_BATCH = (8, 64)  # batched.eigenvalues: B problems of n²


def _scipy_eig_reference(a, conn) -> None:
    """A host process: the f64 LAPACK eigenvalues of the complex128 ``a``
    (``scipy.linalg.eig``), each one's condition number κ_i =
    ‖x_i‖‖y_i‖/|y_iᴴx_i| from the left and right vectors, and the call's
    time in ms, sent through ``conn``."""
    import numpy as np
    import scipy.linalg

    t0 = time.perf_counter()
    w, yl, xr = scipy.linalg.eig(a, left=True, right=True)
    ms = (time.perf_counter() - t0) * 1e3
    kappa = (np.linalg.norm(yl, axis=0) * np.linalg.norm(xr, axis=0)
             / np.abs(np.sum(yl.conj() * xr, axis=0)))
    conn.send((w, kappa, ms))
    conn.close()


def start_complex_reference() -> tuple:
    """Phase 17's complex Gaussian A at CEVD_N in complex128, on the card,
    from a generator of its own (seed SEED + 17), and the f64 reference of
    its eigenvalues (:func:`_scipy_eig_reference`) started in a spawned
    daemon process with one BLAS thread, to run beside phase 17's first
    calls: (A, process, receiving end of its pipe)."""
    import multiprocessing

    g = torch.Generator(device=DEV).manual_seed(SEED + 17)
    a = torch.complex(*(torch.randn(CEVD_N, CEVD_N, generator=g, device=DEV,
                                    dtype=torch.float64) for _ in range(2)))
    ctx = multiprocessing.get_context("spawn")
    recv, send = ctx.Pipe(duplex=False)
    names = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")
    saved = {k: os.environ.get(k) for k in names}
    os.environ.update(dict.fromkeys(names, "1"))  # read by the child at its start
    try:
        proc = ctx.Process(target=_scipy_eig_reference, daemon=True,
                           args=(a.cpu().numpy(), send))
        proc.start()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    send.close()
    return a, proc, recv


def _kappa_of(a) -> torch.Tensor:
    """The eigenvalues of the complex128 ``a`` on the card
    (``torch.linalg.eig``) and their condition numbers ‖x_i‖‖y_i‖/|y_iᴴx_i|
    with the left vectors the rows of V⁻¹ (y_iᴴx_i = 1)."""
    w, v = torch.linalg.eig(a)
    return w, torch.linalg.vector_norm(v, dim=0) * torch.linalg.vector_norm(
        torch.linalg.inv(v), dim=1)


def phase_complex_evd(gen, cref) -> dict:
    """The complex general EVD (ROADMAP item 10b-i).

    * at CEVD_N, ``evd`` in complex64 and complex128
      (A from :func:`start_complex_reference`), each call's Schur step
      (``hessenberg_blocked`` then ``_complex_schur_dispatch``: multishift
      QR, every AED window one ``complex_schur`` launch) with ‖A −
      QTQᴴ‖/‖A‖ and max|QᴴQ − I| within 8·n·eps of its dtype and T upper
      triangular, the eigenvalues against f64 ``scipy.linalg.eig`` within
      2·κ_i·η (:func:`_eig_ratio`, η the step's measured backward error),
      ``evd``'s ‖AV − VΛ‖/(‖A‖‖V‖) within 8·n·eps; ``complex_schur``
      launches equal to the AED rounds, and the host reads two a round
      that reaches its AED (one for the round that ends the iteration);
      each call's time (host clock, one call) and layers, beside
      ``torch.linalg.eig`` and ``eigvals`` in the same dtype;
    * ``Mat(a).eigen()`` at the route edge in complex64 (127: one direct
      ``complex_schur`` launch and no host read; 128: multishift), and at
      CEVD_FACADE_N, each residual within 8·n·eps;
    * ``batched.eigenvalues`` on CEVD_BATCH complex64 problems: one direct
      launch each, the eigenvalues within 2·κ_i·η of ``torch.linalg.eig``
      of each problem in complex128, η = 8·n·eps_c64·‖A‖₂ (the backward
      error the Schur step is held to).

    Returns the summed launch counts."""
    from faer_tpu_torch import Mat, evd
    from faer_tpu_torch.linalg import batched, eigvec
    from faer_tpu_torch.linalg import complex_schur as tcs
    from faer_tpu_torch.linalg import evd as tevd
    from faer_tpu_torch.linalg import schur_multishift as tms

    total = {}
    calls = {"aed": 0, "schur_calls": 0, "aed_ms": 0.0, "sweep": 0, "sweep_ms": 0.0,
             "hess": 0, "hess_ms": 0.0, "schur": 0, "schur_ms": 0.0, "vecs": 0,
             "vecs_ms": 0.0}
    schur_out = []  # the Schur step's (t, q, info) of the last call

    def wrap(mod, name, key):
        fn = getattr(mod, name)

        def counted(*args, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            calls[key] += 1
            if key + "_ms" in calls:
                calls[key + "_ms"] += (time.perf_counter() - t) * 1e3
            if key == "schur":
                schur_out[:] = [out]
            return out
        setattr(mod, name, counted)
        return fn

    saved = [(tms, "_aed", wrap(tms, "_aed", "aed")),
             (tcs, "complex_schur", wrap(tcs, "complex_schur", "schur_calls")),
             (tms, "_sweep", wrap(tms, "_sweep", "sweep")),
             (tevd, "hessenberg_blocked", wrap(tevd, "hessenberg_blocked", "hess")),
             (tevd, "_complex_schur_dispatch", wrap(tevd, "_complex_schur_dispatch", "schur")),
             (eigvec, "triangular_eigenvectors",
              wrap(eigvec, "triangular_eigenvectors", "vecs"))]

    def run(label, fn):
        """fn once with every counter at 0 (the wrappers' too), timed by
        the host clock: (result, ms, counts, host reads)."""
        for k in calls:
            calls[k] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, counts, reads = _counted(fn)
        ms = (time.perf_counter() - t0) * 1e3
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        launches = counts["complex_schur"]
        direct = calls["schur_calls"] - calls["aed"]
        others = {k: v for k, v in counts.items() if k != "complex_schur" and v}
        rounds = int(schur_out[0][2].iterations) if calls["aed"] else 0
        check(launches == calls["schur_calls"] > 0 and not others
              and reads == (rounds + calls["aed"] if calls["aed"] else 0),
              f"{label}: {launches} complex_schur launches = {calls['aed']} AED windows + "
              f"{direct} direct calls, no other kernel {others}; {calls['sweep']} "
              f"multishift sweeps; {reads} host reads = {rounds} rounds + {calls['aed']} "
              f"AED rounds")
        print(f"time {label}: {ms:.4f} ms (one call, host clock); layers: "
              f"hessenberg_blocked {calls['hess_ms']:.1f} ms, the Schur step "
              f"{calls['schur_ms']:.1f} ms (AED {calls['aed_ms']:.1f} ms in {calls['aed']} "
              f"windows, sweeps {calls['sweep_ms']:.1f} ms in {calls['sweep']}), "
              f"eigenvectors {calls['vecs_ms']:.1f} ms")
        return out, ms, direct

    def resid(a, w, v) -> float:
        ad, vd = a.to(torch.complex128), v.to(torch.complex128)
        return (torch.linalg.matrix_norm(ad @ vd - vd * w.to(torch.complex128)[None, :])
                / (torch.linalg.matrix_norm(ad) * torch.linalg.matrix_norm(vd))).item()

    a128, proc, recv = cref
    try:
        n = CEVD_N
        for dt in (torch.complex64, torch.complex128):
            name = "c64" if dt == torch.complex64 else "c128"
            tol = 8 * n * torch.finfo(dt).eps
            a = a128.to(dt)
            # evd alone at this width: the eigenvalues calls, no faster than
            # evd's, gave their time to phase 18 (Mat(a).eigenvalues() below
            # still runs the entry point)
            for label, fn in ((f"evd n={n} {name}", lambda: evd(a)),):
                out, _, _ = run(label, fn)
                t, qs, sinfo = schur_out[0]
                rec, orth, eta = _schur_backward(a, t, qs)
                lower = torch.tril(t, -1).abs().max().item()
                check(bool(sinfo.converged) and rec <= tol and orth <= tol and lower == 0,
                      f"{label}, the Schur step: converged in {int(sinfo.iterations)} rounds, "
                      f"upper triangular {lower == 0}; |A - QTQᴴ|/|A| {rec:.3e}, "
                      f"max|QᴴQ - I| {orth:.3e}, both <= {tol:.3e}; backward error η = "
                      f"|A - QTQᴴ|₂ + |A|₂|QᴴQ - I|₂ {eta:.3e}")
                w = out[0] if label.startswith("evd") else out
                if recv is not None:  # the reference, once: it ran beside phases 3–16
                    t0 = time.perf_counter()
                    ref, kappa, ref_ms = recv.recv()
                    proc.join()
                    wait = time.perf_counter() - t0
                    ref = torch.from_numpy(ref).to(DEV)
                    kappa = torch.from_numpy(kappa).to(DEV)
                    recv = None
                    print(f"reference n={n}: f64 scipy.linalg.eig with left and right vectors "
                          f"{ref_ms:.1f} ms on one host core (waited {wait:.1f} s); condition "
                          f"numbers median {kappa.median().item():.3g}, largest "
                          f"{kappa.max().item():.3g}")
                ratio = _eig_ratio(w, ref, kappa, eta)
                check(w.dtype == dt and ratio <= 1,
                      f"{label}: eigenvalues vs f64 scipy.linalg.eig within {ratio:.3e} of "
                      f"their bounds 2·κ_i·η")
                if label.startswith("evd"):
                    _, v, info = out
                    res = resid(a, w, v)
                    check(bool(info.converged) and v.dtype == dt and res <= tol,
                          f"{label}: |AV - VΛ|/(|A||V|) {res:.3e} <= {tol:.3e}")
            lib = cuda_ms(lambda: torch.linalg.eig(a), 1)
            libv = cuda_ms(lambda: torch.linalg.eigvals(a), 1)
            print(f"time library n={n} {name}: torch.linalg.eig {lib:.4f} ms, eigvals "
                  f"{libv:.4f} ms (one call each, CUDA events)")
        # the multishift route edge and the facade in complex64
        for n2 in (*GEVD_EDGE, CEVD_FACADE_N):
            a2 = torch.complex(torch.randn(n2, n2, generator=gen, device=DEV),
                               torch.randn(n2, n2, generator=gen, device=DEV))
            eig, _, n_direct = run(f"Mat(a).eigen() n={n2} c64", lambda: Mat(a2).eigen())
            n_aed = calls["aed"]
            wv2 = Mat(a2).eigenvalues()
            check(torch.equal(wv2, eig.eigenvalues), f"Mat(a).eigenvalues() n={n2} c64: the "
                                                     f"eigenvalues of Mat(a).eigen(), to the bit")
            tol2 = 8 * n2 * EPS32
            res = resid(a2, eig.eigenvalues, eig.eigenvectors)
            direct = n2 < tevd._MULTISHIFT_MIN_N
            check(bool(eig.info.converged) and res <= tol2 and n_direct == int(direct)
                  and (n_aed == 0) == direct,
                  f"Mat(a).eigen() n={n2} c64 ({'direct complex_schur' if direct else 'multishift'}): "
                  f"|AV - VΛ|/(|A||V|) {res:.3e} <= {tol2:.3e}")
        nb, n3 = CEVD_BATCH
        ab = torch.complex(torch.randn(nb, n3, n3, generator=gen, device=DEV),
                           torch.randn(nb, n3, n3, generator=gen, device=DEV))
        wb, _, n_direct = run(f"batched.eigenvalues {nb} x {n3}² c64",
                              lambda: batched.eigenvalues(ab))
        worst = 0.0
        for b in range(nb):
            a3 = ab[b].to(torch.complex128)
            ref3, kappa3 = _kappa_of(a3)
            eta3 = 8 * n3 * EPS32 * torch.linalg.matrix_norm(a3, ord=2).item()
            worst = max(worst, _eig_ratio(wb[b], ref3, kappa3, eta3))
        check(n_direct == nb and worst <= 1,
              f"batched.eigenvalues {nb} x {n3}² c64: {n_direct} direct complex_schur calls; "
              f"eigenvalues vs torch.linalg.eig c128 within {worst:.3e} of 2·κ_i·η, η = "
              f"8·n·eps·|A|₂")
    finally:
        for mod, fname, fn in saved:
            setattr(mod, fname, fn)
        if recv is not None:
            proc.kill()
    print(f"launches in the complex general EVD phase: {total}")
    return total


# phase 18: the complex generalized EVD at full width (ns = 64, AED window
# 96); the multishift route edge; the reduction method at 512; the
# self-adjoint-definite pencil at 1024; the facade once
CGEVD_N = 1024
CGEVD_REDUCTION_N = 512
CGEVD_SA_N = 1024
CGEVD_FACADE_N = 256


def start_complex_gevd_reference() -> tuple:
    """Phase 18's complex Gaussian pencil (A, B) at CGEVD_N in complex128,
    on the card, from a generator of its own (seed SEED + 18), and its f64
    reference (:func:`start_gevd_reference`: one host core) started in a
    spawned daemon process to run beside phase 17: (A, B, process,
    receiving end of its pipe)."""
    g = torch.Generator(device=DEV).manual_seed(SEED + 18)
    a, b = (torch.complex(*(torch.randn(CGEVD_N, CGEVD_N, generator=g, device=DEV,
                                        dtype=torch.float64) for _ in range(2)))
            for _ in range(2))
    return (a, b, *start_gevd_reference(a, b))


def phase_complex_gevd(gen, gref) -> dict:
    """The complex generalized EVD (ROADMAP item 10b-ii).

    * at CGEVD_N, ``gevd`` in complex64 and complex128 on the pencil of
      :func:`start_complex_gevd_reference`: the QZ step (captured inside
      the call: the QR of B, one ``complex_hess_tri`` launch, multishift QZ
      with AED, every AED window one ``complex_qz`` and one
      ``complex_hess_tri`` launch) with ‖A − QSZᴴ‖/‖A‖, ‖B − QTZᴴ‖/‖B‖,
      max|QᴴQ − I| and max|ZᴴZ − I| within 8·n·eps of the dtype, S and T
      upper triangular; the pencil residual (:func:`_pencil_residual`)
      within 8·n·eps; every (α, β) against f64 ``scipy.linalg.eig`` of the
      complex128 pencil within 2·κ_i·η (:func:`_chordal_ratio`); the host
      reads two a round that reaches its AED (one for the round that ends
      the iteration); each call's time (host clock, one call) and layers
      (the QR of B, the reduction's chain, the AED rounds, the sweeps, the
      eigenvectors), beside ``torch.linalg.eig(torch.linalg.solve(B, A))``
      in the same dtype;
    * ``qz`` at the route edge in complex64 (127: one ``complex_hess_tri``
      and one direct ``complex_qz`` launch, no host read; 128:
      multishift), each within 8·n·eps;
    * ``gevd(method="reduction")`` at CGEVD_REDUCTION_N in complex64
      (:func:`gevd_reduction_readings`) beside ``eig(solve(B, A))``;
    * ``gevd_self_adjoint`` at CGEVD_SA_N in complex64 (a Hermitian A, a
      Hermitian positive definite B): ‖AV − BVΛ‖ and max|VᴴBV − I|;
    * ``Mat(a).generalized_eigen(b)`` at CGEVD_FACADE_N in complex64 once,
      equal to ``gevd`` to the bit.

    Returns the summed launch counts."""
    from faer_tpu_torch import Mat, gevd, gevd_self_adjoint, qz
    from faer_tpu_torch.linalg import eigvec
    from faer_tpu_torch.linalg import qz as tqz
    from faer_tpu_torch.linalg import qz_multishift as tqm
    from faer_tpu_torch.ops.kernels import complex_qz as kcq

    total = {}
    calls = {"red": 0, "red_ms": 0.0, "aed": 0, "aed_ms": 0.0, "sweep": 0, "sweep_ms": 0.0,
             "qz_calls": 0, "vecs": 0, "vecs_ms": 0.0, "chain": 0, "chain_ms": 0.0,
             "wide_chains": 0, "qz_steps": 0, "step": 0}
    qz_out = []  # the QZ step's (s, t, q, z, info) of the last call

    def add(counts):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v

    def wrap(mod, name, key):
        fn = getattr(mod, name)

        def counted(*args, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            calls[key] += 1
            if key + "_ms" in calls:
                calls[key + "_ms"] += (time.perf_counter() - t) * 1e3
            if key == "chain" and args[0].shape[1] == calls["n"]:
                calls["wide_chains"] += 1
                calls["wide_chain_ms"] = (time.perf_counter() - t) * 1e3
            if key == "qz_calls":
                calls["qz_steps"] += int(out[6].sum())
            if key == "step":
                qz_out[:] = [out]
            return out
        setattr(mod, name, counted)
        return mod, name, fn

    saved = [wrap(tqz, "hessenberg_triangular", "red"), wrap(tqm, "_aed", "aed"),
             wrap(tqm, "_sweep", "sweep"), wrap(kcq, "complex_qz_batched", "qz_calls"),
             wrap(kcq, "complex_hess_tri_batched", "chain"),
             wrap(eigvec, "triangular_generalized_eigenvectors", "vecs"),
             wrap(tqz, "_complex_qz", "step")]

    def run(label, fn, n):
        """fn once with every counter at 0 (the wrappers' too), timed by the
        host clock, its launches and host reads checked: (result, ms)."""
        for k in calls:
            calls[k] = 0
        calls["n"] = n
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, counts, reads = _counted(fn)
        ms = (time.perf_counter() - t0) * 1e3
        add(counts)
        aed = calls["aed"]
        others = {k: v for k, v in counts.items()
                  if k not in ("complex_hess_tri", "complex_qz") and v}
        rounds = int(qz_out[0][4].iterations) if aed else 0
        check(counts["complex_qz"] == calls["qz_calls"] == (aed if aed else 1)
              and counts["complex_hess_tri"] == calls["chain"] == 1 + aed
              and calls["wide_chains"] == 1 and not others
              and reads == (rounds + aed if aed else 0),
              f"{label}: {counts['complex_hess_tri']} complex_hess_tri launches = the "
              f"reduction's 1 + {aed} AED windows; {counts['complex_qz']} complex_qz launches "
              f"= {'the AED windows' if aed else 'one direct call'}; no other kernel {others}; "
              f"{calls['sweep']} multishift sweeps; {reads} host reads = {rounds} rounds + "
              f"{aed} AED rounds")
        chain = calls.get("wide_chain_ms", 0.0)
        print(f"time {label}: {ms:.1f} ms (one call, host clock); layers: the QR of B and "
              f"Q₀ᴴA {calls['red_ms'] - chain:.1f} ms, the reduction's complex_hess_tri "
              f"{chain:.1f} ms ({chain / ((n - 1) * (n - 2) / 2) * 1e3:.3f} us a pair), AED "
              f"{calls['aed_ms']:.1f} ms in {aed} rounds, sweeps {calls['sweep_ms']:.1f} ms in "
              f"{calls['sweep']}, the eigenvectors {calls['vecs_ms']:.1f} ms; complex_qz "
              f"{calls['qz_steps']} chase steps")
        return out, ms

    def qz_checks(label, a, b, s, t, q, z, info, dt):
        n = a.shape[0]
        tol = 8 * n * torch.finfo(dt).eps
        ad, bd = a.to(torch.complex128), b.to(torch.complex128)
        sd, td, qd, zd = (x.to(torch.complex128) for x in (s, t, q, z))
        eye = torch.eye(n, device=DEV, dtype=torch.complex128)
        ea, eb = ad - qd @ sd @ zd.mH, bd - qd @ td @ zd.mH
        rec_a = (torch.linalg.matrix_norm(ea) / torch.linalg.matrix_norm(ad)).item()
        rec_b = (torch.linalg.matrix_norm(eb) / torch.linalg.matrix_norm(bd)).item()
        orth_q = (qd.mH @ qd - eye).abs().max().item()
        orth_z = (zd.mH @ zd - eye).abs().max().item()
        eta = torch.hypot(torch.linalg.matrix_norm(ea, ord=2),
                          torch.linalg.matrix_norm(eb, ord=2)).item()
        tri = not bool(torch.tril(s, -1).any()) and not bool(torch.tril(t, -1).any())
        check(bool(info.converged) and tri and max(rec_a, rec_b, orth_q, orth_z) <= tol,
              f"{label}, the QZ step: converged in {int(info.iterations)} "
              f"{'rounds' if n >= tqz._MULTISHIFT_MIN_N else 'iterations'}, S and T upper "
              f"triangular {tri}; |A - QSZᴴ|/|A| {rec_a:.3e}, |B - QTZᴴ|/|B| {rec_b:.3e}, "
              f"max|QᴴQ - I| {orth_q:.3e}, max|ZᴴZ - I| {orth_z:.3e}, all <= {tol:.3e}; "
              f"backward error η = |(A - QSZᴴ, B - QTZᴴ)|₂ {eta:.3e}")
        return eta

    a128, b128, proc, recv = gref
    try:
        n = CGEVD_N
        for dt in (torch.complex64, torch.complex128):
            name = "c64" if dt == torch.complex64 else "c128"
            a, b = a128.to(dt), b128.to(dt)
            label = f"gevd n={n} {name}"
            (alpha, beta, v, info), _ = run(label, lambda: gevd(a, b), n)
            eta = qz_checks(label, a, b, *qz_out[0][:4], qz_out[0][4], dt)
            if recv is not None:  # the reference, once: it ran beside phase 17
                t0 = time.perf_counter()
                ra, rb, kappa, ref_ms = recv.recv()
                proc.join()
                wait = time.perf_counter() - t0
                ra, rb, kappa = (torch.from_numpy(x).to(DEV) for x in (ra, rb, kappa))
                recv = None
                print(f"reference n={n}: f64 scipy.linalg.eig of the complex128 pencil with "
                      f"left and right vectors {ref_ms:.1f} ms on one host core (waited "
                      f"{wait:.1f} s); chordal condition numbers median "
                      f"{kappa.median().item():.3g}, largest {kappa.max().item():.3g}")
            tol = 8 * n * torch.finfo(dt).eps
            res = _pencil_residual(a, b, alpha, beta, v)
            ratio = _chordal_ratio(alpha, beta, ra, rb, kappa, eta)
            check(bool(info.converged) and alpha.dtype == beta.dtype == v.dtype == dt
                  and res <= tol and ratio <= 1,
                  f"{label}: |AVβ - BVα| column by column {res:.3e} <= {tol:.3e} of "
                  f"(|A||β| + |B||α|)|v|; (α, β) vs f64 scipy.linalg.eig within {ratio:.3e} "
                  f"of their chordal bounds 2·κ_i·η")
            lib = cuda_ms(lambda: torch.linalg.eig(torch.linalg.solve(b, a)), 1)
            print(f"time library n={n} {name}: torch.linalg.eig(torch.linalg.solve(B, A)) "
                  f"{lib:.1f} ms (one call, CUDA events)")

        # the multishift route edge through qz, complex64
        for n2 in (tqz._MULTISHIFT_MIN_N - 1, tqz._MULTISHIFT_MIN_N):
            a2, b2 = (torch.complex(torch.randn(n2, n2, generator=gen, device=DEV),
                                    torch.randn(n2, n2, generator=gen, device=DEV))
                      for _ in range(2))
            label = f"qz n={n2} c64"
            out, _ = run(label, lambda: qz(a2, b2), n2)
            qz_checks(label, a2, b2, *out[:4], out[4], torch.complex64)

        # the reduction method: C = B⁻¹A, the complex evd(C)
        n3 = CGEVD_REDUCTION_N
        a3, b3 = (torch.complex(torch.randn(n3, n3, generator=gen, device=DEV),
                                torch.randn(n3, n3, generator=gen, device=DEV))
                  for _ in range(2))
        r = gevd_reduction_readings(a3, b3)
        add(r["counts"])
        lib = cuda_ms(lambda: torch.linalg.eig(torch.linalg.solve(b3, a3)), 1)
        check(r["ok"], f"gevd n={n3} c64 method='reduction': {r['message']}")
        print(f"time gevd n={n3} c64 method='reduction': {r['ms']:.1f} ms (one call, host "
              f"clock); library torch.linalg.eig(torch.linalg.solve(B, A)) {lib:.1f} ms")

        # the self-adjoint-definite pencil: A Hermitian, B Hermitian positive definite
        n4 = CGEVD_SA_N
        g, g2 = (torch.complex(torch.randn(n4, n4, generator=gen, device=DEV),
                               torch.randn(n4, n4, generator=gen, device=DEV))
                 for _ in range(2))
        a4 = (g + g.mH) / 2
        b4 = g2 @ g2.mH / n4 + torch.eye(n4, device=DEV, dtype=torch.complex64)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (w, v, info), counts, reads = _counted(lambda: gevd_self_adjoint(a4, b4))
        ms = (time.perf_counter() - t0) * 1e3
        add(counts)
        c128 = torch.complex128
        vd, ad, bd = v.to(c128), a4.to(c128), b4.to(c128)
        wv = vd * w.double()[None, :]
        res = (torch.linalg.matrix_norm(ad @ vd - bd @ wv)
               / (torch.linalg.matrix_norm(ad) * torch.linalg.matrix_norm(vd)
                  + torch.linalg.matrix_norm(bd) * torch.linalg.matrix_norm(wv))).item()
        cond_b = torch.linalg.cond(bd).item()
        orth = (vd.mH @ bd @ vd - torch.eye(n4, device=DEV, dtype=c128)).abs().max().item()
        tol = 8 * n4 * EPS32
        check(bool(info.converged) and not w.is_complex() and bool((w[1:] >= w[:-1]).all())
              and res <= tol and orth <= tol * cond_b and counts["llt_panel"] > 0
              and counts["tridiag_sweep"] == 1,
              f"gevd_self_adjoint n={n4} c64: w real and ascending, |AV - BVΛ|/(|A||V| + "
              f"|B||VΛ|) {res:.3e} <= {tol:.3e}, max|VᴴBV - I| {orth:.3e} <= "
              f"{tol * cond_b:.3e} (8·n·eps·κ(B)); launches llt_panel {counts['llt_panel']}, "
              f"trtri {counts['trtri']}, tridiag_sweep {counts['tridiag_sweep']}")

        def library_sa():
            l4 = torch.linalg.cholesky(b4)
            c4 = torch.linalg.solve_triangular(l4, a4, upper=False)
            c4 = torch.linalg.solve_triangular(l4, c4.mH, upper=False)
            w4, y4 = torch.linalg.eigh(c4)
            return w4, torch.linalg.solve_triangular(l4.mH, y4, upper=True)

        print(f"time gevd_self_adjoint n={n4} c64: {ms:.1f} ms (one call, host clock); "
              f"library cholesky, solve_triangular and eigh {cuda_ms(library_sa, 1):.1f} ms")

        # the facade
        n5 = CGEVD_FACADE_N
        a5, b5 = (torch.complex(torch.randn(n5, n5, generator=gen, device=DEV),
                                torch.randn(n5, n5, generator=gen, device=DEV))
                  for _ in range(2))
        ge, _ = run(f"Mat(a).generalized_eigen(b) n={n5} c64",
                    lambda: Mat(a5).generalized_eigen(Mat(b5)), n5)
        alpha, beta, v, _ = gevd(a5, b5)
        check(torch.equal(ge.alpha, alpha) and torch.equal(ge.beta, beta)
              and torch.equal(ge.v, v) and bool(ge.info.converged),
              f"Mat(a).generalized_eigen(b) n={n5} c64: gevd's α, β and V to the bit, "
              f"converged")
    finally:
        for mod, fname, fn in saved:
            setattr(mod, fname, fn)
        if recv is not None:
            proc.kill()
    print(f"launches in the complex generalized EVD phase: "
          f"{ {k: v for k, v in total.items() if v} }")
    return total


def _complex_evd_process(conn) -> None:
    """A spawned process's job: phase 17 (:func:`phase_complex_evd`), then
    phase 18 (:func:`phase_complex_gevd`), on the card, beside phases 13–16
    of the main process, on inputs from generators of their own (A from
    :func:`start_complex_reference` and the pencil from
    :func:`start_complex_gevd_reference`, whose f64 references it starts
    first, to run beside phase 17; the rest from seeds SEED + 170 and
    SEED + 180); its printed lines are collected and sent through ``conn``
    with the two phases' launch counts, its exit status (1 for a failed
    check) and its seconds."""
    import contextlib
    import io
    import traceback

    buf = io.StringIO()
    total, status = None, 1
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            gen = torch.Generator(device=DEV).manual_seed(SEED + 170)
            gref = start_complex_gevd_reference()  # phase 18's, beside phase 17
            total = phase_complex_evd(gen, start_complex_reference())
            t17 = time.perf_counter() - t0
            print(f"phase 17: {t17:.1f} s in its process")
            gen = torch.Generator(device=DEV).manual_seed(SEED + 180)
            total18 = phase_complex_gevd(gen, gref)
            print(f"phase 18: {time.perf_counter() - t0 - t17:.1f} s in its process, "
                  f"after phase 17")
            total = {k: total.get(k, 0) + total18.get(k, 0) for k in {*total, *total18}}
            status = 0
    except SystemExit as exc:  # a failed check: its FAIL line is in buf
        status = exc.code if isinstance(exc.code, int) and exc.code else 1
    except Exception:  # reported to the main process, which fails on it
        buf.write(traceback.format_exc())
    conn.send((buf.getvalue(), total, status, time.perf_counter() - t0))
    conn.close()


def start_complex_evd() -> tuple:
    """Phases 17 and 18 in a spawned process of their own, to run beside
    phases 13–16: their work, as theirs, is host-bound (the card waits on
    one host core in each process), so the two share the card with little
    to choose between them. Returns (process, receiving end of its pipe)."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    recv, send = ctx.Pipe(duplex=False)
    proc = ctx.Process(target=_complex_evd_process, args=(send,))
    proc.start()
    send.close()
    return proc, recv


def finish_complex_evd(job) -> dict:
    """Wait for :func:`start_complex_evd`'s process, print its lines, fail
    if it failed, and return its launch counts."""
    proc, recv = job
    try:
        text, total, status, secs = recv.recv()
    except EOFError:
        proc.join()
        fail(f"phase 17's process ended with code {proc.exitcode} and sent nothing")
    proc.join()
    print(text, end="", flush=True)
    check(status == 0 and total is not None,
          f"phases 17 and 18 (complex general and generalized EVD) passed every check, "
          f"{secs:.1f} s in a process of their own beside phases 13–16")
    return total

def _scipy_pencil_reference(a, b, conn) -> None:
    """A host process: the f64 LAPACK eigenvalues of the pencil (a, b) as
    homogeneous (α, β) (``scipy.linalg.eig``), each one's chordal
    condition number κ_i = ‖x_i‖‖y_i‖/‖(y_iᴴAx_i, y_iᴴBx_i)‖ from the
    left and right vectors, and the call's time in ms, sent through
    ``conn``."""
    import numpy as np
    import scipy.linalg

    t0 = time.perf_counter()
    (ra, rb), yl, xr = scipy.linalg.eig(a, b, left=True, right=True, homogeneous_eigvals=True)
    ms = (time.perf_counter() - t0) * 1e3
    kappa = (np.linalg.norm(yl, axis=0) * np.linalg.norm(xr, axis=0)
             / np.hypot(np.abs(np.sum(yl.conj() * (a @ xr), axis=0)),
                        np.abs(np.sum(yl.conj() * (b @ xr), axis=0))))
    conn.send((ra, rb, kappa, ms))
    conn.close()


def gevd_pencil() -> tuple:
    """Phase 15's Gaussian pencil (A, B) at GEVD_N, float32 on the card,
    from a generator of its own (seed SEED + 15), so that its reference can
    start before the phases run."""
    g = torch.Generator(device=DEV).manual_seed(SEED + 15)
    return tuple(torch.randn(GEVD_N, GEVD_N, generator=g, device=DEV) for _ in range(2))


def start_gevd_reference(a, b) -> tuple:
    """Start :func:`_scipy_pencil_reference` of (a, b) in float64 (complex128
    for a complex pencil) in a
    spawned daemon process with one BLAS thread, so that it runs beside
    phases 3–14 on one core: (process, receiving end of its pipe)."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    recv, send = ctx.Pipe(duplex=False)
    names = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")
    saved = {k: os.environ.get(k) for k in names}
    os.environ.update(dict.fromkeys(names, "1"))  # read by the child at its start
    try:
        proc = ctx.Process(target=_scipy_pencil_reference, daemon=True,
                           args=(_wide(a).cpu().numpy(), _wide(b).cpu().numpy(), send))
        proc.start()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    send.close()
    return proc, recv


def _chordal_ratio(al, be, ra, rb, kappa, eta: float) -> float:
    """How far the computed (α, β) lie from the reference (α̂, β̂) (all
    complex, on the card) in the chordal metric |αβ̂ − α̂β|/(‖(α, β)‖
    ‖(α̂, β̂)‖), against each reference eigenvalue's bound 2·κ_i·η (the
    first-order perturbation bound κ_i·η, κ_i its chordal condition number,
    η the call's backward error ‖(A − QSZᵀ, B − QTZᵀ)‖₂, doubled for the
    reference's own error): the largest ratio, each eigenvalue matched to
    the nearest of the other set in both directions."""
    al, be = al.to(torch.complex128), be.to(torch.complex128)
    chord = ((al[:, None] * rb[None, :] - ra[None, :] * be[:, None]).abs()
             / (torch.hypot(al.abs(), be.abs())[:, None]
                * torch.hypot(ra.abs(), rb.abs())[None, :]))
    tol = 2 * kappa * eta
    near_ref = chord.min(dim=1)
    near_w = chord.min(dim=0)
    return max((near_ref.values / tol[near_ref.indices]).max().item(),
               (near_w.values / tol).max().item())


def _wide(x):
    """``x`` in float64, or in complex128 when it is complex."""
    return x.to(torch.complex128) if x.is_complex() else x.double()


def _pencil_residual(a, b, alpha, beta, v) -> float:
    """max_k ‖A v_k β_k − B v_k α_k‖ / ((‖A‖₂|β_k| + ‖B‖₂|α_k|)‖v_k‖), in
    float64 (complex128) on the card."""
    c = torch.complex128
    ad, bd, vd = _wide(a).to(c), _wide(b).to(c), v.to(c)
    al, be = alpha.to(c), beta.to(c)
    num = torch.linalg.vector_norm(ad @ vd * be[None, :] - bd @ vd * al[None, :], dim=0)
    den = ((torch.linalg.matrix_norm(_wide(a), ord=2) * be.abs()
            + torch.linalg.matrix_norm(_wide(b), ord=2) * al.abs())
           * torch.linalg.vector_norm(vd, dim=0))
    return (num / den).max().item()


def gevd_reduction_readings(a, b) -> dict:
    """``gevd(a, b, method="reduction")`` in float32 (or complex64) on the
    card, held to
    the backward error of its two steps: Ĉ, the LU solve of B Ĉ = A
    (captured from ``lu_solve``), with η_s = ‖A − BĈ‖₂/(‖B‖₂‖Ĉ‖₂), and
    evd(Ĉ), with η_e = max_k ‖Ĉv_k − λ_k v_k‖/(‖Ĉ‖₂‖v_k‖), each within
    8·n·eps of the dtype; then, since A v − λ B v = (A − BĈ)v + B(Ĉv −
    λv), the pencil
    residual (:func:`_pencil_residual`, β = 1) within 2·κ₂(B)·η, η =
    max(η_s, η_e): the first-order bound (η_s + η_e)·‖B‖₂‖Ĉ‖₂/‖A‖₂, with
    ‖Ĉ‖₂ ≤ ‖B⁻¹‖₂‖A‖₂. No bound of the form 8·n·eps holds for the pencil
    residual here, as κ₂(B) enters it. Returns the readings, ``ok``, a
    ``message``, the launch counts, the host reads and the call's time
    (host clock)."""
    from faer_tpu_torch import gevd
    from faer_tpu_torch.linalg import lu as tlu

    n = a.shape[0]
    solved = []
    lu_solve = tlu.lu_solve

    def keep(*args, **kw):
        solved[:] = [lu_solve(*args, **kw)]
        return solved[0]

    tlu.lu_solve = keep
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (alpha, beta, v, info), counts, reads = _counted(
            lambda: gevd(a, b, method="reduction"))
        ms = (time.perf_counter() - t0) * 1e3
    finally:
        tlu.lu_solve = lu_solve
    c128 = torch.complex128
    ad, bd, cd = _wide(a), _wide(b), _wide(solved[0])
    norm_a, norm_b, norm_c = (torch.linalg.matrix_norm(x, ord=2).item() for x in (ad, bd, cd))
    eta_s = torch.linalg.matrix_norm(ad - bd @ cd, ord=2).item() / (norm_b * norm_c)
    vx, w = v.to(c128), alpha.to(c128)
    eta_e = (torch.linalg.vector_norm(cd.to(c128) @ vx - vx * w[None, :], dim=0)
             / (norm_c * torch.linalg.vector_norm(vx, dim=0))).max().item()
    kappa = torch.linalg.cond(bd).item()
    eta = max(eta_s, eta_e)
    res = _pencil_residual(a, b, alpha, beta, v)
    tol = 8 * n * torch.finfo(a.dtype).eps
    launched = {k: c for k, c in counts.items() if c}
    # a complex LU runs no kernel; the complex evd's Schur step is complex_schur
    kernels = counts["complex_schur"] > 0 if a.is_complex() else \
        counts["lu_panel"] + counts["lu_leaf"] > 0 and counts["real_schur"] > 0
    ok = (bool(info.converged) and bool((beta == 1).all()) and max(eta_s, eta_e) <= tol
          and res <= 2 * kappa * eta and kernels)
    message = (f"β = 1; backward errors of the LU solve η_s {eta_s:.3e} and of evd(Ĉ) "
               f"η_e {eta_e:.3e}, both <= {tol:.3e} (8·n·eps); |AV - BVΛ| column by column "
               f"{res:.3e} <= 2·κ₂(B)·η {2 * kappa * eta:.3e} (κ₂(B) {kappa:.4g}, "
               f"‖B‖‖Ĉ‖/‖A‖ {norm_b * norm_c / norm_a:.4g}; {res / tol:.3g} of 8·n·eps); "
               f"launches {launched}")
    return dict(ok=ok, message=message, eta_s=eta_s, eta_e=eta_e, kappa=kappa,
                residual=res, bound=2 * kappa * eta, counts=counts, reads=reads, ms=ms)


def phase_generalized_evd(gen, pencil, reference) -> dict:
    """The generalized real EVD.

    * ``gevd`` at GEVD_N in float32 and float64 on ``pencil``
      (:func:`gevd_pencil`, made in float32, so that both runs and the
      reference see the same numbers): the QZ step's ‖A − QSZᵀ‖/‖A‖, ‖B − QTZᵀ‖/‖B‖,
      max|QᵀQ − I| and max|ZᵀZ − I| within 8·n·eps of the dtype, S
      quasi-triangular and T triangular; the pencil residual
      (:func:`_pencil_residual`) within 8·n·eps; every (α, β) against f64
      ``scipy.linalg.eig`` (``reference``: the host process that
      :func:`start_gevd_reference` started after the build) within
      2·κ_i·η (:func:`_chordal_ratio`); each call's time (host clock, one
      call) and its stages (the reduction, the QZ iteration, the
      eigenvectors), its launches (one ``hess_tri``, one ``real_qz``, and
      in float32 the QR of B's ``qr_panel`` and ``trtri``) and host reads;
    * a B of rank 192 at 256: as many β within n·eps·‖B‖₂ of 0 as B's
      nullity (64), the pencil residual of the rest;
    * ``gevd(method="reduction")`` at 512 (:func:`gevd_reduction_readings`)
      beside ``torch.linalg.eig(torch.linalg.solve(B, A))``;
    * ``gevd_self_adjoint`` at 1024: ‖AV − BVΛ‖ and max|VᵀBV − I|;
    * ``Mat(a).generalized_eigen(b)`` once, equal to ``gevd`` to the bit.

    Returns the summed launch counts."""
    from faer_tpu_torch import Mat, gevd, gevd_self_adjoint
    from faer_tpu_torch.linalg import eigvec, qz as tqz, qz_real as tqr
    from faer_tpu_torch.ops.kernels import real_qz as kq

    total = {}

    def add(counts):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v

    stages = {"hessenberg_triangular": 0.0, "real_qz_iteration": 0.0,
              "quasi_triangular_generalized_eigenvectors_pair": 0.0}
    qz_out = []

    def wrap(mod, name):
        fn = getattr(mod, name)

        def timed(*args, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            stages[name] += (time.perf_counter() - t) * 1e3
            if name == "real_qz_iteration":
                qz_out[:] = [out]
            return out
        setattr(mod, name, timed)
        return mod, name, fn

    a, b = pencil
    n = a.shape[0]
    steps = []  # the QZ kernel's chase steps in the last call
    qz_batched = kq.real_qz_batched

    def counted_steps(*args, **kw):
        out = qz_batched(*args, **kw)
        steps[:] = out[6].tolist()
        return out

    kq.real_qz_batched = counted_steps
    saved = [wrap(tqz, "hessenberg_triangular"), wrap(tqr, "real_qz_iteration"),
             wrap(eigvec, "quasi_triangular_generalized_eigenvectors_pair"),
             (kq, "real_qz_batched", qz_batched)]
    try:
        runs = {}
        for dt in (torch.float32, torch.float64):
            for k in stages:
                stages[k] = 0.0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out, counts, reads = _counted(lambda: gevd(a.to(dt), b.to(dt)))
            ms = (time.perf_counter() - t0) * 1e3
            add(counts)
            runs[dt] = (out, qz_out[0], ms, dict(stages), counts, reads, steps[0])
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    proc, recv = reference
    t0 = time.perf_counter()
    ra, rb, kappa, ref_ms = recv.recv()
    proc.join()
    wait_ms = (time.perf_counter() - t0) * 1e3
    ra, rb, kappa = (torch.from_numpy(x).to(DEV) for x in (ra, rb, kappa))
    print(f"reference n={n}: f64 scipy.linalg.eig with left and right vectors, {ref_ms:.1f} "
          f"ms (host CPU, one BLAS thread, beside phases 3-14; waited {wait_ms:.1f} ms for "
          f"it here); chordal condition numbers median {kappa.median().item():.3g}, "
          f"largest {kappa.max().item():.3g}")
    for dt, ((alpha, beta, v, info), (s, t, q, z, qinfo), ms, st, counts, reads,
             nsteps) in runs.items():
        name = "f32" if dt == torch.float32 else "f64"
        tol = 8 * n * torch.finfo(dt).eps
        ad, bd = a.double(), b.double()
        sd, td, qd, zd = (x.double() for x in (s, t, q, z))
        eye = torch.eye(n, device=DEV, dtype=torch.float64)
        ea, eb = ad - qd @ sd @ zd.T, bd - qd @ td @ zd.T
        rec_a = (torch.linalg.matrix_norm(ea) / torch.linalg.matrix_norm(ad)).item()
        rec_b = (torch.linalg.matrix_norm(eb) / torch.linalg.matrix_norm(bd)).item()
        orth_q = (qd.T @ qd - eye).abs().max().item()
        orth_z = (zd.T @ zd - eye).abs().max().item()
        eta = torch.hypot(torch.linalg.matrix_norm(ea, ord=2),
                          torch.linalg.matrix_norm(eb, ord=2)).item()
        shape_ok = not bool(torch.tril(s, -2).any()) and not bool(torch.tril(t, -1).any())
        check(bool(qinfo.converged) and shape_ok and max(rec_a, rec_b, orth_q, orth_z) <= tol,
              f"gevd n={n} {name}, the QZ step: converged in {int(qinfo.iterations)} "
              f"iterations, S quasi-triangular, T triangular; |A - QSZᵀ|/|A| {rec_a:.3e}, "
              f"|B - QTZᵀ|/|B| {rec_b:.3e}, max|QᵀQ - I| {orth_q:.3e}, max|ZᵀZ - I| "
              f"{orth_z:.3e}, all <= {tol:.3e}; backward error η = |(A - QSZᵀ, B - QTZᵀ)|₂ "
              f"{eta:.3e}")
        res = _pencil_residual(a.to(dt), b.to(dt), alpha, beta, v)
        ratio = _chordal_ratio(alpha, beta, ra, rb, kappa, eta)
        cdt = torch.complex64 if dt == torch.float32 else torch.complex128
        check(bool(info.converged) and alpha.dtype == beta.dtype == v.dtype == cdt
              and res <= tol and ratio <= 1,
              f"gevd n={n} {name}: |AVβ - BVα| column by column {res:.3e} <= {tol:.3e} of "
              f"(|A||β| + |B||α|)|v|; (α, β) vs f64 scipy.linalg.eig within {ratio:.3e} of "
              f"their chordal bounds 2·κ_i·η")
        want = dict(hess_tri=1, real_qz=1)
        launched = {k: counts[k] for k in ("hess_tri", "real_qz", "qr_panel", "trtri")}
        check(all(counts[k] == v for k, v in want.items())
              and (dt == torch.float64 or (counts["qr_panel"] > 0 and counts["trtri"] > 0)),
              f"gevd n={n} {name}: launches {launched} (one hess_tri, one real_qz; the "
              f"QR of B's qr_panel and trtri in float32), {reads} host reads")
        lib = cuda_ms(lambda: torch.linalg.eig(torch.linalg.solve(b.to(dt), a.to(dt))), 1)
        red_ms, qz_ms = st["hessenberg_triangular"], st["real_qz_iteration"]
        print(f"time gevd n={n} {name}: {ms:.1f} ms (one call, host clock); stages: "
              f"the reduction {red_ms:.1f} ms ({red_ms / ((n - 1) * (n - 2) / 2) * 1e3:.3f} us "
              f"a Givens pair, the QR of B included), QZ {qz_ms:.1f} ms ({nsteps} chase "
              f"steps, {qz_ms / max(nsteps, 1) * 1e3:.3f} us a step), the eigenvectors "
              f"{st['quasi_triangular_generalized_eigenvectors_pair']:.1f} ms; library "
              f"torch.linalg.eig(torch.linalg.solve(B, A)) {lib:.1f} ms; the reference "
              f"scipy.linalg.eig (f64, host CPU, one thread) {ref_ms:.1f} ms")

    # a B of rank r: n − r infinite eigenvalues
    m, r = GEVD_RANK
    for dt in (torch.float32, torch.float64):
        name = "f32" if dt == torch.float32 else "f64"
        a2 = torch.randn(m, m, generator=gen, device=DEV, dtype=torch.float64).to(dt)
        b2 = (torch.randn(m, r, generator=gen, device=DEV, dtype=torch.float64)
              @ torch.randn(r, m, generator=gen, device=DEV, dtype=torch.float64)).to(dt)
        out, counts, reads = _counted(lambda: gevd(a2, b2))
        add(counts)
        alpha, beta, v, info = out
        floor = m * torch.finfo(dt).eps * torch.linalg.matrix_norm(b2.double(), ord=2).item()
        inf = beta.abs() <= floor
        res = _pencil_residual(a2, b2, alpha[~inf], beta[~inf], v[:, ~inf])
        tol = 8 * m * torch.finfo(dt).eps
        check(bool(info.converged) and int(inf.sum()) == m - r and res <= tol,
              f"gevd n={m}, B of rank {r} {name}: {int(inf.sum())} β within {floor:.3e} "
              f"(n·eps·|B|₂) of 0 ({m - r}), of them {int((beta == 0).sum())} exactly 0; "
              f"the finite ones' residual {res:.3e} <= {tol:.3e}")

    # the reduction method: C = B⁻¹A, evd(C)
    n3 = GEVD_REDUCTION_N
    a3 = torch.randn(n3, n3, generator=gen, device=DEV)
    b3 = torch.randn(n3, n3, generator=gen, device=DEV)
    r = gevd_reduction_readings(a3, b3)
    add(r["counts"])
    lib = cuda_ms(lambda: torch.linalg.eig(torch.linalg.solve(b3, a3)), 1)
    # the LU of B below 1024 is the recursive driver's (lu_leaf leaves), as
    # in the JAX package; from 1024 the fused lu_panel route
    check(r["ok"], f"gevd n={n3} f32 method='reduction': {r['message']}")
    print(f"time gevd n={n3} f32 method='reduction': {r['ms']:.1f} ms (one call, host "
          f"clock); library torch.linalg.eig(torch.linalg.solve(B, A)) {lib:.1f} ms")

    # the self-adjoint-definite pencil
    n4 = GEVD_SA_N
    g = torch.randn(n4, n4, generator=gen, device=DEV)
    a4 = (g + g.T) / 2
    g2 = torch.randn(n4, n4, generator=gen, device=DEV)
    b4 = g2 @ g2.T / n4 + torch.eye(n4, device=DEV)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, counts, reads = _counted(lambda: gevd_self_adjoint(a4, b4))
    ms = (time.perf_counter() - t0) * 1e3
    add(counts)
    w, v, info = out
    vd, ad, bd = v.double(), a4.double(), b4.double()
    res = (torch.linalg.matrix_norm(ad @ vd - bd @ vd * w.double()[None, :])
           / (torch.linalg.matrix_norm(ad) * torch.linalg.matrix_norm(vd)
              + torch.linalg.matrix_norm(bd) * torch.linalg.matrix_norm(vd * w.double()[None, :]))
           ).item()
    cond_b = torch.linalg.cond(bd).item()
    orth = (vd.T @ bd @ vd - torch.eye(n4, device=DEV, dtype=torch.float64)).abs().max().item()
    tol = 8 * n4 * EPS32
    check(bool(info.converged) and bool((w[1:] >= w[:-1]).all()) and res <= tol
          and orth <= tol * cond_b and counts["llt_panel"] > 0
          and counts["tridiag_sweep"] == 1,
          f"gevd_self_adjoint n={n4} f32: w ascending, |AV - BVΛ|/(|A||V| + |B||VΛ|) "
          f"{res:.3e} <= {tol:.3e}, max|VᵀBV - I| {orth:.3e} <= {tol * cond_b:.3e} "
          f"(8·n·eps·κ(B)); launches llt_panel {counts['llt_panel']}, trtri "
          f"{counts['trtri']}, tridiag_sweep {counts['tridiag_sweep']}")

    def library_sa():
        l4 = torch.linalg.cholesky(b4)
        c4 = torch.linalg.solve_triangular(l4, a4, upper=False)
        c4 = torch.linalg.solve_triangular(l4, c4.T, upper=False)
        w4, y4 = torch.linalg.eigh(c4)
        return w4, torch.linalg.solve_triangular(l4.T, y4, upper=True)

    print(f"time gevd_self_adjoint n={n4} f32: {ms:.1f} ms (one call, host clock); library "
          f"cholesky, solve_triangular and eigh {cuda_ms(library_sa, 1):.1f} ms")

    # the facade
    n5 = GEVD_FACADE_N
    a5 = torch.randn(n5, n5, generator=gen, device=DEV)
    b5 = torch.randn(n5, n5, generator=gen, device=DEV)
    ge, counts, reads = _counted(lambda: Mat(a5).generalized_eigen(Mat(b5)))
    add(counts)
    alpha, beta, v, _ = gevd(a5, b5)
    check(torch.equal(ge.alpha, alpha) and torch.equal(ge.beta, beta) and torch.equal(ge.v, v)
          and bool(ge.info.converged) and counts["hess_tri"] == counts["real_qz"] == 1,
          f"Mat(a).generalized_eigen(b) n={n5} f32: gevd's α, β and V to the bit, "
          f"converged; launches hess_tri {counts['hess_tri']}, real_qz {counts['real_qz']}")
    print(f"launches in the generalized EVD phase: { {k: v for k, v in total.items() if v} }")
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


def _tool(name: str):
    """The module ``tools/<name>.py``."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_panel_lab() -> dict:
    """``tools/torch_qr_panels.py``'s panel lab on the card: every QR panel
    wrapper at its nine shapes, each residual within 8·m·eps, and each
    counter's launches equal to the tool's calls (one launch a call)."""
    lab = _tool("torch_qr_panels")
    rows, counts, _ = _counted(lambda: lab.panel_lab(LAB_REPS, LAB_WARMUP))
    want = {k: v * len(lab.SHAPES)
            for k, v in lab.calls_per_shape(LAB_REPS, LAB_WARMUP).items()}
    got = {k: v for k, v in counts.items() if v}
    print(f"launches in the panel lab: {counts}")
    check(got == want, f"panel lab launches {got}, predicted {want}")
    check(len(rows) == len(lab.SHAPES) * 6 and all(r["ok"] for r in rows),
          f"panel lab: {len(rows)} panels, every |QR-A|/|A| <= 8 m eps (largest "
          f"{max(r['resid'] / (8 * r['m'] * EPS32) for r in rows):.3e} of its "
          f"bound); largest difference from qr_panel: packed "
          f"{max(r['packed_diff'] for r in rows):.3e}, tau "
          f"{max(r['tau_diff'] for r in rows):.3e}")
    return counts


def phase_llt_lab() -> dict:
    """``tools/torch_llt_blocks.py``'s lab on the card: the five LLT calls at
    b ∈ {128, 256, 512}, each residual within 8·b·eps, the regularized block
    (the three wrappers agree on count and ok), the twelve plugged-leaf 4096²
    factors and ``llt_factor``, each within 8·n·eps, and every counter equal
    to the tool's prediction, ``trtri`` and ``llt_panel`` included. The three
    leaf wrappers launch one kernel (``csrc/llt_block.cu``), so the lab
    compares leaf widths and block sizes, not leaf designs."""
    lab = _tool("torch_llt_blocks")
    rows, counts, _ = _counted(lambda: (lab.block_lab(LLT_LAB_REPS, LLT_LAB_WARMUP)
                                        + lab.factor_lab(LLT_LAB_REPS, LLT_LAB_WARMUP)))
    want = lab.predicted_launches(LLT_LAB_REPS, LLT_LAB_WARMUP)
    got = {k: v for k, v in counts.items() if v}
    print(f"launches in the LLT block lab: {counts}")
    check(got == want, f"LLT block lab launches {got}, predicted {want}")
    factors = [r for r in rows if "factor" in r]
    check(len(factors) == 13 and all(r["ok"] for r in rows),
          f"LLT block lab: {len(rows) - len(factors)} block rows and {len(factors)} "
          f"factors, every check held (largest residual of a factor "
          f"{max(r['resid'] for r in factors):.3e} <= {8 * N * EPS32:.3e})")
    return counts


def phase_chase_lab(spectral_ms: dict) -> dict:
    """``tools/torch_chase.py``'s lab on the card: ``chase_probe`` over its
    12-point grid, every output finite, launches equal to the tool's calls,
    the chain latency per step (two step counts at g = 1) and the two-stage
    verdict against phase 7's one-stage reduction and ``eigh``
    (``spectral_ms``)."""
    lab = _tool("torch_chase")
    rows, counts, _ = _counted(lambda: lab.chase_lab(CHASE_LAB_REPS, CHASE_LAB_WARMUP))
    want = lab.predicted_launches(CHASE_LAB_REPS, CHASE_LAB_WARMUP)
    got = {k: v for k, v in counts.items() if v}
    print(f"launches in the chase lab: {counts}")
    check(got == want, f"chase lab launches {got}, predicted {want}")
    check(len(rows) == len(lab.GRID) and all(r["ok"] for r in rows),
          f"chase lab: {len(rows)} grid points, every output finite (largest "
          f"max|out| {max(r['max_abs'] for r in rows):.4g})")
    for b in (64, 128):
        t = {r["steps"]: r["ms"] for r in rows if r["b"] == b and r["g"] == 1}
        (s0, t0), (s1, t1) = sorted(t.items())
        print(f"chase_probe chain latency b={b}, g=1: {(t1 - t0) / (s1 - s0) * 1e3:.4f} "
              f"us per step ({s0} and {s1} steps)")
    decision = lab.verdict(rows, spectral_ms["tridiag_in_place"], spectral_ms["eigh"])
    print(f"two-stage verdict at n={lab.N}, b={lab.BAND}: "
          f"{'a chase fits' if decision['pays'] else 'no chase fits'} in "
          f"{lab.BUDGET_SHARE} of the one-stage reduction for any g")
    return counts


# phase 16: complex input (ROADMAP item 10a), full width
COMPLEX_N = ((torch.complex64, N), (torch.complex128, 1024))
COMPLEX_FACADE_N = 1024
COMPLEX_BATCH = (64, 128)  # llt_solve_batched: B problems of n²
COMPLEX_RHS = 8
COMPLEX_WARM_N = 96  # each call once at this size first: loads and first allocations


def llt_panel_launches(n: int) -> int:
    """The ``llt_panel`` launches of a float32 ``llt_factor`` of side n on
    the fused-panel route (``_llt_factor_v5``: block 256 from n = 1024,
    outer strips of 1024 from 2048), one a panel of each strip, counted
    from the code."""
    block = 256
    ob = max(block, 1024) if n >= 2048 else block
    return sum(-(-min(ob, n - k) // block) for k in range(0, n, ob))


def _complex_inputs(n: int, dt, gen) -> dict:
    """g (complex Gaussian), spd = g gᴴ/n + I, herm = (g + gᴴ)/2 and an
    n × COMPLEX_RHS right-hand side, made on the card in ``dt``."""
    rdt = dt.to_real()

    def randn(*shape):
        return torch.complex(torch.randn(*shape, generator=gen, device=DEV, dtype=rdt),
                             torch.randn(*shape, generator=gen, device=DEV, dtype=rdt))

    g = randn(n, n)
    return dict(g=g, spd=g @ g.mH / n + torch.eye(n, device=DEV, dtype=dt),
                herm=(g + g.mH) / 2, b=randn(n, COMPLEX_RHS))


def _complex_calls(x: dict) -> list:
    """Phase 16's calls on the inputs ``x``: (key, call, check, library
    yardstick, predicted launches or None). A check returns [(value,
    limit, text)]; the predictions are {counter: count} with every other
    counter 0, the spectral ones with 0 host reads."""
    from faer_tpu_torch.linalg import cholesky as ch
    from faer_tpu_torch.linalg import evd, lu, qr, svd

    g, spd, herm, b = x["g"], x["spd"], x["herm"], x["b"]
    n, dt = g.shape[0], g.dtype
    tol = 8 * n * float(torch.finfo(dt.to_real()).eps)
    eye = torch.eye(n, device=DEV, dtype=dt)
    c64 = dt == torch.complex64

    def llt():
        l, info = ch.llt_factor(spd)
        return l, info, ch.llt_solve(l, b)

    def ldlt():
        ld, info = ch.ldlt_factor(spd)
        return ld, info, ch.ldlt_solve(ld, b)

    def lu_():
        f, p, info = lu.lu_in_place(g)
        return f, p, info, lu.lu_solve(f, p, b)

    def qr_():
        pk, ts, blk = qr.qr_in_place(g)
        return pk, ts, blk, qr.qr_solve_lstsq(pk, ts, blk, b)

    def cpqr():
        pk, taus, perm = qr.col_piv_qr_in_place(g)
        return pk, taus, perm, qr.col_piv_qr_solve_lstsq(pk, taus, perm, b)

    def oracle_w():
        return torch.linalg.eigvalsh(herm.to(torch.complex128))

    def oracle_s():
        return torch.linalg.svdvals(g.to(torch.complex128))

    def chk_evd(r):
        w, v, info = r
        res = (torch.linalg.matrix_norm(herm @ v - v * w[None, :].to(dt))
               / torch.linalg.matrix_norm(herm)).item()
        orth = (v.mH @ v - eye).abs().max().item()
        w64 = oracle_w()
        werr = ((w.double() - w64).abs().max() / w64.abs().max()).item()
        return [(res, tol, "|AV - VΛ|/|A|"), (orth, tol, "max|VᴴV - I|"),
                (werr, tol, "max|w - eigvalsh(c128)|/max|w|"),
                (0.0 if bool(info.converged) and w.dtype == dt.to_real() else 1.0, 0.5,
                 "converged, w real")]

    def chk_svd(r):
        u, s, v, info = r
        s64 = oracle_s()
        return [(rel_norm((u * s[None, :].to(dt)) @ v.mH, g), tol, "|U diag(s) Vᴴ - A|/|A|"),
                ((u.mH @ u - eye).abs().max().item(), tol, "max|UᴴU - I|"),
                ((v.mH @ v - eye).abs().max().item(), tol, "max|VᴴV - I|"),
                (((s.double() - s64).abs().max() / s64[0]).item(), tol,
                 "max|s - svdvals(c128)|/s_max"),
                (0.0 if bool(info.converged) and s.dtype == dt.to_real() else 1.0, 0.5,
                 "converged, s real")]

    none: dict = {}
    return [
        ("llt + solve", llt,
         lambda r: [(rel_norm(r[0] @ r[0].mH, spd), tol, "|LLᴴ - A|/|A|"),
                    (_res(spd, r[2], b), tol, "|Ax - b|/(|A||x|)"),
                    (0.0 if bool(r[1].success) else 1.0, 0.5, "success")],
         ("cholesky_ex", lambda: torch.linalg.cholesky_ex(spd)),
         # the 2n f32 factor's panels; one batched trtri a triangular solve
         dict(llt_panel=llt_panel_launches(2 * n), trtri=2) if c64 else none),
        ("ldlt + solve", ldlt,
         lambda r: [(rel_norm(ch.ldlt_reconstruct(r[0]), spd), tol, "|LDLᴴ - A|/|A|"),
                    (_res(spd, r[2], b), tol, "|Ax - b|/(|A||x|)")],
         ("ldl_factor_ex", lambda: torch.linalg.ldl_factor_ex(spd, hermitian=True)),
         None if c64 else none),
        ("lu + solve", lu_,
         lambda r: [(rel_norm(lu.lu_reconstruct(r[0], r[1]), g), tol, "|P⁻¹LU - A|/|A|"),
                    (_res(g, r[3], b), tol, "|Ax - b|/(|A||x|)")],
         ("lu_factor_ex", lambda: torch.linalg.lu_factor_ex(g)), none),
        ("qr + lstsq", qr_,
         lambda r: [(rel_norm(qr.qr_reconstruct(r[0], r[1], r[2]), g), tol, "|QR - A|/|A|"),
                    (_res(g, r[3], b), tol, "|Ax - b|/(|A||x|)")],
         ("geqrf", lambda: torch.geqrf(g)), none),
        ("col_piv_qr + lstsq", cpqr,
         lambda r: [(rel_norm(qr.col_piv_qr_reconstruct(r[0], r[1], r[2]), g), tol,
                     "|QRPᵀ - A|/|A|"), (_res(g, r[3], b), tol, "|Ax - b|/(|A||x|)")],
         ("geqrf", lambda: torch.geqrf(g)), none),
        ("self_adjoint_evd", lambda: evd.self_adjoint_evd(herm), chk_evd,
         ("eigh", lambda: torch.linalg.eigh(herm)), dict(tridiag_sweep=1)),
        ("svd", lambda: svd.svd(g), chk_svd,
         ("svd", lambda: torch.linalg.svd(g, full_matrices=False)), dict(bidiag_sweep=1)),
    ]


def _complex_run(key: str, fn, predicted, total: dict, label: str):
    """One call counted on its own (every counter 0 just before, read just
    after) and timed once on the host clock (it ends in a synchronize);
    its launches against ``predicted`` (None: printed only); a CUDA
    result checked never to leave the card."""
    from faer_tpu_torch.core.config import (
        KERNELS, host_reads, launch_counts, reset_launch_counts)

    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    counts, reads = launch_counts(), host_reads()
    for k, v in counts.items():
        total[k] += v
    got = {k: v for k, v in counts.items() if v}
    tensors = [t for t in (out if isinstance(out, tuple) else (out,))
               if isinstance(t, torch.Tensor)]
    check(all(t.is_cuda for t in tensors), f"{label} {key}: every result on the card")
    if predicted is not None:
        want = dict.fromkeys(KERNELS, 0)
        want.update(predicted)
        check(counts == want and reads == 0,
              f"{label} {key}: launches {got or 'none'}, host reads {reads}; predicted "
              f"{ {k: v for k, v in want.items() if v} or 'none'}, 0 host reads")
    else:
        print(f"launches in {label} {key}: {got or 'none'}, host reads {reads}")
    return out, ms


def phase_complex(gen) -> dict:
    """Complex input through the main paths (ROADMAP item 10a): LLT and
    LDLT (each with an 8-rhs solve; the c64 ones through the 2n float32
    embedding, so the ``llt_panel`` kernel, as many launches as an f32
    ``llt_factor`` of 2n, and ``trtri`` in the solves), the partial-pivot
    LU, QR and column-pivoted QR of a complex Gaussian with their solves
    (no kernel), ``self_adjoint_evd((g + gᴴ)/2)`` and ``svd(g)`` (one
    sweep launch and no host read each), in complex64 at N and complex128
    at 1024, inputs made on the card; each call counted on its own, timed
    once on the host clock (so the EVD and SVD by their first call) beside
    the library call in the same dtype (one warm call, then one timed by
    CUDA events), and checked: reconstructions, residuals, max|VᴴV − I|
    and max|UᴴU − I| within 8·max(m, n)·eps of the dtype, the eigen- and
    singular values against f64 ``eigvalsh``/``svdvals`` of the
    complex128 matrix. Then the facade (``Mat(a).llt().solve``,
    ``.partial_piv_lu().solve``, ``.svd()`` at COMPLEX_FACADE_N c64) and
    ``batched.llt_solve_batched`` on COMPLEX_BATCH c64 problems beside
    ``cholesky_ex`` + ``cholesky_solve`` on the batch. Returns the
    phase's launch counts."""
    from faer_tpu_torch import Mat
    from faer_tpu_torch.core.config import KERNELS
    from faer_tpu_torch.linalg import batched

    total = dict.fromkeys(KERNELS, 0)
    for dt, n in COMPLEX_N:
        warm = _complex_inputs(COMPLEX_WARM_N, dt, gen)
        for _, fn, _, lib, _ in _complex_calls(warm):
            fn()
            lib[1]()
    torch.cuda.synchronize()
    for dt, n in COMPLEX_N:
        label = f"{'c64' if dt == torch.complex64 else 'c128'} n={n}"
        x = _complex_inputs(n, dt, gen)
        for key, fn, chk, lib, predicted in _complex_calls(x):
            out, ms = _complex_run(key, fn, predicted, total, label)
            for val, lim, text in chk(out):
                check(val <= lim, f"{label} {key}: {text} {val:.3e} <= {lim:.3e}")
            del out
            lib_ms = cuda_ms(lib[1], 1, warmup=0)  # warmed at COMPLEX_WARM_N
            print(f"time complex {key} {label}: {ms:.1f} ms (one call, host clock); "
                  f"library {lib[0]} {lib_ms:.4f} ms", flush=True)
        del x
    # the facade at COMPLEX_FACADE_N, complex64
    n = COMPLEX_FACADE_N
    x = _complex_inputs(n, torch.complex64, gen)
    tol = 8 * n * EPS32
    label = f"facade c64 n={n}"
    facade = [
        ("Mat(a).llt().solve", lambda: Mat(x["spd"]).llt().solve(x["b"]),
         lambda r: [(_res(x["spd"], r, x["b"]), tol, "|Ax - b|/(|A||x|)")],
         ("cholesky_ex", lambda: torch.linalg.cholesky_ex(x["spd"])),
         None),  # its check reads info.success on the host once
        ("Mat(g).partial_piv_lu().solve", lambda: Mat(x["g"]).partial_piv_lu().solve(x["b"]),
         lambda r: [(_res(x["g"], r, x["b"]), tol, "|Ax - b|/(|A||x|)")],
         ("lu_factor_ex", lambda: torch.linalg.lu_factor_ex(x["g"])), {}),
        ("Mat(g).svd()", lambda: Mat(x["g"]).svd(),
         lambda r: [(rel_norm((r.u * r.s[None, :].to(r.u.dtype)) @ r.v.mH, x["g"]), tol,
                     "|U diag(s) Vᴴ - A|/|A|"),
                    ((r.u.mH @ r.u - torch.eye(n, device=DEV)).abs().max().item(), tol,
                     "max|UᴴU - I|")],
         ("svd", lambda: torch.linalg.svd(x["g"], full_matrices=False)),
         dict(bidiag_sweep=1)),
    ]
    for key, fn, chk, lib, predicted in facade:
        out, ms = _complex_run(key, fn, predicted, total, label)
        for val, lim, text in chk(out):
            check(val <= lim, f"{label} {key}: {text} {val:.3e} <= {lim:.3e}")
        print(f"time complex {key} {label}: {ms:.1f} ms (one call, host clock); library "
              f"{lib[0]} {cuda_ms(lib[1], 1, warmup=0):.4f} ms", flush=True)
    # batched: B problems of n² through llt_solve_batched
    nb, n = COMPLEX_BATCH
    xs = [_complex_inputs(n, torch.complex64, gen) for _ in range(nb)]
    a_b = torch.stack([v["spd"] for v in xs])
    b_b = torch.stack([v["b"] for v in xs])
    label = f"batched c64 {nb} x {n}²"
    (xb, info), ms = _complex_run("llt_solve_batched", lambda: batched.llt_solve_batched(
        a_b, b_b), None, total, label)
    res = max(_res(a_b[k], xb[k], b_b[k]) for k in range(nb))
    tol = 8 * n * EPS32
    check(res <= tol and bool(info.success.all()) and tuple(xb.shape) == (nb, n, COMPLEX_RHS),
          f"{label}: max over the problems of |Ax - b|/(|A||x|) {res:.3e} <= {tol:.3e}, "
          f"success")

    def lib_batch():
        lc, _ = torch.linalg.cholesky_ex(a_b)
        return torch.cholesky_solve(b_b, lc)

    print(f"time complex llt_solve_batched {label}: {ms:.1f} ms (one call, host clock); "
          f"library cholesky_ex + cholesky_solve on the batch {cuda_ms(lib_batch, 1):.4f} ms",
          flush=True)
    return total


def main() -> None:
    name = phase_device()
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from faer_tpu_torch.core.config import check_f32_policy

    check_f32_policy()
    print("f32 policy: full FP32 matmuls (allow_tf32 False, precision 'highest')")
    t0 = time.perf_counter()

    def timed(phase: str, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        print(f"phase {phase}: {time.perf_counter() - t:.1f} s", flush=True)
        return out

    profs = timed("2 build", phase_build)
    pencil = gevd_pencil()
    reference = start_gevd_reference(*pencil)  # phase 15's, on one host core meanwhile
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    kern = timed("3 kernels", phase_kernels, gen, profs)
    wide = timed("3 wide QZ cases, their plain versions started", start_gevd_wide)
    paths = [timed("4 flagship", phase_flagship, gen), timed("5 qr", phase_qr, gen),
             timed("6 off-route", phase_off_route, gen)]
    spectral, spectral_ms = timed("7 spectral", phase_spectral, gen)
    paths += [spectral, timed("8 facade", phase_facade), timed("9 calu", phase_calu, gen)]
    lab = timed("10 panel lab", phase_panel_lab)
    llt_lab = timed("11 LLT block lab", phase_llt_lab)
    chase_lab = timed("12 chase lab", phase_chase_lab, spectral_ms)
    cevd_job = start_complex_evd()  # phases 17–18, in a process of their own beside 13–16
    try:
        dense = timed("13 dense stack", phase_dense_stack, gen)
        gevd = timed("14 general EVD and f64 spectral", phase_general_evd, gen)
        timed("3 wide QZ cases checked", finish_gevd_wide, wide, kern)
        ggevd = timed("15 generalized EVD", phase_generalized_evd, gen, pencil, reference)
        cplx = timed("16 complex", phase_complex, gen)
        cevd = timed("17-18 complex general and generalized EVD (the wait for their "
                     "process)", finish_complex_evd, cevd_job)
    finally:
        if cevd_job[0].is_alive():  # a failure before phase 17 ended
            cevd_job[0].terminate()
            cevd_job[0].join()
    paths += [lab, llt_lab, chase_lab, dense, gevd, ggevd, cplx, cevd]
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
        "llt_leaf": ("faer_tpu_torch/csrc/llt_block.cu",
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
        "qr_panel_v1": ("faer_tpu_torch/csrc/qr_panel.cu",
                        "faer_tpu/ops/pallas/panel_kernels.py:224"),
        "qr_panel_v2": ("faer_tpu_torch/csrc/qr_panel.cu",
                        "faer_tpu/ops/pallas/qr_panel_v2.py:141"),
        "qr_panel_v3": ("faer_tpu_torch/csrc/qr_panel.cu",
                        "faer_tpu/ops/pallas/qr_panel_v3.py:127"),
        "qr_leaf": ("faer_tpu_torch/csrc/qr_panel.cu",
                    "faer_tpu/ops/pallas/leaf_v4.py:351"),
        "llt_block": ("faer_tpu_torch/csrc/llt_block.cu",
                      "faer_tpu/ops/pallas/panel_kernels.py:151"),
        "llt_block_v3": ("faer_tpu_torch/csrc/llt_block.cu",
                         "faer_tpu/ops/pallas/panel_kernels.py:586"),
        "chase_probe": ("faer_tpu_torch/csrc/band_chase.cu",
                        "faer_tpu/ops/pallas/band_chase.py:89"),
        # no Pallas kernel: the XLA while_loop of the JAX package's real_schur
        "real_schur": ("faer_tpu_torch/csrc/real_schur.cu",
                       "faer_tpu/linalg/real_schur.py:74"),
        # no Pallas kernel: the XLA fori_loops of the JAX package's
        # hessenberg_triangular and the while_loop of its real_qz_iteration
        "hess_tri": ("faer_tpu_torch/csrc/hess_tri.cu", "faer_tpu/linalg/qz.py:45"),
        "real_qz": ("faer_tpu_torch/csrc/real_qz.cu", "faer_tpu/linalg/qz_real.py:56"),
        # no Pallas kernel: the XLA while_loop of the JAX package's
        # complex_schur
        "complex_schur": ("faer_tpu_torch/csrc/complex_schur.cu",
                          "faer_tpu/linalg/evd.py:277"),
        # no Pallas kernel: the XLA fori_loops of the JAX package's complex
        # hessenberg_triangular and the while_loop of its qz_iteration
        "complex_hess_tri": ("faer_tpu_torch/csrc/complex_hess_tri.cu",
                             "faer_tpu/linalg/qz.py:45"),
        "complex_qz": ("faer_tpu_torch/csrc/complex_qz.cu", "faer_tpu/linalg/qz.py:111"),
    }
    # on no library path, as in the JAX package: syrk_lower_sub is unwired,
    # the v3 and v1 LU panels are called by nothing, the QR panels v1, v2,
    # v3 and the v4 leaf only by the panel lab (phase 10), the LLT blocks
    # only by the LLT block lab (phase 11), the chase probe only by the
    # chase lab (phase 12)
    lab_kernels = {"panel lab": (lab, QR_FAMILY),
                   "LLT block lab": (llt_lab, ("llt_block", "llt_block_v3")),
                   "chase lab": (chase_lab, ("chase_probe",))}
    off_path = {"syrk", "lu_panel_v3", "lu_panel_swap",
                *(k for _, ks in lab_kernels.values() for k in ks)}
    check(all(launches[k] > 0 for k in sources if k not in off_path),
          f"every kernel but the off-path {sorted(off_path)} ran on a main path")
    for label, (counts, ks) in lab_kernels.items():
        check(all(counts[k] > 0 for k in ks),
              f"the {label} launched {', '.join(ks)}: {[counts[k] for k in ks]}")
    # the shared headers each kernel's source compiles with
    gemm = ["faer_tpu_torch/csrc/gemm_tile.cuh", "faer_tpu_torch/csrc/hopper.cuh"]
    headers = {"matmul": gemm, "syrk": gemm,
               "tridiag_sweep": ["faer_tpu_torch/csrc/spectral_qr.cuh"],
               "bidiag_sweep": ["faer_tpu_torch/csrc/spectral_qr.cuh"],
               "real_schur": ["faer_tpu_torch/csrc/spectral_qr.cuh"],
               "hess_tri": ["faer_tpu_torch/csrc/spectral_qr.cuh"],
               "real_qz": ["faer_tpu_torch/csrc/spectral_qr.cuh"],
               "complex_schur": ["faer_tpu_torch/csrc/complex_ops.cuh",
                                 "faer_tpu_torch/csrc/spectral_qr.cuh"],
               "complex_hess_tri": ["faer_tpu_torch/csrc/complex_ops.cuh",
                                    "faer_tpu_torch/csrc/spectral_qr.cuh"],
               "complex_qz": ["faer_tpu_torch/csrc/complex_ops.cuh",
                              "faer_tpu_torch/csrc/spectral_qr.cuh"],
               "lu_panel_swap": gemm[1:], "chase_probe": gemm[1:]}
    print(f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": [
        dict(name=k, route="cuda", source=src, headers=headers.get(k, []), replaces=rep,
             launches=launches[k], off_path=k in off_path, **kern[k])
        for k, (src, rep) in sources.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
