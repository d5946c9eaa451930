"""Where the time of a hand-written kernel goes, on one CUDA card.

    python tools/torch_profile.py {chase,complex_hess_tri,complex_qz,complex_schur,llt,
                                   llt_panel,lu,lu_swap,qr,real_schur,trtri} [ROOT]

Builds the kernel's source with its profile macro (its ``clock64`` marks)
into a library of its own under ``build/<kernel>_profile/``, runs it
``REPS`` times after one warm-up on each case, and prints the SM cycles of
each phase, as thread 0 of a CTA sees them between block barriers:

* ``llt`` (``csrc/llt_block.cu``, ``-DFAER_LLT_PROFILE``), per call, on
  A = g gᵀ/b + 2I (seed 1) at b in {128, 256, 512, 1024}: ``stage`` (the
  block into shared memory or L2, and the first barrier), ``first tile``
  (warp 0 factors the first diagonal tile), ``solve`` (the substitution
  solve of every panel, summed), ``tile update`` (all threads update the
  next diagonal tile, summed), ``factor+trailing`` (warp 0 factors it while
  warps 1..15 update the rest of the trailing triangle, summed), ``out``
  (L back to the row-major output); beside them, summed over panels,
  ``w0 factor`` (warp 0's factors alone) and ``w15 trailing`` (warp 15's
  share of the trailing updates); and ‖LLᵀ − A‖/‖A‖.
* ``llt_panel`` (``csrc/llt_panel.cu``, ``-DFAER_LLT_PANEL_PROFILE``) on
  slabs [A11; A21] (A11 = g gᵀ/b + I, A21 Gaussian, seed 1) at
  ``LLT_PANEL_CASES``. The kernel with ``faer_llt_panel_route`` (one launch,
  the rows over many CTAs) is read per CTA, each case with its route and
  CTAs, also with its rows forced into global memory
  (``faer_llt_panel_profile_force_global``) where they fit shared memory:
  ``init`` (A's rows staged, the flags zeroed, the one grid barrier, tile
  0), ``wait`` (the spins on the sub-blocks' flags), ``copy`` (each
  sub-block's published row block into shared memory), the owner of the
  next diagonal tile's lookahead: ``look solve`` (the tile's rows' column
  block) and ``look tile`` (that block's products taken from the tile);
  ``factor`` (warp 0 factors the tile), ``publish`` (its stores and the
  flag), ``rows`` (the other rows' blocks), ``ahead`` (each later
  diagonal tile of the CTA takes the step's column block, and the next
  lookahead's chain is formed up to its last block), ``out`` (the rows to
  the output); and, beside them, inside every row block ``chains`` (the
  FMA chains) and ``substitutions``. The two-launch kernel before it is read
  per call: ``stage`` (A11 into the output), ``tile factors``, ``row
  solves`` and ``trailing updates`` of the one-CTA factor, ``inverse`` (X =
  inv(L11)), the one-CTA launch's µs by the global timer, and the L21
  launch's cycles per CTA and CTAs. Both with ‖L11 L11ᵀ − A11‖/‖A11‖ and
  ‖L21 L11ᵀ − A21‖/‖A21‖.
* ``trtri`` (``csrc/trtri.cu``, ``-DFAER_TRTRI_PROFILE``), per CTA, on one
  block at n in {32, 100, 128} (the Cholesky factor of g gᵀ/n + I, seed 1)
  and on the 32 diagonal blocks of a 4096 triangle in one launch:
  ``stage`` (the block into shared memory and the first barrier),
  ``diagonal`` (the 16 × 16 sub-block substitutions), ``w=16``, ``w=32``,
  ``w=64`` (the combine levels, two products each), ``out`` (the inverse to
  its slot, thread 0's own stores); and the largest difference from
  ``trtri_plain`` relative to max|L⁻¹|.
* ``qr`` (``csrc/qr_panel.cu``, ``-DFAER_QR_PROFILE``), per CTA, on
  Gaussian panels (seed 1) at (128, 128), (1000, 128), (4096, 128) (the
  cluster route), the same three on the grid route (forced by the profile
  build's ``faer_qr_panel_profile_force_grid``, to time what the cluster
  saves) and (4096, 256), (8192, 128), (65536, 128) (the grid route), each
  with its route and CTAs: ``stage`` (the rows in, and the
  first barrier), ``exchange wait`` (the cluster or grid barrier, summed
  over columns), ``reflector`` (the shares summed over the CTAs, β, τ, τw,
  column j made v), ``update`` (the pass that applies the reflector and
  forms the next shares), ``partials`` (the warps' shares added and
  published), ``out`` (the last barrier, the rows out); and the largest
  difference from ``qr_panel_onepass_plain`` relative to max|packed|.
* ``lu`` (``csrc/lu_panel_batched.cu``, ``-DFAER_LU_PROFILE``), per CTA, on
  Gaussian panels (seed 1) at ``LU_CASES``: (4096, 256), (2048, 256) and
  (1024, 256) on the route the kernel picks and with the grid route forced
  (``faer_lu_panel_profile_force_grid``), both routes at the cluster
  route's edge (6144, 256), then (8192, 256), (8192, 64), (65536, 256) and
  (200000, 256) (W in global memory) on the grid route, each with its route
  and CTAs: ``stage`` (the rows in), ``local search`` (each CTA's argmax
  and its publication), ``exchange wait`` (the cluster or grid barrier),
  ``reduction+pivot row`` (the CTAs' candidates reduced, the pivot row
  read), ``scale+rank-1`` (the multipliers and the update of the working
  columns), ``deferred update`` (the sub-block's U₁₂ and its rank-``sb``
  update of the later columns), ``final write`` (the rows out in packed
  order); and ‖A[perm] − LU‖/‖A‖. A checkout whose kernel has no
  ``faer_lu_panel_route`` (the one-grid kernel before the cluster route)
  is driven through its own entry points, on the route it picks only.

* ``lu_swap`` (``csrc/lu_panel_swap.cu``, ``-DFAER_LU_SWAP_PROFILE``), per
  CTA, on Gaussian panels (seed 1) at ``LU_SWAP_CASES``: (4096, 128) and
  (1000, 100) (the cluster route), (4096, 256) (the grid route) and
  (40000, 256) (the grid route, rows in global memory), each with its route
  and CTAs: ``stage`` (the rows in), ``local+push`` (each CTA's candidate
  and its row published), ``exchange wait`` (the cluster or grid barrier),
  ``pivot`` (the candidates reduced, the pivot row at hand), ``pivot row
  out``, ``update`` (multipliers, rank-1 update, next candidates), ``final
  write``; and whether packed equals ``lu_panel_swap_plain``'s to the bit.

* ``chase`` (``csrc/band_chase.cu``, ``-DFAER_CHASE_PROFILE``), per CTA and
  step, on Gaussian strips (seed 1) at ``CHASE_PROFILE_CASES``: (64, 1, 256)
  and (128, 1, 256), the chase lab's chains, on clusters of several sizes
  (the plan's and others, each on the route its columns fit), (128, 8, 24),
  the largest b whose strip a cluster holds in shared memory and the next
  (global route), and (1024, 1, 8), each with its route, CTAs a cluster and
  columns a CTA, as thread 0 (warp 0) sees them: ``stage`` (the strip's
  columns in, the first Householder, the first cluster barrier; per launch,
  spread over the steps), ``matvec`` (the partial sums of W v),
  ``push`` (their stores into every CTA), ``exchange wait`` (until every
  partial sum of the step has arrived), ``u+gamma`` (the partials added,
  one block barrier, γ), ``x0+Householder`` (warp 0's update of the
  column-0 copy and the next step's τ and v), ``update`` (the wait for
  warps 1.. to finish the rank-2 update, one block barrier), ``out`` (the
  last cluster barrier, the columns out); and the largest difference from
  ``chase_probe_plain`` relative to the largest entry (held to 8·2b·eps at
  24 steps or fewer).

* ``real_schur`` (``csrc/real_schur.cu``) and ``complex_schur``
  (``csrc/complex_schur.cu``), both ``-DFAER_SCHUR_PROFILE``, per CTA, on
  Gaussian Hessenberg problems (seed 1) at ``SCHUR_PROFILE_CASES``: the
  multishift driver's AED windows 48 and 96 in both of the kernel's
  dtypes, both sides of each dtype's shared-memory edge (by bisection over
  the kernel's route) and a batch of 16 windows of 48, each with its
  route: ``stage`` (H and Q into shared memory, ‖H‖), ``deflation`` (the
  negligible pass and lo a step of the iteration, and the real kernel's
  2×2 standardizations), ``shift`` (the shifts, and the real kernel's
  sweep start), ``row phase`` and ``column phase`` (the chase steps' two
  halves, summed), ``out``; the iterations and chase steps, the cycles a
  chase step, and whether T, Q and the counts equal the plain version's
  (run on the host) to the bit.

* ``complex_hess_tri`` (``csrc/complex_hess_tri.cu``, ``-DFAER_CHT_PROFILE``)
  and ``complex_qz`` (``csrc/complex_qz.cu``, ``-DFAER_CQZ_PROFILE``), per
  CTA, on complex Gaussian pencils (seed 1; the QR of B and Q₀ᴴA in
  float64 first, and for ``complex_qz`` the kernel's own reduction) at
  ``SCHUR_PROFILE_CASES`` in complex64 and complex128, each with its route:
  for the chain ``stage`` (the four matrices into shared memory), ``row
  phase`` and ``column phase`` (each Givens pair's two halves, summed),
  ``out``, and the Givens pairs; for the QZ the ``real_schur`` mode's
  phases (``deflation``, ``shift``, ``row phase``, ``column phase``) and
  the iterations and chase steps; and whether the outputs equal the plain
  version's (run on the host) to the bit.

ROOT (default: this checkout) names the checkout whose kernel source is
built, so that one chip call profiles a parent unpacked beside this one
(for ``chase``, a kernel with the ``FAER_CHASE_PROFILE`` marks).

The marks cost a few cycles each; the phase shares, not the totals, are
what this reads. Prints the card's name and power limit first. Exits
non-zero without a card or ``nvcc``.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
SEED = 1
REPS = 20


def _llt_cases(lib, gen):
    """(label, launch, CTAs a launch, check) at each b."""
    tallies = torch.empty(8, dtype=torch.uint8, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    for b in (128, 256, 512, 1024):
        g = torch.randn(b, b, generator=gen, device="cuda")
        a = g @ g.T / b + 2 * torch.eye(b, device="cuda")
        out = torch.empty(b, b, device="cuda")

        def check(a=a, out=out):
            l64, a64 = out.double(), a.double()
            r = torch.linalg.matrix_norm(l64 @ l64.T - a64) / torch.linalg.matrix_norm(a64)
            return f"|LL^T-A|/|A| {r.item():.3e}"

        yield (f"b={b}",
               lambda a=a, out=out, b=b: lib.faer_llt_block(
                   a.data_ptr(), b, out.data_ptr(), tallies.data_ptr(), b, 0.0, 0.0, 0,
                   stream),
               1, check)


def _trtri_cases(lib, gen):
    """(label, launch, CTAs a launch, check) for one block and a batch."""
    from faer_tpu_torch.ops.kernels.trtri import MAX_N, trtri_batched_plain

    stream = torch.cuda.current_stream().cuda_stream

    def lower(n):
        g = torch.randn(n, n, generator=gen, device="cuda")
        return torch.linalg.cholesky(g @ g.T / n + torch.eye(n, device="cuda"))

    cases = [(f"n={n}", lower(n), [(0, n)]) for n in (32, 100, 128)]
    cases.append(("32 blocks of a 4096 triangle", lower(4096),
                  [(o, 128) for o in range(0, 4096, 128)]))
    for label, lo, blocks in cases:
        out = torch.empty(len(blocks), MAX_N, MAX_N, device="cuda")
        flat = (ctypes.c_int * (2 * len(blocks)))(*(v for blk in blocks for v in blk))

        def check(lo=lo, blocks=blocks, out=out):
            want = trtri_batched_plain(lo, blocks)
            rel = (out - want).abs().max() / want.abs().max()
            return f"max|X - plain|/max|plain| {rel.item():.3e}"

        yield (label,
               lambda lo=lo, flat=flat, k=len(blocks), out=out: lib.faer_trtri_batched(
                   lo.data_ptr(), lo.stride(0), lo.stride(1), flat, k, out.data_ptr(),
                   MAX_N, 0, stream),
               len(blocks), check)


# (m, b, grid route forced)
QR_CASES = ((128, 128, False), (1000, 128, False), (4096, 128, False), (128, 128, True),
            (1000, 128, True), (4096, 128, True), (4096, 256, False), (8192, 128, False),
            (65536, 128, False))


def _qr_cases(lib, gen):
    """(label, launch, CTAs a launch, check) at each shape."""
    from faer_tpu_torch.ops.kernels.qr_panel import ROUTES, qr_panel_onepass_plain

    stream = torch.cuda.current_stream().cuda_stream
    route = lib.faer_qr_panel_route
    route.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    force_grid = lib.faer_qr_panel_profile_force_grid
    force_grid.argtypes = [ctypes.c_int]
    for m, b, forced in QR_CASES:
        # the profile library's own plan, which the forced grid changes
        force_grid(forced)
        c_ctas, c_scratch = ctypes.c_int(), ctypes.c_longlong()
        name = ROUTES[route(m, b, ctypes.byref(c_ctas), ctypes.byref(c_scratch))]
        name += " (forced)" if forced else ""
        ctas, nscratch = c_ctas.value, c_scratch.value
        a = torch.randn(m, b, generator=gen, device="cuda")
        out = torch.empty(m, b, device="cuda")
        taus = torch.empty(min(m, b), device="cuda")
        scratch = torch.empty(max(nscratch, 1), device="cuda")

        def check(a=a, out=out):
            want = qr_panel_onepass_plain(a)[0]
            rel = (out - want).abs().max() / want.abs().max()
            return f"max|packed - one-pass plain|/max|plain| {rel.item():.3e}"

        def launch(a=a, out=out, taus=taus, scratch=scratch, n=nscratch, m=m, b=b,
                   forced=forced):
            force_grid(forced)
            return lib.faer_qr_panel(a.data_ptr(), b, out.data_ptr(), taus.data_ptr(),
                                     scratch.data_ptr(), n, m, b, stream)

        yield f"({m}, {b}) {name}, {ctas} CTAs", launch, ctas, check
    force_grid(False)


# (m, b, grid route forced)
LU_CASES = ((4096, 256, 0), (4096, 256, 1), (2048, 256, 0), (2048, 256, 1), (1024, 256, 0),
            (1024, 256, 1), (6144, 256, 0), (6144, 256, 1), (8192, 256, 0), (8192, 64, 0),
            (65536, 256, 0), (200000, 256, 0))


def _lu_cases(lib, gen):
    """(label, launch, CTAs a launch, check) at each shape, through the
    kernel's route entry, or through the one-grid kernel's entry points
    when the library has no ``faer_lu_panel_route``."""
    from faer_tpu_torch.ops.kernels.lu_panel import _assemble

    stream = torch.cuda.current_stream().cuda_stream
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    routed = hasattr(lib, "faer_lu_panel_route")
    if routed:
        lib.faer_lu_panel_route.argtypes = [I, I, I, P, P]
        lib.faer_lu_panel_profile_force_grid.argtypes = [I]
    else:  # the one-grid kernel's own argument lists
        lib.faer_lu_panel_batched_grid.argtypes = [I, I, I, I, P, P]
        lib.faer_lu_panel_batched.argtypes = [P, L, I, P, P, P, P, P, P, I, I, I, I, I, P]

    def rec(a, packed, perm):
        m, b = a.shape
        lo = torch.tril(packed, -1) + torch.eye(m, b, device="cuda")
        r = (torch.linalg.matrix_norm(lo @ torch.triu(packed[:b]) - a[perm])
             / torch.linalg.matrix_norm(a))
        return f"|A[perm]-LU|/|A| {r.item():.3e}"

    for m, b, forced in LU_CASES:
        a = torch.randn(m, b, generator=gen, device="cuda")
        ok = torch.empty(1, dtype=torch.int32, device="cuda")
        if routed:
            lib.faer_lu_panel_profile_force_grid(forced)
            c_ctas, c_scratch = ctypes.c_int(), ctypes.c_longlong()
            code = lib.faer_lu_panel_route(1, m, b, ctypes.byref(c_ctas),
                                           ctypes.byref(c_scratch))
            name = ({1: "cluster", 0: "grid", 2: "grid, W in global memory"}[code]
                    + (" (forced)" if forced else ""))
            ctas, nscratch = c_ctas.value, c_scratch.value
            packed = torch.empty(m, b, device="cuda")
            perm = torch.empty(m, dtype=torch.long, device="cuda")
            nt = torch.empty(1, dtype=torch.int32, device="cuda")
            okb = torch.empty(1, dtype=torch.bool, device="cuda")
            scratch = torch.empty(nscratch, device="cuda")

            def launch(a=a, packed=packed, perm=perm, nt=nt, okb=okb, scratch=scratch,
                       n=nscratch, m=m, b=b, forced=forced):
                lib.faer_lu_panel_profile_force_grid(forced)
                return lib.faer_lu_panel_batched(
                    a.data_ptr(), m * b, b, packed.data_ptr(), perm.data_ptr(),
                    nt.data_ptr(), okb.data_ptr(), scratch.data_ptr(), n, 1, m, b, stream)

            def check(a=a, packed=packed, perm=perm):
                return rec(a, packed, perm)
        else:
            if forced:
                continue
            name = "grid"
            c_ctas, c_rpc = ctypes.c_int(), ctypes.c_int()
            lib.faer_lu_panel_batched_grid(1, m, b, 8, ctypes.byref(c_ctas),
                                           ctypes.byref(c_rpc))
            ctas, rpc = c_ctas.value, c_rpc.value
            virt = torch.empty(m, b, device="cuda")
            pidx = torch.empty(b, dtype=torch.int32, device="cuda")
            cand_val = torch.empty(2 * ctas, device="cuda")
            cand_idx = torch.empty(2 * ctas, dtype=torch.int32, device="cuda")
            cand_row = torch.empty(2 * ctas, b, device="cuda")

            def launch(a=a, virt=virt, pidx=pidx, cv=cand_val, ci=cand_idx, cr=cand_row,
                       m=m, b=b, ctas=ctas, rpc=rpc):
                return lib.faer_lu_panel_batched(
                    a.data_ptr(), m * b, b, virt.data_ptr(), pidx.data_ptr(), ok.data_ptr(),
                    cv.data_ptr(), ci.data_ptr(), cr.data_ptr(), 1, m, b, ctas, rpc, stream)

            def check(a=a, virt=virt, pidx=pidx, b=b):
                packed, perm, _, _ = _assemble(virt, pidx[:b].long(), ok[0] != 0)
                return rec(a, packed, perm)

        yield f"({m}, {b}) {name}, {ctas} CTAs", launch, ctas, check
    if routed:
        lib.faer_lu_panel_profile_force_grid(0)


LU_SWAP_CASES = ((4096, 128), (1000, 100), (4096, 256), (40000, 256))


def _lu_swap_cases(lib, gen):
    """(label, launch, CTAs a launch, check) at each shape, on the route the
    kernel picks."""
    from faer_tpu_torch.ops.kernels.lu_panel_swap import ROUTES, lu_panel_swap_plain

    stream = torch.cuda.current_stream().cuda_stream
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.faer_lu_panel_swap_route.argtypes = [I, I, P, P]
    for m, b in LU_SWAP_CASES:
        a = torch.randn(m, b, generator=gen, device="cuda")
        c_ctas, c_scratch = ctypes.c_int(), ctypes.c_longlong()
        code = lib.faer_lu_panel_swap_route(m, b, ctypes.byref(c_ctas), ctypes.byref(c_scratch))
        packed = torch.empty(m, b, device="cuda")
        perm = torch.empty(m, dtype=torch.long, device="cuda")
        nt = torch.empty(1, dtype=torch.int32, device="cuda")
        ok = torch.empty(1, dtype=torch.bool, device="cuda")
        scratch = torch.empty(max(c_scratch.value, 1), device="cuda")

        def launch(a=a, packed=packed, perm=perm, nt=nt, ok=ok, scratch=scratch,
                   n=c_scratch.value, m=m, b=b):
            return lib.faer_lu_panel_swap(a.data_ptr(), b, packed.data_ptr(), perm.data_ptr(),
                                          nt.data_ptr(), ok.data_ptr(), scratch.data_ptr(), n,
                                          m, b, stream)

        def check(a=a, packed=packed, perm=perm):
            k2, p2, _, _ = lu_panel_swap_plain(a)
            return (f"packed and perm equal to the plain version's to the bit "
                    f"{torch.equal(packed, k2) and torch.equal(perm, p2)}")

        yield f"({m}, {b}) {ROUTES[code]}, {c_ctas.value} CTAs", launch, c_ctas.value, check


CHASE_LABELS = ("stage", "matvec", "push", "exchange wait", "u+gamma", "x0+Householder",
                "update", "out")
# (b, g, steps, CTAs of a cluster or None for the plan's)
CHASE_PROFILE_CASES = ((64, 1, 256, 1), (64, 1, 256, 2), (64, 1, 256, None), (64, 1, 256, 8),
                       (128, 1, 256, 4), (128, 1, 256, None), (128, 1, 256, 16),
                       (128, 8, 24, None), (128, 8, 24, 16), ("edge", 1, 24, None),
                       ("edge+1", 1, 24, None), (1024, 1, 8, None))


def _chase_cases(lib, gen):
    """(label, launch, CTA steps a launch, check) at each case: the plan
    the wrapper makes, or the strip's columns over the CTAs named, on the
    shared route where they fit and the global one else."""
    from faer_tpu_torch.ops.kernels import band_chase as bc

    stream = torch.cuda.current_stream().cuda_stream
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.faer_chase_device.argtypes = [P, P]
    smem_max, max_cluster = ctypes.c_int(), ctypes.c_int()
    if lib.faer_chase_device(ctypes.byref(smem_max), ctypes.byref(max_cluster)):
        sys.exit("faer_chase_device failed")
    facts = (smem_max.value, max_cluster.value)
    edge = bc.shared_edge(*facts)
    eps = float(torch.finfo(torch.float32).eps)
    for b, g, steps, ctas in CHASE_PROFILE_CASES:
        b = {"edge": edge, "edge+1": edge + 1}.get(b, b)
        p = bc.plan(b, g, *facts)
        if ctas is not None:
            ctas, cw = bc._split(b, ctas)
            shared = bc.smem_bytes(b, cw, True) <= facts[0]
            p = bc.Plan("cluster, strip in shared memory" if shared
                        else "cluster, strip in global memory", ctas, cw,
                        0 if shared else g * 4 * b * ctas * cw)
        band = torch.randn(g * 4 * b, 2 * b, generator=gen, device="cuda")
        out = torch.empty_like(band)
        scratch = torch.empty(max(p.scratch, 4), device="cuda")

        def launch(band=band, out=out, scratch=scratch, p=p, b=b, g=g, steps=steps):
            return lib.faer_chase_probe(band.data_ptr(), out.data_ptr(), scratch.data_ptr(),
                                        p.scratch, b, steps, g, p.ctas, p.cw,
                                        bc.ROUTES[p.route], stream)

        def check(band=band, out=out, b=b, g=g, steps=steps):
            want = bc.chase_probe_plain(band, b=b, steps=steps, g=g)
            top = want.abs().max().item()
            rel = (out - want).abs().max().item() / max(top, 1e-30)
            held = (f"<= {8 * 2 * b * eps:.3e}: {rel <= 8 * 2 * b * eps}" if steps <= 24
                    else "(not held: the values grow with the steps)")
            return f"max|out - plain| / max|plain| {rel:.3e} {held}"

        yield (f"b={b} g={g} steps={steps} [{p.route}], {p.ctas} CTAs of {p.cw} columns",
               launch, p.ctas * g * max(steps, 1), check)


LLT_PANEL_CASES = ((4096, 256), (1024, 256), (256, 256), (4096, 512), (16896, 256), (65536, 256))
# the counters of the one-launch kernel and of the two-launch one before it
LLT_PANEL_LABELS = ("init", "wait", "copy", "look solve", "look tile", "factor", "publish",
                    "rows", "ahead", "out", "chains", "substitutions")
LLT_PANEL_PARENT_LABELS = ("stage", "tile factors", "row solves", "trailing updates",
                           "inverse", "L21 cycles per CTA", "L21 CTAs", "one-CTA us")


def _llt_panel_slab(m, b, gen):
    g = torch.randn(b, b, generator=gen, device="cuda")
    a11 = g @ g.T / b + torch.eye(b, device="cuda")
    return torch.cat([a11, torch.randn(m - b, b, generator=gen, device="cuda")])


def _llt_panel_check(a, out):
    b = a.shape[1]
    l11 = out[:b].double()
    r11 = torch.linalg.matrix_norm(l11 @ l11.T - a[:b].double()) / torch.linalg.matrix_norm(
        a[:b].double())
    text = f"|L11 L11^T-A11|/|A11| {r11.item():.3e}"
    if a.shape[0] > b:
        a21 = a[b:].double()
        r21 = torch.linalg.matrix_norm(out[b:].double() @ l11.T - a21) / torch.linalg.matrix_norm(a21)
        text += f", |L21 L11^T-A21|/|A21| {r21.item():.3e}"
    return text


def _llt_panel_cases(lib, gen):
    """(label, launch, CTAs a launch, check) at each shape: through the
    kernel's route entry, or through the two-launch kernel's entry when the
    library has no ``faer_llt_panel_route`` (one CTA, its counters per call)."""
    stream = torch.cuda.current_stream().cuda_stream
    P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    routed = hasattr(lib, "faer_llt_panel_route")
    if routed:
        lib.faer_llt_panel_route.argtypes = [I, I, P, P, P]
        lib.faer_llt_panel_profile_force_global.argtypes = [I]
    else:  # the two-launch kernel's own argument list
        lib.faer_llt_panel.argtypes = [P, I, P, P, P, I, I, F, F, P]
    cnt_ok = torch.empty(2, dtype=torch.int32, device="cuda")
    for m, b in LLT_PANEL_CASES:
        a = _llt_panel_slab(m, b, gen)
        out = torch.empty(m, b, device="cuda")
        if not routed:
            xinv = torch.empty(b, b, device="cuda")
            yield (f"({m}, {b}) two launches",
                   lambda a=a, out=out, xinv=xinv, m=m, b=b: lib.faer_llt_panel(
                       a.data_ptr(), b, out.data_ptr(), xinv.data_ptr(), cnt_ok.data_ptr(),
                       m, b, 0.0, 0.0, stream),
                   1, lambda a=a, out=out: _llt_panel_check(a, out))
            continue
        for forced in (0, 1):
            c_ctas, c_rpc, c_scratch = ctypes.c_int(), ctypes.c_int(), ctypes.c_longlong()
            lib.faer_llt_panel_profile_force_global(0)
            if forced and lib.faer_llt_panel_route(m, b, None, None, None) != 1:
                continue  # the rows are in global memory anyway
            lib.faer_llt_panel_profile_force_global(forced)
            code = lib.faer_llt_panel_route(m, b, ctypes.byref(c_ctas), ctypes.byref(c_rpc),
                                            ctypes.byref(c_scratch))
            name = {1: "rows in shared memory", 0: "rows in global memory"}[code]
            name += " (forced)" if forced else ""
            scratch = torch.empty(c_scratch.value, device="cuda")

            def launch(a=a, out=out, scratch=scratch, n=c_scratch.value, m=m, b=b,
                       forced=forced):
                lib.faer_llt_panel_profile_force_global(forced)
                return lib.faer_llt_panel(a.data_ptr(), b, out.data_ptr(), scratch.data_ptr(),
                                          n, cnt_ok.data_ptr(), m, b, 0.0, 0.0, stream)

            yield (f"({m}, {b}) {name}, {c_ctas.value} CTAs of {c_rpc.value} rows", launch,
                   c_ctas.value, lambda a=a, out=out: _llt_panel_check(a, out))
    if routed:
        lib.faer_llt_panel_profile_force_global(0)


SCHUR_LABELS = ("stage", "deflation", "shift", "row phase", "column phase", "out")
# (n, batch) in each dtype; "edge" and "edge+1": both sides of the
# kernel's shared-memory edge
SCHUR_PROFILE_CASES = ((48, 1), (96, 1), ("edge", 1), ("edge+1", 1), (48, 16))


def _schur_cases(kind):
    """The cases of the ``real_schur`` or ``complex_schur`` mode: (label,
    launch, CTAs a launch, check) at each of SCHUR_PROFILE_CASES in both
    dtypes, on the route the kernel picks."""

    def cases(lib, gen):
        from faer_tpu_torch.ops.kernels import _build
        from faer_tpu_torch.ops.kernels import complex_schur as kcs
        from faer_tpu_torch.ops.kernels import real_schur as krs

        mod = krs if kind == "real_schur" else kcs
        dtypes = ((torch.float32, ""), (torch.float64, "_f64")) if kind == "real_schur" else \
            ((torch.complex64, ""), (torch.complex128, "_c128"))
        stream = torch.cuda.current_stream().cuda_stream
        for dt, suffix in dtypes:
            route = getattr(lib, f"faer_{kind}_route{suffix}")
            route.argtypes = [ctypes.c_int]
            entry = getattr(lib, f"faer_{kind}_batched{suffix}")
            entry.argtypes = _build._SIGNATURES[f"faer_{kind}_batched{suffix}"]
            edge = _build.shared_edge(
                lambda n, _dt: {0: "shared", 1: "global"}.get(route(n), "refused"), dt,
                mod.MAX_N)
            for n, batch in SCHUR_PROFILE_CASES:
                n = {"edge": edge, "edge+1": edge + 1}.get(n, n)
                h = torch.triu(torch.randn(batch, n, n, generator=gen, device="cuda",
                                           dtype=torch.float64), -1)
                if dt.is_complex:
                    h = torch.complex(h, torch.triu(torch.randn(
                        batch, n, n, generator=gen, device="cuda", dtype=torch.float64), -1))
                h = h.to(dt)
                q = torch.eye(n, device="cuda", dtype=dt).repeat(batch, 1, 1)
                sizes = torch.full((batch,), n, dtype=torch.int32, device="cuda")
                t, qo = h.clone(), q.clone()
                info = torch.empty((batch, 3), dtype=torch.int32, device="cuda")

                def launch(h=h, q=q, t=t, qo=qo, info=info, sizes=sizes, n=n, batch=batch,
                           entry=entry):
                    t.copy_(h)
                    qo.copy_(q)
                    return entry(t.data_ptr(), qo.data_ptr(), sizes.data_ptr(),
                                 info.data_ptr(), batch, n, 30, stream)

                def check(h=h, q=q, t=t, qo=qo, info=info, sizes=sizes):
                    launch()
                    torch.cuda.synchronize()
                    plain = getattr(mod, f"{kind}_batched_plain")
                    want = plain(h.cpu(), q.cpu(), sizes.cpu())
                    got = (t.cpu(), qo.cpu(), info[:, 0].cpu(), info[:, 1].cpu() != 0,
                           info[:, 2].cpu())
                    same = all(torch.equal(g, w) for g, w in zip(got, want))
                    its, steps = int(info[:, 0].sum()), int(info[:, 2].sum())
                    return (f"{its} iterations, {steps} chase steps in all; equal to the "
                            f"plain version to the bit: {same}")

                where = "shared" if route(n) == 0 else "global"
                yield (f"n={n} B={batch} {str(dt).split('.')[-1]} [H and Q in {where} "
                       f"memory]", launch, batch, check)

    return cases


CHT_LABELS = ("stage", "row phase", "column phase", "out")


def _pencil_cases(kind):
    """The cases of the ``complex_hess_tri`` or ``complex_qz`` mode: (label,
    launch, CTAs a launch, check) at each of SCHUR_PROFILE_CASES in
    complex64 and complex128, on the route the kernel picks."""

    def cases(lib, gen):
        from faer_tpu_torch.ops.kernels import _build
        from faer_tpu_torch.ops.kernels import complex_qz as kcq

        stream = torch.cuda.current_stream().cuda_stream
        for dt, suffix in ((torch.complex64, ""), (torch.complex128, "_c128")):
            route = getattr(lib, f"faer_{kind}_route{suffix}")
            route.argtypes = [ctypes.c_int]
            entry = getattr(lib, f"faer_{kind}_batched{suffix}")
            entry.argtypes = _build._SIGNATURES[f"faer_{kind}_batched{suffix}"]
            edge = _build.shared_edge(
                lambda n, _dt: {0: "shared", 1: "global"}.get(route(n), "refused"), dt,
                kcq.MAX_N)
            for n, batch in SCHUR_PROFILE_CASES:
                n = {"edge": edge, "edge+1": edge + 1}.get(n, n)
                a, b = (torch.complex(*(torch.randn(batch, n, n, generator=gen, device="cuda",
                                                    dtype=torch.float64) for _ in range(2)))
                        for _ in range(2))
                q0, r0 = torch.linalg.qr(b)
                eye = torch.eye(n, device="cuda", dtype=torch.complex128).repeat(batch, 1, 1)
                mats = [x.to(dt).contiguous() for x in (q0.mH @ a, torch.triu(r0), q0, eye)]
                sizes = torch.full((batch,), n, dtype=torch.int32, device="cuda")
                if kind == "complex_qz":
                    mats = list(kcq.complex_hess_tri_batched(*mats, sizes))
                work = [x.clone() for x in mats]
                info = torch.empty((batch, 3), dtype=torch.int32, device="cuda")

                def launch(mats=mats, work=work, info=info, sizes=sizes, n=n, batch=batch,
                           entry=entry):
                    for w, m in zip(work, mats):
                        w.copy_(m.transpose(1, 2) if w is work[2] or w is work[3] else m)
                    ptrs = [w.data_ptr() for w in work]
                    if kind == "complex_qz":
                        return entry(*ptrs, sizes.data_ptr(), info.data_ptr(), batch, n, 30,
                                     stream)
                    return entry(*ptrs, sizes.data_ptr(), batch, n, stream)

                def check(mats=mats, work=work, info=info, sizes=sizes, n=n, batch=batch):
                    launch()
                    torch.cuda.synchronize()
                    got = [work[0], work[1], work[2].transpose(1, 2), work[3].transpose(1, 2)]
                    got = [x.cpu() for x in got]
                    cpu = [x.cpu() for x in mats]
                    if kind == "complex_qz":
                        want = kcq.complex_qz_batched_plain(*cpu, sizes.cpu())
                        got += [info[:, 0].cpu(), info[:, 1].cpu() != 0, info[:, 2].cpu()]
                        its, steps = int(info[:, 0].sum()), int(info[:, 2].sum())
                        what = f"{its} iterations, {steps} chase steps in all"
                    else:
                        want = kcq.complex_hess_tri_batched_plain(*cpu, sizes.cpu())
                        what = f"{batch * (n - 1) * (n - 2) // 2} Givens pairs in all"
                    same = all(torch.equal(g, w) for g, w in zip(got, want))
                    return f"{what}; equal to the plain version to the bit: {same}"

                where = "shared" if route(n) == 0 else "global"
                yield (f"n={n} B={batch} {str(dt).split('.')[-1]} [the matrices in {where} "
                       f"memory]", launch, batch, check)

    return cases


# per kernel: source, macro, C entry, counter reader, the counters in order,
# the phases that sum to a total, its cases, and what the cycles are per
KERNELS = {
    "chase": dict(source="band_chase.cu", macro="FAER_CHASE_PROFILE", entry="faer_chase_probe",
                  read="faer_chase_profile_read",
                  labels=CHASE_LABELS, phases=CHASE_LABELS,
                  cases=_chase_cases, unit="CTA step"),
    "llt": dict(source="llt_block.cu", macro="FAER_LLT_PROFILE", entry="faer_llt_block",
                read="faer_llt_block_profile_read",
                labels=("stage", "first tile", "solve", "tile update", "factor+trailing",
                        "w0 factor", "w15 trailing", "out"),
                phases=("stage", "first tile", "solve", "tile update", "factor+trailing",
                        "out"),
                cases=_llt_cases, unit="call"),
    "llt_panel": dict(source="llt_panel.cu", macro="FAER_LLT_PANEL_PROFILE",
                      entry="faer_llt_panel", read="faer_llt_panel_profile_read",
                      labels=LLT_PANEL_LABELS, phases=LLT_PANEL_LABELS[:10],
                      parent=dict(labels=LLT_PANEL_PARENT_LABELS,
                                  phases=LLT_PANEL_PARENT_LABELS[:5], unit="call"),
                      cases=_llt_panel_cases, unit="CTA"),
    "lu": dict(source="lu_panel_batched.cu", macro="FAER_LU_PROFILE",
               entry="faer_lu_panel_batched", read="faer_lu_panel_profile_read",
               labels=("stage", "local search", "exchange wait", "reduction+pivot row",
                       "scale+rank-1", "deferred update", "final write"),
               phases=("stage", "local search", "exchange wait", "reduction+pivot row",
                       "scale+rank-1", "deferred update", "final write"),
               cases=_lu_cases, unit="CTA"),
    "lu_swap": dict(source="lu_panel_swap.cu", macro="FAER_LU_SWAP_PROFILE",
                    entry="faer_lu_panel_swap", read="faer_lu_panel_swap_profile_read",
                    labels=("stage", "local+push", "exchange wait", "pivot", "pivot row out",
                            "update", "final write"),
                    phases=("stage", "local+push", "exchange wait", "pivot", "pivot row out",
                            "update", "final write"),
                    cases=_lu_swap_cases, unit="CTA"),
    "qr": dict(source="qr_panel.cu", macro="FAER_QR_PROFILE", entry="faer_qr_panel",
               read="faer_qr_panel_profile_read",
               labels=("stage", "exchange wait", "reflector", "update", "partials", "out"),
               phases=("stage", "exchange wait", "reflector", "update", "partials", "out"),
               cases=_qr_cases, unit="CTA"),
    "real_schur": dict(source="real_schur.cu", macro="FAER_SCHUR_PROFILE",
                       entry="faer_real_schur_batched", read="faer_real_schur_profile_read",
                       labels=SCHUR_LABELS, phases=SCHUR_LABELS,
                       cases=_schur_cases("real_schur"), unit="CTA"),
    "complex_schur": dict(source="complex_schur.cu", macro="FAER_SCHUR_PROFILE",
                          entry="faer_complex_schur_batched",
                          read="faer_complex_schur_profile_read",
                          labels=SCHUR_LABELS, phases=SCHUR_LABELS,
                          cases=_schur_cases("complex_schur"), unit="CTA"),
    "complex_hess_tri": dict(source="complex_hess_tri.cu", macro="FAER_CHT_PROFILE",
                             entry="faer_complex_hess_tri_batched",
                             read="faer_complex_hess_tri_profile_read",
                             labels=CHT_LABELS, phases=CHT_LABELS,
                             cases=_pencil_cases("complex_hess_tri"), unit="CTA"),
    "complex_qz": dict(source="complex_qz.cu", macro="FAER_CQZ_PROFILE",
                       entry="faer_complex_qz_batched", read="faer_complex_qz_profile_read",
                       labels=SCHUR_LABELS, phases=SCHUR_LABELS,
                       cases=_pencil_cases("complex_qz"), unit="CTA"),
    "trtri": dict(source="trtri.cu", macro="FAER_TRTRI_PROFILE", entry="faer_trtri_batched",
                  read="faer_trtri_profile_read",
                  labels=("stage", "diagonal", "w=16", "w=32", "w=64", "out"),
                  phases=("stage", "diagonal", "w=16", "w=32", "w=64", "out"),
                  cases=_trtri_cases, unit="CTA"),
}


def profile_build(kernel: str, root: Path = ROOT) -> tuple[list[str], Path]:
    """The nvcc command that builds the kernel's source under ``root`` with
    its profile macro and ``_build``'s flags, and the library it writes
    under this checkout's ``build/``."""
    sys.path.insert(0, str(ROOT))
    from faer_tpu_torch.ops.kernels import _build

    spec = KERNELS[kernel]
    tag = "" if root == ROOT else f"_{root.name}"
    out_dir = ROOT / "build" / f"{kernel}_profile{tag}"
    out_dir.mkdir(parents=True, exist_ok=True)
    so = out_dir / f"{kernel}_profile.so"
    cmd = [_build._nvcc(), *_build.COMPILE_FLAGS, f"-D{spec['macro']}", "-shared", "-o",
           str(so), str(root / "faer_tpu_torch" / "csrc" / spec["source"])]
    return cmd, so


def load(kernel: str, so: Path) -> ctypes.CDLL:
    """A profile build of the kernel, its entry's and counter reader's
    argument types set."""
    from faer_tpu_torch.ops.kernels import _build

    spec = KERNELS[kernel]
    lib = ctypes.CDLL(str(so))
    if not hasattr(lib, spec["read"]):
        sys.exit(f"{so.name}: no {spec['read']}: this kernel source has no profile marks")
    getattr(lib, spec["entry"]).argtypes = _build._SIGNATURES[spec["entry"]]
    getattr(lib, spec["read"]).argtypes = [ctypes.c_void_p]
    return lib


def build(kernel: str, root: Path = ROOT) -> ctypes.CDLL:
    """The kernel's source under ``root`` built with its profile macro and
    ``_build``'s flags, into this checkout's ``build/``, and loaded."""
    cmd, so = profile_build(kernel, root)
    subprocess.run(cmd, check=True)
    return load(kernel, so)


def cycles(read, launch, ctas: int, n: int) -> tuple[list[float], float]:
    """Each counter's SM cycles per CTA over ``REPS`` launches, after one
    launch that warms up and resets them, and the ms a launch of the
    profile build takes (CUDA events around the ``REPS`` launches)."""
    counts = (ctypes.c_longlong * n)()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))

    def run(reps):
        start.record()
        for _ in range(reps):
            code = launch()
            if code:
                sys.exit(f"launch failed with CUDA error {code}")
        stop.record()
        torch.cuda.synchronize()
        if read(counts):
            sys.exit("reading the counters failed")

    run(1)
    run(REPS)
    return [c / (REPS * ctas) for c in counts], start.elapsed_time(stop) / REPS


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("kernel", choices=sorted(KERNELS))
    parser.add_argument("root", nargs="?", type=Path, default=ROOT,
                        help="the checkout whose kernel source is built (default: this one)")
    args = parser.parse_args()
    kernel, root = args.kernel, args.root.resolve()
    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is false: this script needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"nvidia-smi: {smi}")
    spec = KERNELS[kernel]
    lib = build(kernel, root)
    if kernel == "llt_panel" and not hasattr(lib, "faer_llt_panel_route"):
        spec = {**spec, **spec["parent"]}  # the two-launch kernel's counters
    read = getattr(lib, spec["read"])
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for label, launch, ctas, check in spec["cases"](lib, gen):
        counts, ms = cycles(read, launch, ctas, len(spec["labels"]))
        row = dict(zip(spec["labels"], counts))
        if "L21 CTAs" in row:  # the two-launch LLT panel's sums, made per CTA and in us
            row["L21 cycles per CTA"] /= max(row["L21 CTAs"], 1.0)
            row["one-CTA us"] /= 1000.0
        total = sum(row[k] for k in spec["phases"])
        rest = [k for k in spec["labels"] if k not in spec["phases"]]
        print(f"{label}: cycles per {spec['unit']} "
              + ", ".join(f"{k} {row[k]:.0f}" for k in spec["phases"])
              + f", total {total:.0f}; "
              + "".join(f"{k} {row[k]:.0f}; " for k in rest)
              + f"{ms:.4f} ms a launch; " + check())


if __name__ == "__main__":
    main()
