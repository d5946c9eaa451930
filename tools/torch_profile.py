"""Where the time of a hand-written kernel goes, on one CUDA card.

    python tools/torch_profile.py {llt,qr,trtri}

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


# per kernel: source, macro, C entry, counter reader, the counters in order,
# the phases that sum to a total, its cases, and what the cycles are per
KERNELS = {
    "llt": dict(source="llt_block.cu", macro="FAER_LLT_PROFILE", entry="faer_llt_block",
                read="faer_llt_block_profile_read",
                labels=("stage", "first tile", "solve", "tile update", "factor+trailing",
                        "w0 factor", "w15 trailing", "out"),
                phases=("stage", "first tile", "solve", "tile update", "factor+trailing",
                        "out"),
                cases=_llt_cases, unit="call"),
    "qr": dict(source="qr_panel.cu", macro="FAER_QR_PROFILE", entry="faer_qr_panel",
               read="faer_qr_panel_profile_read",
               labels=("stage", "exchange wait", "reflector", "update", "partials", "out"),
               phases=("stage", "exchange wait", "reflector", "update", "partials", "out"),
               cases=_qr_cases, unit="CTA"),
    "trtri": dict(source="trtri.cu", macro="FAER_TRTRI_PROFILE", entry="faer_trtri_batched",
                  read="faer_trtri_profile_read",
                  labels=("stage", "diagonal", "w=16", "w=32", "w=64", "out"),
                  phases=("stage", "diagonal", "w=16", "w=32", "w=64", "out"),
                  cases=_trtri_cases, unit="CTA"),
}


def build(kernel: str) -> ctypes.CDLL:
    """The kernel's source built with its profile macro, ``_build``'s flags."""
    sys.path.insert(0, str(ROOT))
    from faer_tpu_torch.ops.kernels import _build

    spec = KERNELS[kernel]
    out_dir = ROOT / "build" / f"{kernel}_profile"
    out_dir.mkdir(parents=True, exist_ok=True)
    so = out_dir / f"{kernel}_profile.so"
    subprocess.run([_build._nvcc(), *_build.COMPILE_FLAGS, f"-D{spec['macro']}",
                    "-shared", "-o", str(so), str(_build.CSRC / spec["source"])],
                   check=True)
    lib = ctypes.CDLL(str(so))
    getattr(lib, spec["entry"]).argtypes = _build._SIGNATURES[spec["entry"]]
    getattr(lib, spec["read"]).argtypes = [ctypes.c_void_p]
    return lib


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
    kernel = parser.parse_args().kernel
    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is false: this script needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"nvidia-smi: {smi}")
    spec = KERNELS[kernel]
    lib = build(kernel)
    read = getattr(lib, spec["read"])
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for label, launch, ctas, check in spec["cases"](lib, gen):
        counts, ms = cycles(read, launch, ctas, len(spec["labels"]))
        row = dict(zip(spec["labels"], counts))
        total = sum(row[k] for k in spec["phases"])
        rest = [k for k in spec["labels"] if k not in spec["phases"]]
        print(f"{label}: cycles per {spec['unit']} "
              + ", ".join(f"{k} {row[k]:.0f}" for k in spec["phases"])
              + f", total {total:.0f}; "
              + "".join(f"{k} {row[k]:.0f}; " for k in rest)
              + f"{ms:.4f} ms a launch; " + check())


if __name__ == "__main__":
    main()
