"""Where the time of a hand-written kernel goes, on one CUDA card.

    python tools/torch_profile.py {llt,trtri}

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


def cycles(read, launch, ctas: int, n: int) -> list[float]:
    """Each counter's SM cycles per CTA over ``REPS`` launches, after one
    launch that warms up and resets them."""
    counts = (ctypes.c_longlong * n)()

    def run(reps):
        for _ in range(reps):
            code = launch()
            if code:
                sys.exit(f"launch failed with CUDA error {code}")
        torch.cuda.synchronize()
        if read(counts):
            sys.exit("reading the counters failed")

    run(1)
    run(REPS)
    return [c / (REPS * ctas) for c in counts]


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
        row = dict(zip(spec["labels"], cycles(read, launch, ctas, len(spec["labels"]))))
        total = sum(row[k] for k in spec["phases"])
        rest = [k for k in spec["labels"] if k not in spec["phases"]]
        print(f"{label}: cycles per {spec['unit']} "
              + ", ".join(f"{k} {row[k]:.0f}" for k in spec["phases"])
              + f", total {total:.0f}; "
              + "".join(f"{k} {row[k]:.0f}; " for k in rest) + check())


if __name__ == "__main__":
    main()
