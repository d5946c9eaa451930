"""Where the time of the blocked LLT diagonal-block kernel goes, on one CUDA card.

    python tools/torch_llt_profile.py

Builds ``faer_tpu_torch/csrc/llt_block.cu`` with ``-DFAER_LLT_PROFILE``
(its ``clock64`` marks) into a library of its own under
``build/llt_profile/``, runs it 10 times on A = g gᵀ/b + 2I (seed 1) at b
in {128, 256, 512, 1024}, and prints the SM cycles per call of each phase,
as thread 0 sees them between block barriers:

* ``stage``: the block into shared memory (or L2) and the first barrier;
* ``first tile``: warp 0 factors the first diagonal tile;
* ``solve``: the substitution solve of every panel (summed over panels);
* ``tile update``: all threads update the next diagonal tile (summed);
* ``factor+trailing``: warp 0 factors it while warps 1..15 update the rest
  of the trailing triangle (summed);
* ``out``: L back to the row-major output.

Beside them, summed over panels, ``w0 factor`` (warp 0's factors alone)
and ``w15 trailing`` (warp 15's share of the trailing updates). Each line
also gives ‖LLᵀ − A‖/‖A‖. The marks cost a few cycles each; the phase
shares, not the totals, are what this reads. Prints the card's name and
power limit first. Exits non-zero without a card or ``nvcc``.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
OUT_DIR = ROOT / "build" / "llt_profile"
SEED = 1
REPS = 10
BLOCKS = (128, 256, 512, 1024)
# the kernel's g_prof counters, in order
LABELS = ("stage", "first tile", "solve", "tile update", "factor+trailing",
          "w0 factor", "w15 trailing", "out")
PHASES = ("stage", "first tile", "solve", "tile update", "factor+trailing", "out")


def build() -> ctypes.CDLL:
    sys.path.insert(0, str(ROOT))
    from faer_tpu_torch.ops.kernels import _build

    OUT_DIR.mkdir(parents=True, exist_ok=True)
    so = OUT_DIR / "llt_block_profile.so"
    subprocess.run([_build._nvcc(), *_build.COMPILE_FLAGS, "-DFAER_LLT_PROFILE",
                    "-shared", "-o", str(so), str(_build.CSRC / "llt_block.cu")],
                   check=True)
    lib = ctypes.CDLL(str(so))
    lib.faer_llt_block.argtypes = _build._SIGNATURES["faer_llt_block"]
    lib.faer_llt_block_profile_read.argtypes = [ctypes.c_void_p]
    return lib


def profile(lib, b: int, gen) -> dict:
    g = torch.randn(b, b, generator=gen, device="cuda")
    a = g @ g.T / b + 2 * torch.eye(b, device="cuda")
    out = torch.empty(b, b, device="cuda")
    tallies = torch.empty(8, dtype=torch.uint8, device="cuda")
    counts = (ctypes.c_longlong * 8)()
    stream = torch.cuda.current_stream().cuda_stream

    def run(n):
        for _ in range(n):
            code = lib.faer_llt_block(a.data_ptr(), b, out.data_ptr(), tallies.data_ptr(),
                                      b, 0.0, 0.0, 0, stream)
            if code:
                sys.exit(f"launch failed with CUDA error {code}")
        torch.cuda.synchronize()
        if lib.faer_llt_block_profile_read(counts):
            sys.exit("reading the counters failed")

    run(1)  # warm-up, counters reset
    run(REPS)
    l64, a64 = out.double(), a.double()
    resid = (torch.linalg.matrix_norm(l64 @ l64.T - a64) / torch.linalg.matrix_norm(a64)).item()
    return dict(b=b, resid=resid, **{k: counts[n] / REPS for n, k in enumerate(LABELS)})


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is false: this script needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"nvidia-smi: {smi}")
    lib = build()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for b in BLOCKS:
        row = profile(lib, b, gen)
        total = sum(row[k] for k in PHASES)
        print(f"b={b}: cycles per call " + ", ".join(
            f"{k} {row[k]:.0f}" for k in PHASES) + f", total {total:.0f}; "
            + ", ".join(f"{k} {row[k]:.0f}" for k in ("w0 factor", "w15 trailing"))
            + f"; |LL^T-A|/|A| {row['resid']:.3e}")


if __name__ == "__main__":
    main()
