"""Time the LU paths of one checkout of faer_tpu_torch on one CUDA card.

    python tools/torch_lu_timing.py [--repo DIR] [--label NAME]

Imports ``faer_tpu_torch`` from DIR (default: the checkout this script is
in), builds its kernels there, and prints one JSON line: the card's name and
power limit, and the median of 20 CUDA-event timings (5 for the 65536 ×
1024 factor), after 3 warm-up calls, of ``lu_panel`` on a Gaussian (4096, 256) panel (the fused route's
panel), ``lu_in_place`` at 4096² (the fused route) and ``lu_in_place`` at
65536 × 1024 with the default gate (the recursive route, whose 65536-row
leaves do not fit shared memory), all on inputs made on the card from seed
0. To compare two checkouts, run it for each in turns (A, B, B, A) on one
card, in one job. Exits non-zero without a card.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repo", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is false: this script needs a CUDA card")
    sys.path.insert(0, args.repo)
    from faer_tpu_torch import lu_in_place
    from faer_tpu_torch.ops.kernels.lu_panel import lu_panel

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    gen = torch.Generator(device="cuda").manual_seed(0)
    panel = torch.randn(4096, 256, generator=gen, device="cuda")
    square = torch.randn(4096, 4096, generator=gen, device="cuda")
    tall = torch.randn(65536, 1024, generator=gen, device="cuda")
    out = {
        "label": args.label, "device": smi,
        "lu_panel (4096, 256) ms": cuda_ms(lambda: lu_panel(panel)),
        "lu_in_place 4096x4096 ms": cuda_ms(lambda: lu_in_place(square)),
        "lu_in_place 65536x1024 ms": cuda_ms(lambda: lu_in_place(tall), reps=5),
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
