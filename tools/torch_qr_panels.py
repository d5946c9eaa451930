"""The QR panel lab of faer_tpu_torch on one CUDA card.

    python tools/torch_qr_panels.py [--reps N] [--warmup N]

The port's counterpart of ``tools/r5qr.py``'s ``panels`` section with
``tools/r4lab.py``'s QR check. On one Gaussian 4096² f32 matrix made on the
card from seed 11, for each (m, b) in {4096, 2048, 1024} × {128, 256, 512},
the panel ``g[:m, :b]`` (a strided view, as ``r5qr.py`` slices it) goes
through each QR panel wrapper of the port: ``qr_panel`` (v5),
``qr_panel_v1``, ``qr_panel_v2``, ``qr_panel_v3`` and ``qr_leaf`` at sb 8
and 16. For each it prints the median of ``--reps`` CUDA-event timings
after ``--warmup`` calls; ‖QR − A‖/‖A‖ in f64, with Q = H_0 ⋯ H_{k−1}
applied to [R; 0] in the order ``r5qr.py:37-50`` forms it; and the largest
difference of the packed panel and of τ from ``qr_panel``'s. Each wrapper
is called 1 + warmup + reps times a shape (:func:`calls_per_shape`), which
is what its launch counter must read after :func:`panel_lab`. The last line
is one JSON object with the card's name and power limit and every row.
Exits non-zero without a card, or if a residual exceeds 8·m·eps_f32.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

SEED = 11  # r5qr.py's seed; torch's generator gives other numbers from it
N = 4096
SHAPES = tuple((m, b) for m in (4096, 2048, 1024) for b in (128, 256, 512))
EPS32 = float(torch.finfo(torch.float32).eps)


def _panels():
    """(label, launch counter, call) of each panel, ``qr_panel`` first."""
    from faer_tpu_torch.ops.kernels.leaf import qr_leaf
    from faer_tpu_torch.ops.kernels.qr_panel import qr_panel
    from faer_tpu_torch.ops.kernels.qr_panel_v1 import qr_panel_v1
    from faer_tpu_torch.ops.kernels.qr_panel_v2 import qr_panel_v2
    from faer_tpu_torch.ops.kernels.qr_panel_v3 import qr_panel_v3

    return (("qr_panel (v5)", "qr_panel", qr_panel),
            ("qr_panel_v1", "qr_panel_v1", qr_panel_v1),
            ("qr_panel_v2", "qr_panel_v2", qr_panel_v2),
            ("qr_panel_v3", "qr_panel_v3", qr_panel_v3),
            ("qr_leaf sb=8", "qr_leaf", lambda x: qr_leaf(x, sb=8)),
            ("qr_leaf sb=16", "qr_leaf", lambda x: qr_leaf(x, sb=16)))


def calls_per_shape(reps: int, warmup: int) -> dict[str, int]:
    """Launches of each counter per shape in :func:`panel_lab`: one checked
    call, ``warmup`` and ``reps`` timed ones, for each panel using it."""
    out: dict[str, int] = {}
    for _, counter, _ in _panels():
        out[counter] = out.get(counter, 0) + 1 + warmup + reps
    return out


def cuda_ms(fn, reps: int, warmup: int) -> float:
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


def qr_residual(a, packed, taus) -> float:
    """‖Q·[R; 0] − A‖/‖A‖ in f64, Q = H_0 ⋯ H_{k−1}: the reflectors applied
    to [R; 0] from the last to the first."""
    m, b = a.shape
    k = taus.shape[0]
    pk = packed.double()
    v = torch.tril(pk[:, :k], -1) + torch.eye(m, k, dtype=torch.float64, device=a.device)
    x = torch.zeros(m, b, dtype=torch.float64, device=a.device)
    x[:k] = torch.triu(pk[:k])
    for j in range(k - 1, -1, -1):
        x -= taus[j].double() * torch.outer(v[:, j], v[:, j] @ x)
    a64 = a.double()
    return (torch.linalg.matrix_norm(x - a64) / torch.linalg.matrix_norm(a64)).item()


def panel_lab(reps: int = 20, warmup: int = 3, log=print) -> list[dict]:
    """Every panel at every shape on the card: one row each, with ``ok``
    whether the residual is within 8·m·eps_f32."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    g = torch.randn(N, N, generator=gen, device="cuda")
    rows = []
    for m, b in SHAPES:
        pan = g[:m, :b]
        ref = None
        for label, _, fn in _panels():
            packed, taus = fn(pan)
            torch.cuda.synchronize()
            if ref is None:
                ref = packed, taus
            row = dict(panel=label, m=m, b=b,
                       ms=cuda_ms(lambda: fn(pan), reps, warmup),
                       resid=qr_residual(pan, packed, taus),
                       packed_diff=(packed - ref[0]).abs().max().item(),
                       tau_diff=(taus - ref[1]).abs().max().item())
            row["ok"] = row["resid"] <= 8 * m * EPS32
            rows.append(row)
            log(f"{label} ({m}, {b}): {row['ms']:.4f} ms, |QR-A|/|A| "
                f"{row['resid']:.3e} (<= {8 * m * EPS32:.3e}: {row['ok']}), "
                f"max |packed - v5| {row['packed_diff']:.3e}, max |tau - v5| "
                f"{row['tau_diff']:.3e}")
    return rows


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--warmup", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is false: this script needs a CUDA card")
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"nvidia-smi: {smi}")
    rows = panel_lab(args.reps, args.warmup)
    print(json.dumps({"device": smi, "reps": args.reps, "warmup": args.warmup,
                      "rows": rows}))
    if not all(r["ok"] for r in rows):
        sys.exit("a residual exceeds 8·m·eps_f32")


if __name__ == "__main__":
    main()
