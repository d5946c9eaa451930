"""The bulge-chase probe of faer_tpu_torch on one CUDA card.

    python tools/torch_chase.py [--reps N] [--warmup N]

The port's counterpart of ``tools/r5chase.py``. For b in {64, 128}, g in
{1, 4, 8} and steps in {256, 1024}, a Gaussian (g·4b, 2b) strip made on the
card from seed 0 goes through ``chase_probe``: µs per step (g windows, one a
strip) and per window, from the median of ``--reps`` CUDA-event timings
after ``--warmup`` calls. The strip is not symmetric, so the rank-2 steps
are not similarities and the values grow with the steps; the output must
be finite, and its largest entry and its largest difference from the plain
version, relative to it, are printed without a bound.

Then the decision arithmetic of ``r5chase.py:8-14`` with this card's
numbers (:func:`break_even`): a two-stage reduction at n = 4096 with band
b = 128 chases about n²/(2b) = 65 536 window steps, g chains at a time, so
its chase takes 65 536·t_step/g; beside it the port's one-stage reduction
(``tridiag_in_place`` at 4096, timed here unless given) and
``torch.linalg.eigh``'s whole 4096 call. The two-stage reduction can pay
only if its chase fits in ``BUDGET_SHARE`` of the one-stage reduction, the
rest being its band reduction and back-transform.

Each call launches the kernel once; :func:`predicted_launches` is what the
counter must read after :func:`chase_lab`. The last line is one JSON
object with the card's name and power limit, every row and the verdict.
Exits non-zero without a card, or if an output is not finite.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

SEED = 0  # r5chase.py's numpy seed; torch's generator gives other numbers
GRID = tuple((b, g, steps) for b in (64, 128) for g in (1, 4, 8) for steps in (256, 1024))
N, BAND = 4096, 128  # the decision's EVD size and band width
# r5chase.py:12-14: the chase must fit in 0.3-0.5 of the one-stage
# reduction's wall; the lower end is taken
BUDGET_SHARE = 0.3


def predicted_launches(reps: int, warmup: int) -> dict[str, int]:
    """``chase_probe`` launches in :func:`chase_lab`: one checked call,
    ``warmup`` and ``reps`` timed ones, at each point of the grid."""
    return {"chase_probe": len(GRID) * (1 + warmup + reps)}


def chase_steps(n: int = N, b: int = BAND) -> int:
    """Window steps of the band-to-tridiagonal chase: about n²/(2b)."""
    return n * n // (2 * b)


def break_even(step_ms: dict[int, float], reduction_ms: float,
               n: int = N, b: int = BAND) -> list[dict]:
    """For each g, the chase's wall at (n, b) from its time per step,
    65 536·t_step/g at n = 4096, b = 128, and its share of the one-stage
    reduction's wall; ``pays`` whether that share is within
    ``BUDGET_SHARE``."""
    out = []
    for g, t in sorted(step_ms.items()):
        wall = chase_steps(n, b) * t / g
        out.append(dict(g=g, step_us=t * 1e3, chase_ms=wall,
                        share=wall / reduction_ms, pays=wall <= BUDGET_SHARE * reduction_ms))
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


def chase_lab(reps: int = 5, warmup: int = 1, log=print) -> list[dict]:
    """The grid on the card: one row each, with ``ok`` whether the output
    is finite."""
    from faer_tpu_torch.ops.kernels.band_chase import chase_probe, chase_probe_plain

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = []
    for b, g, steps in GRID:
        band = torch.randn(g * 4 * b, 2 * b, generator=gen, device="cuda")
        out = chase_probe(band, b=b, steps=steps, g=g)
        plain = chase_probe_plain(band, b=b, steps=steps, g=g)
        torch.cuda.synchronize()
        ms = cuda_ms(lambda: chase_probe(band, b=b, steps=steps, g=g), reps, warmup)
        top = out.abs().max().item()
        row = dict(b=b, g=g, steps=steps, ms=ms, step_us=ms * 1e3 / steps,
                   window_us=ms * 1e3 / steps / g, max_abs=top,
                   rel_diff=(out - plain).abs().max().item() / max(top, 1e-30),
                   ok=bool(torch.isfinite(out).all()))
        rows.append(row)
        log(f"chase_probe b={b} g={g} steps={steps}: {ms:.4f} ms, "
            f"{row['step_us']:.3f} us/step, {row['window_us']:.3f} us/window; "
            f"max|out| {top:.4g}, max|out - plain|/max|out| {row['rel_diff']:.3e}, "
            f"finite {row['ok']}")
    return rows


def one_stage_ms(n: int = N, seed: int = SEED) -> tuple[float, float]:
    """(``tridiag_in_place``, ``torch.linalg.eigh``) at n on (g + gᵀ)/2, ms:
    the reduction timed once after a warm-up, eigh the median of 3."""
    from faer_tpu_torch.linalg.tridiag import tridiag_in_place

    gen = torch.Generator(device="cuda").manual_seed(seed)
    g = torch.randn(n, n, generator=gen, device="cuda")
    a = (g + g.T) / 2
    return (cuda_ms(lambda: tridiag_in_place(a), 1, 1),
            cuda_ms(lambda: torch.linalg.eigh(a), 3, 1))


def verdict(rows: list[dict], reduction_ms: float, eigh_ms: float, log=print) -> dict:
    """The decision at (n, b) = (4096, 128) from the rows at b = 128 and the
    longer step count."""
    longest = max(r["steps"] for r in rows)
    step_ms = {r["g"]: r["ms"] / r["steps"] for r in rows
               if r["b"] == BAND and r["steps"] == longest}
    cases = break_even(step_ms, reduction_ms)
    for c in cases:
        log(f"two-stage chase at n={N}, b={BAND}, g={c['g']}: {chase_steps()} steps x "
            f"{c['step_us']:.3f} us / {c['g']} = {c['chase_ms']:.4f} ms, "
            f"{c['share']:.3f} of the one-stage reduction ({reduction_ms:.4f} ms; "
            f"budget {BUDGET_SHARE}): {'pays' if c['pays'] else 'does not pay'}; "
            f"{c['chase_ms'] / eigh_ms:.3f} x torch.linalg.eigh ({eigh_ms:.4f} ms)")
    return dict(reduction_ms=reduction_ms, eigh_ms=eigh_ms, cases=cases,
                pays=any(c["pays"] for c in cases))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--warmup", type=int, default=1)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is false: this script needs a CUDA card")
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from faer_tpu_torch.core.config import launch_counts, reset_launch_counts

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"nvidia-smi: {smi}")
    reset_launch_counts()
    rows = chase_lab(args.reps, args.warmup)
    torch.cuda.synchronize()
    got = {"chase_probe": launch_counts()["chase_probe"]}
    want = predicted_launches(args.reps, args.warmup)
    print(f"launches {got}, predicted {want}")
    decision = verdict(rows, *one_stage_ms())
    print(json.dumps({"device": smi, "reps": args.reps, "warmup": args.warmup,
                      "launches": got, "rows": rows, "verdict": decision}))
    if got != want or not all(r["ok"] for r in rows):
        sys.exit("a check failed")


if __name__ == "__main__":
    main()
