"""``gevd(method="reduction")`` on several seeds, on one CUDA card.

    python tools/torch_gevd_reduction.py [SEED ...]

Runs the check of ``chip_smoke.py``'s phase 15 on other draws: for each
seed (by default 0 to 7) A and B are Gaussian n × n in float32 at
``chip_smoke.GEVD_REDUCTION_N``, drawn from a card generator of that seed
(A first), and ``chip_smoke.gevd_reduction_readings`` holds the call to
the backward errors of its LU solve and of evd(Ĉ) (each within 8·n·eps)
and its pencil residual to 2·κ₂(B)·η. Prints the card's name and power
limit, one line a seed, and as the last line one JSON object with every
reading. Exits non-zero without a card, or if a seed breaks a bound.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from torch_split import _chip_smoke  # noqa: E402


def main() -> None:
    seeds = [int(x) for x in sys.argv[1:]] or list(range(8))
    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is false: this script needs a CUDA card")
    cs = _chip_smoke()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"nvidia-smi: {smi}")
    n = cs.GEVD_REDUCTION_N
    rows = []
    for seed in seeds:
        gen = torch.Generator(device="cuda").manual_seed(seed)
        a = torch.randn(n, n, generator=gen, device="cuda")
        b = torch.randn(n, n, generator=gen, device="cuda")
        r = cs.gevd_reduction_readings(a, b)
        print(f"{'ok  ' if r['ok'] else 'FAIL'} seed {seed}, n={n}: {r['message']}; "
              f"{r['ms']:.1f} ms", flush=True)
        rows.append(dict(seed=seed, ok=r["ok"], **{k: r[k] for k in (
            "eta_s", "eta_e", "kappa", "residual", "bound", "ms")}))
    print(json.dumps({"n": n, "device": smi, "rows": rows}))
    sys.exit(0 if all(r["ok"] for r in rows) else 1)


if __name__ == "__main__":
    main()
