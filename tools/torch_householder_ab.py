"""``make_householder`` of other checkouts timed inside this checkout's callers, on one CUDA card.

    python tools/torch_householder_ab.py ROOT [ROOT ...]

Loads ``faer_tpu_torch/ops/householder.py`` of each ROOT (``.`` for this
checkout) as a module of its own and, in ROUNDS rounds with the variants'
order turned each round, puts its ``make_householder`` into this
checkout's ``linalg.evd`` and ``linalg.qr`` and times, per call by CUDA
events (``chip_smoke.cuda_ms``, one call after a warm-up),
``hessenberg_blocked`` at 1024 in float32 (the general EVD's reduction),
``qr_in_place`` at 1024 in float64 (a non-kernel QR, one reflector a
column) and ``make_householder`` alone on a float32 column of 1024
(median of 20 calls), all on Gaussian inputs (seed 21). The callers are
the same code for every variant, so only the reflector differs. Also
counts the operations one ``make_householder`` call dispatches, views and
wrapped scalars left out (each one kernel launch on the card). Prints the
card's name and power limit, one line a round and variant, the medians,
and as the last line one JSON object.
"""
from __future__ import annotations

import importlib.util
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))
from torch_split import _chip_smoke  # noqa: E402

ROUNDS = 7
NOT_LAUNCHES = {"select", "slice", "view", "view_as_real", "alias", "scalar_tensor"}


class _Ops(TorchDispatchMode):
    """Counts the dispatched operations that launch a kernel."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += func.overloadpacket.__name__ not in NOT_LAUNCHES
        return func(*args, **(kwargs or {}))


def _variant(root: Path, i: int):
    spec = importlib.util.spec_from_file_location(
        f"householder_{i}", root / "faer_tpu_torch" / "ops" / "householder.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.make_householder


def main() -> None:
    roots = [Path(r).resolve() for r in sys.argv[1:]]
    if not roots:
        sys.exit(__doc__)
    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is false: this script needs a CUDA card")
    cs = _chip_smoke()
    from faer_tpu_torch.linalg import evd, qr

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"nvidia-smi: {smi}")
    variants = [(str(r), _variant(r, i)) for i, r in enumerate(roots)]
    gen = torch.Generator(device="cuda").manual_seed(21)
    g64 = torch.randn(1024, 1024, generator=gen, device="cuda", dtype=torch.float64)
    g32 = g64.float()
    col = g32[:, 0].clone()
    ops = {}
    for name, mh in variants:
        with _Ops() as c:
            mh(col)
        ops[name] = c.n
    rows = {name: {"hessenberg_blocked f32": [], "qr_in_place f64": [],
                   "make_householder f32": []} for name, _ in variants}
    for r in range(ROUNDS):
        for name, mh in variants[r % len(variants):] + variants[:r % len(variants)]:
            evd.make_householder = qr.make_householder = mh
            t = rows[name]
            t["hessenberg_blocked f32"].append(cs.cuda_ms(lambda: evd.hessenberg_blocked(g32), 1))
            t["qr_in_place f64"].append(cs.cuda_ms(lambda: qr.qr_in_place(g64), 1))
            t["make_householder f32"].append(cs.cuda_ms(lambda: mh(col), 20))
            print(f"round {r} {name}: " + ", ".join(f"{k} {v[-1]:.4f} ms" for k, v in t.items()),
                  flush=True)
    for name, t in rows.items():
        print(f"median {name} ({ops[name]} launches a reflector): "
              + ", ".join(f"{k} {statistics.median(v):.4f} ms" for k, v in t.items()))
    print(json.dumps({"device": smi, "launches_a_reflector": ops, "rows": rows}))


if __name__ == "__main__":
    main()
