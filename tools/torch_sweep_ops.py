"""Host-issued operations of the multishift sweep's chase step, on the CPU.

    python tools/torch_sweep_ops.py [--n N] [ROOT]

Runs ``_sweep`` of the ``faer_tpu_torch`` under ROOT (by default this
checkout) once under ``torch.profiler`` on a seeded n × n Hessenberg block
(default 300) with ns = 32 shifts, the bulge count and chunk step that
``multishift_real_schur`` sets for them (16 bulges, 47 steps a chunk), and
prints the top-level ATen operations per inner chase step: those that
launch a kernel when the tensors lie on the card, and the views (``select``,
``slice``, ``reshape`` of a contiguous result, ``unsqueeze``, ``unbind``
and the like), which cost host time only. A chunk's own operations (its
window copy and three stripe GEMMs) are spread over its steps. On the
card each launch costs the host some 10 µs, which sets the sweep's pace.
The last line is one JSON object.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
from collections import Counter
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parents[1]
NS = 32
SEED = 0
VIEWS = frozenset(f"aten::{name}" for name in (
    "select", "slice", "reshape", "unsqueeze", "view", "unbind", "numpy_T", "t",
    "transpose", "as_strided", "expand", "alias", "detach", "diagonal"))


def sweep_ops(n: int) -> dict:
    """Per inner step of one sweep over the whole n × n block: launching
    operations, views, and the launching operations by name."""
    from torch.profiler import ProfilerActivity, profile

    from faer_tpu_torch.linalg import schur_multishift as tms

    nb = NS // 2
    step = 3 * nb - 1
    pad = step + 3 * nb + 3
    gen = torch.Generator().manual_seed(SEED)
    hp = torch.zeros(n + 2 * pad, n + 2 * pad)
    hp[pad:pad + n, pad:pad + n] = torch.triu(torch.randn(n, n, generator=gen), -1)
    qp = torch.zeros(n, n + 2 * pad)
    qp[:, pad:pad + n] = torch.eye(n)
    sb, pb = torch.randn(nb, generator=gen), torch.rand(nb, generator=gen)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tms._sweep(hp, qp, 0, n - 1, sb, pb, off=pad, nb=nb, step=step)
    top = [e.name for e in prof.events() if e.name.startswith("aten::")
           and (e.cpu_parent is None or not e.cpu_parent.name.startswith("aten::"))]
    steps = math.ceil((n - 1 + 3 * nb) / step) * step
    launches = Counter(name for name in top if name not in VIEWS)
    return dict(n=n, bulges=nb, steps=steps,
                launches_per_step=sum(launches.values()) / steps,
                views_per_step=sum(name in VIEWS for name in top) / steps,
                by_name={k: v / steps for k, v in launches.most_common()})


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("root", nargs="?", type=Path, default=HERE,
                        help="the checkout to count (default: this one)")
    parser.add_argument("--n", type=int, default=300, help="the block's order")
    args = parser.parse_args()
    sys.path.insert(0, str(args.root.resolve()))
    r = sweep_ops(args.n)
    print(f"_sweep n={r['n']}, {r['bulges']} bulges, {r['steps']} inner steps: "
          f"{r['launches_per_step']:.2f} launching operations and "
          f"{r['views_per_step']:.2f} views a step")
    print(json.dumps(dict(root=str(args.root.resolve()), **r)))


if __name__ == "__main__":
    main()
