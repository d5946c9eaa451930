"""Per-call and device time of a checkout's LLT diagonal-block wrappers, on one CUDA card.

    python tools/torch_llt_split.py [ROOT]

Times ``llt_leaf``, ``llt_block`` and ``llt_block_v3`` of the
``faer_tpu_torch`` under ROOT (by default this checkout), and
``torch.linalg.cholesky_ex`` beside them, exactly as phase 3 of
``chip_smoke.py`` times this checkout's: its inputs (``_spd``, mirrored
from the lower triangle, seed 1), its sizes ``LLT_TIMED`` and its two
timers, ``cuda_ms`` per call (what a caller pays, the host's wrapper
included) and ``graph_ms`` on the device (a CUDA graph of
``LLT_GRAPH_REPS`` calls). Only this checkout's ``chip_smoke.py`` is used,
so one chip call can time another checkout (a parent commit unpacked beside
this one) in turns with this one by the same code. Prints the card's name
and power limit, one line a row, and as the last line one JSON object with
every row. Exits non-zero without a card.
"""
from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parents[1]
SEED = 1


def _chip_smoke():
    """This checkout's ``chip_smoke.py`` as a module (its ``main`` not run)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> None:
    root = Path(sys.argv[1]).resolve() if len(sys.argv) > 1 else HERE
    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is false: this script needs a CUDA card")
    sys.path.insert(0, str(root))
    from faer_tpu_torch.ops.kernels.leaf import llt_leaf
    from faer_tpu_torch.ops.kernels.llt_block import llt_block, llt_block_v3

    cs = _chip_smoke()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"nvidia-smi: {smi}")
    calls = {"llt_leaf": llt_leaf, "llt_block": llt_block, "llt_block_v3": llt_block_v3,
             "cholesky_ex": torch.linalg.cholesky_ex}
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = []
    for b in cs.LLT_TIMED:
        a = cs._mirrored(cs._spd(b, gen))
        for name, fn in calls.items():
            call = (lambda f=fn: f(a))
            row = dict(call=name, b=b, per_call_ms=cs.cuda_ms(call, cs.LLT_CALL_REPS),
                       device_ms=cs.graph_ms(call, cs.LLT_GRAPH_REPS))
            rows.append(row)
            print(f"{name} b={b}: per call {row['per_call_ms']:.4f} ms, "
                  f"device {row['device_ms']:.4f} ms")
    print(json.dumps({"root": str(root), "device": smi, "rows": rows}))


if __name__ == "__main__":
    main()
