"""The LLT diagonal-block lab of faer_tpu_torch on one CUDA card.

    python tools/torch_llt_blocks.py [--reps N] [--warmup N]

The port's counterpart of ``tools/r4parts.py`` section ``llt``,
``tools/r4lab.py`` section ``check`` (its LLT part) and ``tools/r4lab2.py``
sections ``lltleaf`` and ``lltfac``. In the JAX package the three leaf
kernels are three designs; in the port ``llt_block``, ``llt_block_v3`` and
``llt_leaf`` launch one blocked kernel (``csrc/llt_block.cu``) behind three
counters, so on a card the lab compares leaf widths and block sizes, and
the three leaves of one width differ only by run-to-run noise. Two parts,
on inputs made on the card from a seed (torch's generator gives other
numbers than JAX's keys):

* **Blocks** (:func:`block_lab`). For b in {128, 256, 512}, on
  A = g gᵀ/b + 2I (mirrored from its lower triangle, so exactly symmetric),
  five calls: ``llt_block`` (v1), ``llt_block_v3``, ``llt_leaf`` (v4), the
  port's ``_llt_panel_recursive(·, reg, 256)`` and
  ``torch.linalg.cholesky_ex``. For each, the median of ``--reps``
  CUDA-event timings after ``--warmup`` calls, ‖LLᵀ − A‖/‖A‖ in f64
  (≤ 8·b·eps_f32) and the largest difference from ``llt_block``'s L,
  relative to its largest entry (``r4lab.py``'s check). Then one
  regularized block (eps = delta = 1, three pivots replaced, the first
  negative) on which the three kernels must agree on count and ok.
* **Factors** (:func:`factor_lab`). A 4096² f32 LLT whose leaves are a
  plugged-in kernel: :func:`llt_factor_variant`, the counterpart of
  ``_llt_factor_variant`` (``r4lab2.py:50-87``), written here with the
  library untouched, for leaf kernel in {``llt_block``, ``llt_block_v3``,
  ``llt_leaf``} × leaf width in {128, 256} × block in {256, 512}: 12
  factors, each timed, with ‖LLᵀ − A‖/‖A‖ ≤ 8·n·eps_f32; beside them
  ``llt_factor`` 4096 (the fused-panel route).

:func:`predicted_launches` gives what each launch counter must read after
both parts, counted from their control flow (``trtri`` included). The last
line is one JSON object with the card's name and power limit and every row.
Exits non-zero without a card, or if a check fails.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

BLOCK_SEED, FACTOR_SEED = 1, 12  # r4parts.py's and r4lab2.py's keys
BLOCKS = (128, 256, 512)
RECURSIVE_BASE = 256  # r4parts.py's _llt_panel_recursive(·, reg, 256)
N = 4096
LEAF_KERNELS = ("llt_block", "llt_block_v3", "llt_leaf")
LEAF_WIDTHS = (128, 256)
FACTOR_BLOCKS = (256, 512)
# the regularized block: b, the clearly negative pivots, (eps, delta)
REG_B, REG_BAD, REG = 128, (3, 20, 77), (1.0, 1.0)
EPS32 = float(torch.finfo(torch.float32).eps)


def _kernels() -> dict:
    from faer_tpu_torch.ops.kernels.leaf import llt_leaf
    from faer_tpu_torch.ops.kernels.llt_block import llt_block, llt_block_v3

    return {"llt_block": llt_block, "llt_block_v3": llt_block_v3, "llt_leaf": llt_leaf}


# ---------------------------------------------------------------------------
# launches, counted from the control flow
# ---------------------------------------------------------------------------

def trtri_calls(n: int) -> int:
    """``trtri`` launches of ``invert_lower_triangular`` on an (n, n) block:
    every leaf of its halving (``leaf_plan``) in one batched launch per
    ``MAX_BATCH`` leaves."""
    from faer_tpu_torch.ops.kernels.trtri import MAX_BATCH
    from faer_tpu_torch.ops.triangular import leaf_plan

    return -(-len(leaf_plan(n)) // MAX_BATCH)


def recursive_calls(b: int, base: int = RECURSIVE_BASE) -> tuple[int, int]:
    """(leaves, trtri launches) of ``_llt_panel_recursive`` on a (b, b) block."""
    if b <= base:
        return 1, 0
    h = (b + 1) // 2
    l1, t1 = recursive_calls(h, base)
    l2, t2 = recursive_calls(b - h, base)
    return l1 + l2, t1 + t2 + trtri_calls(h)


def variant_calls(n: int, block: int, leaf: int) -> tuple[int, int]:
    """(leaves, trtri launches) of one :func:`llt_factor_variant`."""
    def panel(b):
        if b <= leaf:
            return 1, 0
        h = b // 2
        l1, t1 = panel(h)
        l2, t2 = panel(b - h)
        return l1 + l2, t1 + t2 + trtri_calls(h)

    leaves = trtri = 0
    for k in range(0, n, block):
        bw = min(block, n - k)
        pl, pt = panel(bw)
        leaves += pl
        trtri += pt + (trtri_calls(bw) if k + bw < n else 0)
    return leaves, trtri


def v5_panels(n: int, block: int = 256) -> int:
    """``llt_panel`` launches of ``llt_factor`` on the fused-panel route."""
    ob = max(block, 1024) if n >= 2048 else block
    return sum(-(-min(ob, n - kk) // block) for kk in range(0, n, ob))


def predicted_launches(reps: int, warmup: int, n: int = N) -> dict[str, int]:
    """Each counter's launches over :func:`block_lab` and :func:`factor_lab`:
    one checked call, ``warmup`` and ``reps`` timed ones of everything timed,
    and one call of each kernel on the regularized block."""
    calls = 1 + warmup + reps
    out = dict.fromkeys(("llt_block", "llt_block_v3", "llt_leaf", "trtri",
                         "llt_panel"), 0)
    for b in BLOCKS:
        leaves, trtri = recursive_calls(b)
        for k in LEAF_KERNELS:
            out[k] += calls
        out["llt_leaf"] += calls * leaves
        out["trtri"] += calls * trtri
    for k in LEAF_KERNELS:
        out[k] += 1
    for k in LEAF_KERNELS:
        for leaf in LEAF_WIDTHS:
            for block in FACTOR_BLOCKS:
                leaves, trtri = variant_calls(n, block, leaf)
                out[k] += calls * leaves
                out["trtri"] += calls * trtri
    out["llt_panel"] += calls * v5_panels(n)
    return out


# ---------------------------------------------------------------------------
# the lab
# ---------------------------------------------------------------------------

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


def spd(n: int, gen, device="cuda"):
    """g gᵀ/n + 2I (``r4parts.py:37-38``), mirrored from its lower triangle."""
    g = torch.randn(n, n, generator=gen, device=device)
    a = torch.tril(g @ g.T / n + 2 * torch.eye(n, device=device))
    return a + torch.tril(a, -1).mT


def regularized_block(b: int, bad, gen, device="cuda"):
    """L Lᵀ − 1e-3·Σ e_k e_kᵀ over the ``bad`` columns k, where L has 0 on
    the diagonal there and [1.5, 2.5] elsewhere. The first bad pivot is
    −1e-3; a later one is −1e-3 plus the squares of its row's entries in the
    earlier bad columns, which the factor loses, O(1/b) each. So with
    delta = 1 every bad pivot is replaced and counted, and every other pivot,
    at least 2.25 under any rounding, is not."""
    lo = torch.tril(torch.randn(b, b, generator=gen, device=device) / b ** 0.5, -1)
    diag = 1.5 + torch.rand(b, generator=gen, device=device)
    diag[list(bad)] = 0.0
    lo = lo + torch.diag(diag)
    a = torch.tril(lo @ lo.T)
    a = a + torch.tril(a, -1).mT
    a[list(bad), list(bad)] -= 1e-3
    return a


def llt_residual(l, a) -> float:
    """‖L Lᵀ − A‖/‖A‖ in f64."""
    l64, a64 = l.double(), a.double()
    return (torch.linalg.matrix_norm(l64 @ l64.T - a64)
            / torch.linalg.matrix_norm(a64)).item()


def llt_factor_variant(a, *, block: int, leaf: int, leaf_fn):
    """``_llt_factor_variant`` (``tools/r4lab2.py:50-87``): the blocked
    right-looking LLT of ``a`` whose diagonal blocks are halved down to
    ``leaf_fn`` leaves of at most ``leaf`` columns. Each block is mirrored
    from its lower triangle before it is factored; couplings are products
    against explicit triangular inverses. Returns L."""
    from faer_tpu_torch.ops.matmul import matmul
    from faer_tpu_torch.ops.triangular import invert_lower_triangular

    def panel(dblk):
        b = dblk.shape[0]
        if b <= leaf:
            return leaf_fn(dblk)
        h = b // 2
        d1 = panel(dblk[:h, :h])
        l21 = matmul(None, dblk[h:, :h], invert_lower_triangular(d1).mT)
        d2 = panel(dblk[h:, h:] - matmul(None, l21, l21.mT))
        out = dblk.new_zeros((b, b))
        out[:h, :h] = d1
        out[h:, :h] = l21
        out[h:, h:] = d2
        return out

    n = a.shape[0]
    l = a.new_zeros((n, n))
    trail = a
    for k in range(0, n, block):
        bw = min(block, n - k)
        dblk = torch.tril(trail[:bw, :bw])
        d = panel(dblk + torch.tril(dblk, -1).mT)
        l[k:k + bw, k:k + bw] = torch.tril(d)
        if k + bw < n:
            l21 = matmul(None, trail[bw:, :bw], invert_lower_triangular(d).mT)
            l[k + bw:, k:k + bw] = l21
            trail = trail[bw:, bw:] - matmul(None, l21, l21.mT)
    return l


def block_lab(reps: int = 20, warmup: int = 3, log=print) -> list[dict]:
    """The five calls at each block size, then the regularized block: one
    row each, with ``ok`` whether the check held."""
    from faer_tpu_torch.core.params import LltRegularization
    from faer_tpu_torch.linalg.cholesky import _llt_panel_recursive

    gen = torch.Generator(device="cuda").manual_seed(BLOCK_SEED)
    kernels = _kernels()
    reg = LltRegularization()
    calls = {name: (lambda x, f=f: f(x)[0]) for name, f in kernels.items()}
    calls[f"_llt_panel_recursive({RECURSIVE_BASE})"] = (
        lambda x: _llt_panel_recursive(x, reg, RECURSIVE_BASE)[0])
    calls["cholesky_ex"] = lambda x: torch.linalg.cholesky_ex(x)[0]
    rows = []
    for b in BLOCKS:
        a = spd(b, gen)
        ref = None
        for label, fn in calls.items():
            l = fn(a)
            torch.cuda.synchronize()
            if ref is None:
                ref = l
            row = dict(call=label, b=b, ms=cuda_ms(lambda: fn(a), reps, warmup),
                       resid=llt_residual(l, a),
                       diff=((l - ref).abs().max() / ref.abs().max()).item())
            row["ok"] = row["resid"] <= 8 * b * EPS32
            rows.append(row)
            log(f"{label} b={b}: {row['ms']:.4f} ms, |LL^T-A|/|A| {row['resid']:.3e} "
                f"(<= {8 * b * EPS32:.3e}: {row['ok']}), max|L - L_v1|/max|L_v1| "
                f"{row['diff']:.3e}")
    eps, delta = REG
    a = regularized_block(REG_B, REG_BAD, gen)
    got = {name: f(a, eps=eps, delta=delta) for name, f in kernels.items()}
    torch.cuda.synchronize()
    tallies = {name: (int(c), bool(o)) for name, (_, c, o) in got.items()}
    ref = got["llt_block"][0]
    diff = max(((l - ref).abs().max() / ref.abs().max()).item() for l, _, _ in got.values())
    ok = set(tallies.values()) == {(len(REG_BAD), False)} and diff <= 8 * REG_B * EPS32
    rows.append(dict(call="regularized", b=REG_B, eps=eps, delta=delta,
                     counts=tallies, diff=diff, ok=ok))
    log(f"regularized b={REG_B} (eps {eps:g}, delta {delta:g}, pivots {REG_BAD} "
        f"replaced): (count, ok) {tallies}, max|L - L_v1|/max|L_v1| {diff:.3e}: {ok}")
    return rows


def factor_lab(reps: int = 20, warmup: int = 3, log=print) -> list[dict]:
    """The 12 plugged-leaf factors at n = 4096 and ``llt_factor`` beside
    them: one row each, with ``ok`` whether ‖LLᵀ − A‖/‖A‖ ≤ 8·n·eps_f32."""
    from faer_tpu_torch.linalg.cholesky import llt_factor

    gen = torch.Generator(device="cuda").manual_seed(FACTOR_SEED)
    a = spd(N, gen)
    kernels = _kernels()
    tol = 8 * N * EPS32
    cases = [(f"{k}@{leaf} block={block}",
              lambda x, f=kernels[k], leaf=leaf, block=block: llt_factor_variant(
                  x, block=block, leaf=leaf, leaf_fn=lambda blk: f(blk)[0]))
             for k in LEAF_KERNELS for leaf in LEAF_WIDTHS for block in FACTOR_BLOCKS]
    cases.append(("llt_factor (fused panels)", lambda x: llt_factor(x)[0]))
    rows = []
    for label, fn in cases:
        l = fn(a)
        torch.cuda.synchronize()
        ms = cuda_ms(lambda: fn(a), reps, warmup)
        row = dict(factor=label, n=N, ms=ms, gflops=N ** 3 / 3 / ms / 1e6,
                   resid=llt_residual(l, a))
        row["ok"] = row["resid"] <= tol
        rows.append(row)
        log(f"{label} n={N}: {ms:.4f} ms ({row['gflops']:.1f} GFLOP/s), "
            f"|LL^T-A|/|A| {row['resid']:.3e} (<= {tol:.3e}: {row['ok']})")
    return rows


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--warmup", type=int, default=3)
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
    rows = block_lab(args.reps, args.warmup) + factor_lab(args.reps, args.warmup)
    torch.cuda.synchronize()
    want = predicted_launches(args.reps, args.warmup)
    got = {k: launch_counts()[k] for k in want}
    print(f"launches {got}, predicted {want}")
    print(json.dumps({"device": smi, "reps": args.reps, "warmup": args.warmup,
                      "launches": got, "rows": rows}))
    if got != want or not all(r["ok"] for r in rows):
        sys.exit("a check failed")


if __name__ == "__main__":
    main()
