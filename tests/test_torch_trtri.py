"""The port's ``trtri`` kernel module and its two callers against the JAX
package.

``csrc/trtri.cu`` inverts a lower-triangular block in an order of its own:
16 × 16 diagonal sub-blocks by substitution, then levels of the 2 × 2
combine X₂₁ = −(X₂₂·L₂₁)·X₁₁. ``trtri_blocked_plain`` follows that order;
here it is held against ``trtri_plain`` (what the wrappers run on a CPU
tensor), the Pallas ``trtri_pallas`` in interpret mode and an f64 inverse.
The batched wrapper's CPU route, the leaf plan of
``invert_lower_triangular`` and the triangular solves, which now invert
all their diagonal blocks in one batched call, are held against the JAX
package's functions on the CPU. Inputs are numpy arrays from a seed.
Tolerances: 8·n·eps_f32·κ₂(L) relative to max|L⁻¹| for an inverse (a
forward error); faer's 8·n·eps_f32 (``utils/approx.py``) for the inverses
and solves of ``tests/test_torch_ops.py``.
"""
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import faer_tpu.ops.triangular as jtri
import faer_tpu.ops.triangular_solve as jts
from faer_tpu_torch.core.config import KERNELS, launch_counts, reset_launch_counts
from faer_tpu_torch.ops import triangular as ttri
from faer_tpu_torch.ops import triangular_solve as tts
from faer_tpu_torch.ops.kernels.trtri import (
    MAX_N, padded, trtri, trtri_batched, trtri_batched_plain, trtri_blocked_plain,
    trtri_plain)
from faer_tpu_torch.utils.approx import assert_approx_eq, size_scale

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EPS32 = float(np.finfo(np.float32).eps)
SIZES = (1, 16, 17, 100, 128)


@pytest.fixture(scope="module")
def pallas_trtri():
    """``trtri_pallas`` with every pallas_call through the interpreter (as
    in tests/test_pallas_kernels.py), cached traces dropped before and
    after."""
    from jax.experimental import pallas as pl

    import faer_tpu.ops.pallas.panel_kernels as pk

    orig = pl.pallas_call

    def interp_call(*args, **kwargs):
        kwargs["interpret"] = True
        kwargs.pop("compiler_params", None)
        return orig(*args, **kwargs)

    pl.pallas_call = interp_call
    pk.trtri_pallas.clear_cache()
    try:
        yield lambda t, unit: np.asarray(pk.trtri_pallas(jnp.asarray(t), unit=unit))
    finally:
        pl.pallas_call = orig
        pk.trtri_pallas.clear_cache()


def _block(n, unit, rng):
    """A lower-triangular block with garbage above the diagonal. Unit: strict
    entries N(0, 1/n) (κ stays O(1)) and a stored diagonal in [2, 3] that
    must be ignored; else the Cholesky factor of g gᵀ/n + I."""
    g = rng.standard_normal((n, n))
    if unit:
        lo = np.tril(g / np.sqrt(n), -1) + np.diag(2 + rng.random(n))
    else:
        lo = np.linalg.cholesky(g @ g.T / n + np.eye(n))
    return (lo + np.triu(rng.standard_normal((n, n)), 1)).astype(np.float32)


def _structured64(t, unit):
    """The f64 lower-triangular matrix the kernel inverts."""
    t64 = t.astype(np.float64)
    return np.tril(t64, -1) + (np.eye(len(t)) if unit else np.diag(np.diag(t64)))


def _max_rel(got, want):
    return np.abs(np.asarray(got, np.float64) - want).max() / np.abs(want).max()


@pytest.mark.parametrize("unit", [False, True])
@pytest.mark.parametrize("n", SIZES)
def test_blocked_plain_matches_plain_pallas_and_f64(n, unit, pallas_trtri):
    t = _block(n, unit, np.random.default_rng(10 * n + unit))
    lo64 = _structured64(t, unit)
    tol = 8 * n * EPS32 * np.linalg.cond(lo64)
    got = trtri_blocked_plain(torch.from_numpy(t), unit=unit).numpy()
    assert got.shape == (n, n) and np.all(np.triu(got, 1) == 0)
    for want in (trtri_plain(torch.from_numpy(t), unit=unit).numpy(),
                 pallas_trtri(t, unit), np.linalg.inv(lo64)):
        assert _max_rel(got, want) <= tol


@pytest.mark.parametrize("n", [1, 16, 17, 31, 32, 33, 64, 65, 100, 128])
def test_padded_side(n):
    """16·2ᵏ ≥ n, the least such: 17 → 32, 100 → 128."""
    p = padded(n)
    assert p >= n and p % 16 == 0 and (p // 16) & (p // 16 - 1) == 0
    assert p == 16 or p // 2 < n


def _big_lower(n, rng):
    g = rng.standard_normal((n, n))
    return np.linalg.cholesky(g @ g.T / n + np.eye(n)).astype(np.float32)


def _views(n, rng):
    """The same lower triangle as a contiguous matrix, as an (n, n) view of
    an (n + 3, n + 3) buffer (row stride n + 3) and as the ``.mT`` view of
    its upper-triangular transpose (column stride n), each with garbage in
    the other triangle."""
    lo = _big_lower(n, rng)
    junk = np.triu(rng.standard_normal((n, n)), 1).astype(np.float32)
    plain = torch.from_numpy(lo + junk)
    buf = torch.from_numpy(rng.standard_normal((n + 3, n + 3)).astype(np.float32))
    buf[:n, :n] = plain
    upper = torch.from_numpy(np.ascontiguousarray((lo + junk).T))
    return {"contiguous": plain, "row stride n+3": buf[:n, :n], "transposed": upper.mT}


@pytest.mark.parametrize("unit", [False, True])
@pytest.mark.parametrize("plan", ["leaves", "diagonal blocks"])
def test_batched_plain_over_views_is_per_block_plain(plan, unit):
    """Slot i is ``trtri_plain`` of block i to the bit, zero past its size,
    whatever the view; the CPU wrapper is the plain version."""
    n = 300
    blocks = (ttri.leaf_plan(n) if plan == "leaves" else
              [(o, min(MAX_N, n - o)) for o in range(0, n, MAX_N)])
    views = _views(n, np.random.default_rng(7 + unit))
    want = None
    for name, t in views.items():
        got = trtri_batched_plain(t, blocks, unit=unit)
        assert got.shape == (len(blocks), MAX_N, MAX_N)
        assert torch.equal(trtri_batched(t, blocks, unit=unit), got)
        for i, (o, s) in enumerate(blocks):
            blk = views["contiguous"][o:o + s, o:o + s].clone()
            assert torch.equal(got[i, :s, :s], trtri_plain(blk, unit=unit)), name
            assert not got[i, s:].any() and not got[i, :, s:].any()
        if want is not None:
            assert torch.equal(got, want), name
        want = got


def test_single_block_wrapper_reads_views():
    """``trtri`` on a strided or transposed view gives the bits of a
    contiguous copy."""
    views = _views(100, np.random.default_rng(3))
    want = trtri(views["contiguous"])
    for t in views.values():
        assert torch.equal(trtri(t), want)


def _recorded_jax_leaves(n):
    """The blocks of side ≤ 128 that the JAX package's halving reaches, in
    order: its ``invert_lower_triangular`` on diag(1, …, n), with every call
    on a block of side ≤ 128 recorded (offset from the block's first
    diagonal entry) and cut short."""
    orig = jtri.invert_lower_triangular
    seen = []

    def cut(t, *, unit=False, base=None):
        if t.shape[0] <= MAX_N:
            seen.append((int(t[0, 0]) - 1, t.shape[0]))
            return jnp.zeros_like(t)
        return orig(t, unit=unit, base=base)

    jtri.invert_lower_triangular = cut
    try:
        cut(jnp.diag(jnp.arange(1, n + 1, dtype=jnp.float32)))
    finally:
        jtri.invert_lower_triangular = orig
    return seen


@pytest.mark.parametrize("n", [129, 300, 301, 1000])
def test_leaf_plan_is_the_halving_recursions(n):
    plan = ttri.leaf_plan(n)
    assert plan == _recorded_jax_leaves(n)
    assert sum(s for _, s in plan) == n and all(s <= MAX_N for _, s in plan)


def test_leaf_plan_of_301():
    assert ttri.leaf_plan(301) == [(0, 76), (76, 75), (151, 75), (226, 75)]


def _lower(n, unit, rng):
    if unit:
        return (np.tril(rng.standard_normal((n, n)) / np.sqrt(n), -1)
                + np.eye(n)).astype(np.float32)
    return _big_lower(n, rng)


@pytest.mark.parametrize("unit", [False, True])
@pytest.mark.parametrize("n", [300, 1000])
def test_invert_lower_triangular(n, unit):
    t = _lower(n, unit, np.random.default_rng(n + unit))
    reset_launch_counts()
    got = ttri.invert_lower_triangular(torch.from_numpy(t), unit=unit).numpy()
    assert launch_counts() == dict.fromkeys(KERNELS, 0)  # the CPU route
    want = np.asarray(jtri.invert_lower_triangular(jnp.asarray(t), unit=unit))
    assert_approx_eq(got, want, scale=size_scale(n), tol_dtype=np.float32)
    assert_approx_eq(got, np.linalg.inv(t.astype(np.float64)),
                     scale=size_scale(n), tol_dtype=np.float32)


@pytest.mark.parametrize("n", [300, 1000])
def test_invert_upper_triangular(n):
    u = _lower(n, False, np.random.default_rng(n)).T.copy()
    got = ttri.invert_upper_triangular(torch.from_numpy(u)).numpy()
    want = np.asarray(jtri.invert_upper_triangular(jnp.asarray(u)))
    assert_approx_eq(got, want, scale=size_scale(n), tol_dtype=np.float32)
    assert_approx_eq(got, np.linalg.inv(u.astype(np.float64)),
                     scale=size_scale(n), tol_dtype=np.float32)


_SOLVES = [
    # (name, triangle of the operand, needs a unit diagonal)
    ("solve_lower_triangular", "lower", False),
    ("solve_upper_triangular", "upper", False),
    ("solve_unit_lower_triangular", "lower", True),
    ("solve_unit_upper_triangular", "upper", True),
]


@pytest.mark.parametrize("name,tri,unit", _SOLVES, ids=[s[0] for s in _SOLVES])
@pytest.mark.parametrize("n", [300, 1000])
def test_triangular_solves_with_ragged_last_blocks(n, name, tri, unit):
    """n = 300 and 1000 leave a last block of 44 and 104 rows; 8 rhs."""
    rng = np.random.default_rng(n + 5)
    t = _lower(n, unit, rng)
    if tri == "upper":
        t = t.T.copy()
    other = np.triu if tri == "lower" else np.tril
    t = t + other(rng.standard_normal((n, n)), 1 if tri == "lower" else -1).astype(np.float32)
    b = rng.standard_normal((n, 8)).astype(np.float32)
    got = getattr(tts, name)(torch.from_numpy(t), torch.from_numpy(b)).numpy()
    want = np.asarray(getattr(jts, name)(jnp.asarray(t), jnp.asarray(b)))
    assert_approx_eq(got, want, scale=size_scale(n), tol_dtype=np.float32)
    t64 = (np.tril(t, -1) if tri == "lower" else np.triu(t, 1)).astype(np.float64)
    t64 += np.eye(n) if unit else np.diag(np.diag(t)).astype(np.float64)
    assert_approx_eq(got, np.linalg.solve(t64, b.astype(np.float64)),
                     scale=size_scale(n), tol_dtype=np.float32)


@pytest.mark.parametrize("name", ["solve_lower_triangular", "solve_upper_triangular"])
def test_solve_inverts_every_diagonal_block_in_one_call(name, monkeypatch):
    """One ``trtri_batched`` call per solve, over every 128-row diagonal
    block (the last one ragged), and no single-block ``trtri``."""
    import faer_tpu_torch.ops.kernels.trtri as ktrtri

    calls = []
    orig = ktrtri.trtri_batched

    def spy(t, blocks, **kwargs):
        calls.append(list(blocks))
        return orig(t, blocks, **kwargs)

    monkeypatch.setattr(tts, "trtri_batched", spy)
    monkeypatch.setattr(ttri, "trtri", lambda *a, **k: pytest.fail("single trtri"))
    n = 1000
    rng = np.random.default_rng(1)
    t = _lower(n, False, rng)
    t = torch.from_numpy(t if name.startswith("solve_lower") else t.T.copy())
    getattr(tts, name)(t, torch.from_numpy(rng.standard_normal((n, 8)).astype(np.float32)))
    assert calls == [[(o, min(MAX_N, n - o)) for o in range(0, n, MAX_N)]]


_SMOKE = None


def _smoke_constants() -> dict:
    """``chip_smoke.py``'s module globals (its ``main`` not run)."""
    global _SMOKE
    if _SMOKE is None:
        import runpy

        _SMOKE = runpy.run_path(os.path.join(REPO, "chip_smoke.py"))
    return _SMOKE


@pytest.mark.parametrize("shape", [("llt", 4000), ("llt", 1000), ("lu", (4000, 4000)),
                                   ("lu", (4096, 1024)), ("lu", (1024, 4096))],
                         ids=["llt4000", "llt1000", "lu4000", "lu4096x1024",
                              "lu1024x4096"])
def test_off_route_launch_predictions_follow_the_code(shape, monkeypatch):
    """``chip_smoke.py`` phase 6's exact leaf and ``trtri`` launch counts
    (``LLT_OFF_ROUTE``, ``LU_OFF_ROUTE``), counted on a CPU run of the same
    factor: one launch a ``trtri`` call, one per ``MAX_BATCH`` blocks a
    ``trtri_batched`` call, one a leaf."""
    from faer_tpu_torch.linalg import cholesky as tchol
    from faer_tpu_torch.linalg import lu as tlu
    from faer_tpu_torch.ops.kernels.trtri import MAX_BATCH

    calls = {}

    def counted(mod, name, key, per=lambda *a: 1):
        orig = getattr(mod, name)

        def fn(*args, **kwargs):
            calls[key] = calls.get(key, 0) + per(*args)
            return orig(*args, **kwargs)

        monkeypatch.setattr(mod, name, fn)

    batches = lambda t, blocks: -(-len(blocks) // MAX_BATCH)
    counted(ttri, "trtri", "trtri")
    counted(ttri, "trtri_batched", "trtri", batches)
    counted(tts, "trtri_batched", "trtri", batches)
    counted(tchol, "llt_leaf", "llt_leaf")
    counted(tlu, "lu_leaf", "lu_leaf")
    kind, dims = shape
    rng = np.random.default_rng(6)
    if kind == "llt":
        want = _smoke_constants()["LLT_OFF_ROUTE"][dims]
        g = rng.standard_normal((dims, dims)).astype(np.float32)
        tchol.llt_factor(torch.from_numpy(g @ g.T / dims + np.eye(dims, dtype=np.float32)))
    else:
        want = _smoke_constants()["LU_OFF_ROUTE"][dims]
        tlu.lu_in_place(torch.from_numpy(rng.standard_normal(dims).astype(np.float32)))
    assert calls == want


@pytest.mark.parametrize("tool", ["torch_split.py", "torch_profile.py"])
def test_tools_exit_without_a_card_and_import_no_jax(tool):
    """The timing tools refuse to time ``trtri`` without a card, printing no
    result; loading them and the port's triangular modules loads neither
    JAX nor the JAX package."""
    path = os.path.join("tools", tool)
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, path, "trtri"], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and "{" not in proc.stdout
    assert "CUDA card" in proc.stderr
    code = ("import sys, runpy, faer_tpu_torch.ops.triangular_solve; "
            f"runpy.run_path({path!r}); "
            "bad = sorted(m for m in sys.modules if m in ('jax', 'faer_tpu') "
            "or m.startswith(('jax.', 'faer_tpu.'))); "
            "assert not bad, bad")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
