"""The LLT panel kernel's order against the Pallas LLT panel, on the CPU.

``llt_panel_blocked_plain`` repeats, step for step, the order of the Hopper
kernel behind ``llt_panel`` (``csrc/llt_panel.cu``): left-looking 32-column
sub-blocks, each diagonal tile's products and factor (1/sqrt of each pivot
rounded once), each later row's 32 columns by one FMA chain and a
substitution against the tile, the rows split into groups as the kernel's
CTAs hold them. Here it is held against ``llt_panel_v5_pallas`` in
interpret mode, against ``llt_panel_plain`` (the wrapper's CPU route) and
against an f64 Cholesky factor and solve. The Pallas kernel's L21 is a
bf16x3 product, so that comparison uses the bf16x3 unit roundoff 2⁻¹⁶ in
place of eps in faer's 8·n rule; everything else uses 8·b·eps_f32
(``utils/approx.py``). The upper triangle of ``slab[:b]`` is NaN in every
case: no version may read it.
"""
import functools
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faer_tpu_torch.core.errors import ShapeError
from faer_tpu_torch.ops.kernels.llt_panel import (
    launch, llt_panel, llt_panel_blocked_plain, llt_panel_plain)
from faer_tpu_torch.utils.approx import assert_approx_eq, size_scale

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EPS32 = float(np.finfo(np.float32).eps)
U3 = 2.0 ** -16  # unit roundoff of a bf16x3 product
REG = (1e-3, 1e-6)  # (eps, delta) of the regularized cases


def _spd_slab(m, b, seed, tiny_pivot=None):
    """[A11; A21] of A = g gᵀ/m + 2I, with the upper triangle of A11
    poisoned; with ``tiny_pivot`` one pivot of A11 becomes 1e-8 (under
    REG's delta)."""
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((m, m))
    a = g @ g.T / m + 2 * np.eye(m)
    if tiny_pivot is not None:
        lo = np.linalg.cholesky(a)
        lo[tiny_pivot, tiny_pivot] = 1e-4
        a = lo @ lo.T
    slab = a[:, :b].astype(np.float32)
    slab[:b] += np.triu(np.full((b, b), np.nan, np.float32), 1)
    return slab


# (m, b, tiny pivot): m not a multiple of 32, m = b, several sub-blocks
CASES = {
    "160x32": (160, 32, None),
    "256x64": (256, 64, None),
    "100x64": (100, 64, None),
    "64x64": (64, 64, None),
    "200x96": (200, 96, None),
    "160x32-reg": (160, 32, 5),
    "256x64-reg": (256, 64, 40),
}
PLAIN = [c for c, v in CASES.items() if v[2] is None]


@functools.lru_cache(maxsize=None)
def _slab(case):
    m, b, tiny = CASES[case]
    return _spd_slab(m, b, m + b, tiny)


def _reg(case):
    return REG if CASES[case][2] is not None else (0.0, 0.0)


@functools.lru_cache(maxsize=None)
def _blocked(case, groups=1):
    eps, delta = _reg(case)
    s, c, o = llt_panel_blocked_plain(torch.from_numpy(_slab(case)), eps=eps, delta=delta,
                                      groups=groups)
    return s.numpy(), int(c), bool(o)


@pytest.fixture(scope="module")
def pallas():
    """``llt_panel_v5_pallas`` with every pallas_call interpreted, its result
    cached by case."""
    from jax.experimental import pallas as pl

    import faer_tpu.ops.pallas.llt_panel_v5 as llt5

    orig = pl.pallas_call

    def interp_call(*args, **kwargs):
        kwargs["interpret"] = True
        kwargs.pop("compiler_params", None)
        return orig(*args, **kwargs)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pl, "pallas_call", interp_call)
        llt5.llt_panel_v5_pallas.clear_cache()

        @functools.lru_cache(maxsize=None)
        def run(case):
            eps, delta = _reg(case)
            s, c, o = llt5.llt_panel_v5_pallas(jnp.asarray(_slab(case)), eps=eps, delta=delta)
            return np.asarray(s), int(c), bool(o)

        yield run
        llt5.llt_panel_v5_pallas.clear_cache()


@pytest.mark.parametrize("case", list(CASES))
def test_blocked_matches_pallas(case, pallas):
    """The kernel's order against the Pallas kernel: count and ok equal, L11
    within 8·b·eps_f32, L21 within 8·b·2⁻¹⁶ (bf16x3 on the TPU side)."""
    m, b, tiny = CASES[case]
    s_j, c_j, o_j = pallas(case)
    s_t, c_t, o_t = _blocked(case)
    assert c_t == c_j == (1 if tiny is not None else 0)
    assert o_t == o_j is True
    assert np.all(np.isfinite(s_t)) and np.all(np.triu(s_t[:b], 1) == 0)
    assert_approx_eq(s_t[:b], s_j[:b], scale=size_scale(b), tol_dtype=np.float32)
    if m > b:
        tol = 8 * b * U3 * np.abs(s_j[b:]).max()
        assert_approx_eq(s_t[b:], s_j[b:], abs_tol=tol, rel_tol=8 * b * U3)


@pytest.mark.parametrize("case", PLAIN)
def test_blocked_matches_f64(case):
    """L11 against an f64 Cholesky factor of A11's lower triangle and L21
    against the f64 solve A21·L11⁻ᵀ, within 8·b·eps_f32 of max|L|."""
    m, b, _ = CASES[case]
    s64 = _slab(case).astype(np.float64)
    l11 = np.linalg.cholesky(np.nan_to_num(np.tril(s64[:b]), nan=0.0)
                             + np.nan_to_num(np.tril(s64[:b], -1), nan=0.0).T)
    want = np.vstack([l11, np.linalg.solve(l11, s64[b:].T).T])
    got = _blocked(case)[0]
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= 8 * b * EPS32


@pytest.mark.parametrize("case", list(CASES))
def test_blocked_matches_plain(case):
    """Against ``llt_panel_plain`` (the Pallas body's math in FP32): count
    and ok equal, within 8·b·eps_f32 of max|L|."""
    m, b, _ = CASES[case]
    eps, delta = _reg(case)
    s_p, c_p, o_p = llt_panel_plain(torch.from_numpy(_slab(case)), eps=eps, delta=delta)
    s_t, c_t, o_t = _blocked(case)
    assert int(c_p) == c_t and bool(o_p) == o_t
    err = np.abs(s_t - s_p.numpy()).max() / np.abs(s_p.numpy()).max()
    assert err <= 8 * b * EPS32


@pytest.mark.parametrize("case", ["160x32", "100x64", "200x96", "256x64-reg"])
def test_blocked_bits_do_not_depend_on_the_row_groups(case):
    """Rows split into 1, 3 or 16 groups of whole tiles, as the kernel's
    CTAs hold them, and any prefix of the slab's rows: the same bits."""
    m, b, _ = CASES[case]
    eps, delta = _reg(case)
    s1, c1, o1 = _blocked(case)
    for groups in (3, 16):
        s, c, o = _blocked(case, groups)
        assert np.array_equal(s, s1) and c == c1 and o == o1
    pre = llt_panel_blocked_plain(torch.from_numpy(_slab(case)[:b + 7]), eps=eps,
                                  delta=delta)[0].numpy()
    assert np.array_equal(pre, s1[:b + 7])


def _regularized(m, b, bad, seed):
    """A = L Lᵀ − 1e-3·Σ e_k e_kᵀ over the ``bad`` columns k, L's column k
    zero and its diagonal elsewhere in [1.5, 2.5]: the bad pivots are
    clearly negative and every other one at least 2.25 whatever replaces a
    bad one; rows past b Gaussian."""
    rng = np.random.default_rng(seed)
    lo = np.tril(rng.standard_normal((b, b)) / np.sqrt(b), -1)
    lo += np.diag(1.5 + rng.random(b))
    lo[:, list(bad)] = 0.0
    a = lo @ lo.T
    a[list(bad), list(bad)] -= 1e-3
    return np.vstack([a, rng.standard_normal((m - b, b))]).astype(np.float32)


@pytest.mark.parametrize("eps", [1.0, 0.0])
def test_blocked_negative_pivots(eps):
    """Negative pivots at columns 3, 40 and 63: with eps > 0 each is counted
    and replaced by eps, without each becomes 1; ok is false either way.
    Against ``llt_panel_plain``: count and ok equal, within 8·b·eps_f32."""
    m, b = 150, 64
    slab = torch.from_numpy(_regularized(m, b, (3, 40, 63), 7))
    s_t, c_t, o_t = llt_panel_blocked_plain(slab, eps=eps, delta=1e-2)
    s_p, c_p, o_p = llt_panel_plain(slab, eps=eps, delta=1e-2)
    assert int(c_t) == int(c_p) == (3 if eps > 0 else 0)
    assert not bool(o_t) and not bool(o_p)
    assert torch.isfinite(s_t).all()
    assert ((s_t - s_p).abs().max() / s_p.abs().max()).item() <= 8 * b * EPS32


@pytest.mark.parametrize("fn", ["blocked", "wrapper"])
def test_row_strided_views_equal_contiguous(fn):
    """A (m, b) view of row stride 1024, as the fused LLT route hands its
    panels over (``pblock[:, :bw]`` of a 1024-wide strip), gives the same
    bits as a contiguous copy."""
    m, b = 200, 64
    slab = torch.from_numpy(_spd_slab(m, b, 3))
    wide = torch.full((m, 1024), float("nan"))
    wide[:, :b] = slab
    view = wide[:, :b]
    assert view.stride() == (1024, 1)
    run = llt_panel_blocked_plain if fn == "blocked" else llt_panel
    for x, y in zip(run(view), run(slab)):
        assert torch.equal(x, y)


def test_wrapper_refusals():
    """What the wrapper refuses before any launch: m < b, a 1-D or float64
    input, b not a multiple of 32 or above 512, columns not contiguous; the
    blocked order refuses b not a multiple of 32."""
    with pytest.raises(ShapeError):
        llt_panel(torch.zeros(32, 64))
    with pytest.raises(ShapeError):
        llt_panel(torch.zeros(64))
    with pytest.raises(TypeError):
        llt_panel(torch.zeros(64, 32, dtype=torch.float64))
    with pytest.raises(ShapeError):
        launch(torch.zeros(64, 48), 0.0, 0.0)
    with pytest.raises(ShapeError):
        launch(torch.zeros(600, 544), 0.0, 0.0)
    with pytest.raises(ValueError):
        launch(torch.zeros(64, 128)[:, ::2], 0.0, 0.0)
    with pytest.raises(ShapeError):
        llt_panel_blocked_plain(torch.zeros(64, 48))


@pytest.mark.parametrize("tool", ["torch_split.py", "torch_profile.py"])
def test_llt_panel_tools_exit_without_a_card_and_import_no_jax(tool):
    """The per-call/device split and the phase profile of the LLT panel
    refuse to run without a card, printing no result; loading them and the
    port's LLT modules loads neither JAX nor the JAX package."""
    path = os.path.join(REPO, "tools", tool)
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, path, "llt_panel"], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and "{" not in proc.stdout and "(4096" not in proc.stdout
    assert "CUDA card" in proc.stderr
    code = ("import sys, runpy, faer_tpu_torch.ops.kernels.llt_panel, "
            "faer_tpu_torch.linalg.cholesky; "
            f"runpy.run_path({path!r}); "
            "bad = sorted(m for m in sys.modules if m in ('jax', 'faer_tpu') "
            "or m.startswith(('jax.', 'faer_tpu.'))); assert not bad, bad")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
