"""The blocked LU panel order against the Pallas LU panels, on the CPU.

``lu_panel_blocked_plain`` repeats, step for step, the order of the one
Hopper kernel behind ``lu_panel``, ``lu_leaf``, ``lu_panel_v2`` and
``lu_panel_v3`` (``csrc/lu_panel_batched.cu``): rank-1 steps inside
``sb``-column working blocks, U₁₂ by unit-lower substitution, one deferred
update of the later columns a sub-block, the rows split into groups as the
kernel's CTAs hold them, the result written in packed order. Here it is
held, at sb ∈ {16, 32}, against the four Pallas kernels those wrappers
replace (``lu_panel_v5_pallas``, ``lu_panel_v4_pallas``,
``lu_panel_v2_pallas``, ``lu_panel_v3_pallas``) in interpret mode, against
``lu_panel_plain`` (the wrappers' CPU route), and against itself in f64.
The v5 kernel's deferred couplings are bf16x3, so its comparisons use the
bf16x3 unit roundoff 2⁻¹⁶ in place of eps in faer's 8·m rule; the others
use 8·m·eps_f32.
"""
import functools
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faer_tpu_torch.ops.kernels.lu_panel import (
    _assemble, _blocked_virtual, _packed_order, lu_panel_blocked_plain, lu_panel_plain)
from faer_tpu_torch.utils.approx import assert_approx_eq, size_scale

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EPS32 = float(np.finfo(np.float32).eps)
U3 = 2.0 ** -16  # unit roundoff of a bf16x3 product
PALLAS = ("v5", "v4", "v2", "v3")
SUB_BLOCKS = (16, 32)


@pytest.fixture(scope="module")
def pallas():
    """The four Pallas LU panels with every pallas_call interpreted, each
    result cached by (kernel, case), so that both sub-block widths are held
    against one interpreted run."""
    from jax.experimental import pallas as pl

    import faer_tpu.ops.pallas.leaf_v4 as leaf4
    import faer_tpu.ops.pallas.lu_panel_v2 as v2
    import faer_tpu.ops.pallas.lu_panel_v3 as v3
    import faer_tpu.ops.pallas.lu_panel_v5 as v5

    orig = pl.pallas_call

    def interp_call(*args, **kwargs):
        kwargs["interpret"] = True
        kwargs.pop("compiler_params", None)
        return orig(*args, **kwargs)

    fns = {"v5": functools.partial(v5.lu_panel_v5_pallas, sb=16, win=False),
           "v4": leaf4.lu_panel_v4_pallas, "v2": v2.lu_panel_v2_pallas,
           "v3": v3.lu_panel_v3_pallas}
    jitted = (v5.lu_panel_v5_pallas, leaf4.lu_panel_v4_pallas, v2.lu_panel_v2_pallas,
              v3.lu_panel_v3_pallas)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pl, "pallas_call", interp_call)
        for fn in jitted:
            fn.clear_cache()

        @functools.lru_cache(maxsize=None)
        def run(kernel, case):
            k, p, n, o = fns[kernel](jnp.asarray(CASES[case]()))
            return np.asarray(k), np.asarray(p), int(n), bool(o)

        yield run
        for fn in jitted:
            fn.clear_cache()


def _separated(m, b, seed):
    """P·L·U with |L| ≤ 1/(2√b) below a unit diagonal: every pivot beats the
    other candidates by 2√b under any rounding (as in chip_smoke.py). A wide
    panel (m < b) has an (m, m) L and an (m, b) U."""
    rng = np.random.default_rng(seed)
    k = min(m, b)
    lo = np.tril(rng.uniform(-0.5, 0.5, (m, k)) / np.sqrt(b), -1) + np.eye(m, k)
    up = (np.triu(rng.standard_normal((k, b)), 1) / np.sqrt(b)
          + np.eye(k, b) * (1 + rng.uniform(size=k))[:, None])
    a = np.empty((m, b))
    a[rng.permutation(m)] = lo @ up
    return a.astype(np.float32)


def _gaussian(m, b, seed):
    return np.random.default_rng(seed).standard_normal((m, b)).astype(np.float32)


# named inputs, made from a numpy seed: (96, 32) spans two sub-blocks of
# 16; (130, 20) is ragged for the Pallas layouts (rows not a multiple of
# 128) and, split into 3 groups of 44, for the kernel's CTAs; (16, 40) and
# (20, 33) are wide
CASES = {
    "sep96x32": lambda: _separated(96, 32, 1),
    "sep130x20": lambda: _separated(130, 20, 2),
    "sep16x40": lambda: _separated(16, 40, 3),
    "sep20x33": lambda: _separated(20, 33, 4),
    "gauss96x32": lambda: _gaussian(96, 32, 5),
    "gauss130x20": lambda: _gaussian(130, 20, 6),
    "gauss100x48": lambda: _gaussian(100, 48, 7),
}


def _residual(a, packed, perm):
    """‖A[perm] − L·U‖ / ‖A‖ in f64 for a packed (m, n) factor."""
    m, n = a.shape
    k = min(m, n)
    pk = packed.astype(np.float64)
    lo = np.tril(pk[:, :k], -1) + np.eye(m, k)
    ref = a.astype(np.float64)[perm]
    return np.linalg.norm(lo @ np.triu(pk[:k]) - ref) / np.linalg.norm(ref)


def _parity(perm):
    seen = np.zeros(len(perm), bool)
    swaps = 0
    for i in range(len(perm)):
        j, cyc = i, 0
        while not seen[j]:
            seen[j] = True
            j = perm[j]
            cyc += 1
        swaps += max(cyc - 1, 0)
    return swaps % 2


def _blocked(a, sb, groups=1):
    k, p, n, o = lu_panel_blocked_plain(torch.from_numpy(a), sb=sb, groups=groups)
    return k.numpy(), p.numpy(), int(n), bool(o)


def _tol(kernel, m):
    return 8 * m * (U3 if kernel == "v5" else EPS32)


@pytest.mark.parametrize("sb", SUB_BLOCKS)
@pytest.mark.parametrize("kernel", PALLAS)
@pytest.mark.parametrize("case", ["sep96x32", "sep130x20", "sep16x40", "sep20x33"])
def test_blocked_matches_pallas_separated(case, kernel, sb, pallas):
    """Separated pivots: perm, nt and ok equal to the Pallas kernel's,
    packed within 8·m·u of it (wide panels too: min(m, b) steps, the whole
    panel back), A[perm] = L·U to 8·max(m, b)·eps in f64."""
    a = CASES[case]()
    m, b = a.shape
    k_j, p_j, n_j, o_j = pallas(kernel, case)
    k_t, p_t, n_t, o_t = _blocked(a, sb, groups=3)
    assert k_t.shape == (m, b)
    np.testing.assert_array_equal(p_t, p_j)
    assert n_t == n_j and o_t and o_j
    tol = _tol(kernel, m)
    assert_approx_eq(k_t, k_j, abs_tol=tol * np.abs(k_j).max(), rel_tol=tol)
    assert _residual(a, k_t, p_t) <= 8 * max(m, b) * EPS32


@pytest.mark.parametrize("sb", SUB_BLOCKS)
@pytest.mark.parametrize("case", ["sep96x32", "sep130x20", "sep16x40"])
def test_blocked_matches_plain_and_f64(case, sb):
    """Separated pivots: perm, nt and ok equal to ``lu_panel_plain``'s
    (the Pallas body's order, every wrapper's CPU route) and to the same
    order run in f64; packed within 8·m·eps of both."""
    a = CASES[case]()
    m, _ = a.shape
    k_t, p_t, n_t, o_t = _blocked(a, sb)
    k_p, p_p, n_p, o_p = (x.numpy() if torch.is_tensor(x) and x.dim() else x
                          for x in lu_panel_plain(torch.from_numpy(a)))
    k_d, p_d, n_d, o_d = lu_panel_blocked_plain(torch.from_numpy(a).double(), sb=sb)
    np.testing.assert_array_equal(p_t, p_p)
    np.testing.assert_array_equal(p_t, p_d.numpy())
    assert n_t == int(n_p) == int(n_d) and o_t and bool(o_p) and bool(o_d)
    for ref in (k_p, k_d.numpy()):
        assert_approx_eq(k_t, ref, scale=size_scale(m), tol_dtype=np.float32)


@pytest.mark.parametrize("sb", SUB_BLOCKS)
@pytest.mark.parametrize("case", ["gauss96x32", "gauss130x20", "gauss100x48"])
def test_blocked_gaussian(case, sb, pallas):
    """Gaussian panels (pivots may tie-break differently under other
    roundings): ‖A[perm] − L·U‖/‖A‖ ≤ 8·m·eps in f64, |L| ≤ 1, and nt's
    parity that of perm, for the blocked order and for the Pallas v5
    kernel alike."""
    a = CASES[case]()
    m, _ = a.shape
    results = [_blocked(a, sb), pallas("v5", case)]
    for packed, perm, nt, ok in results:
        assert ok
        assert _residual(a, packed, perm) <= 8 * m * EPS32
        assert np.abs(np.tril(packed, -1)).max() <= 1 + 1e-6
        assert nt % 2 == _parity(perm)


@pytest.mark.parametrize("sb", SUB_BLOCKS)
def test_blocked_zero_column_reports_failure(sb):
    """An all-zero column: ok is false, as in ``lu_panel_plain``."""
    a = _gaussian(96, 40, 8)
    a[:, 21] = 0
    _, _, _, ok = _blocked(a, sb, groups=3)
    assert not ok
    assert not bool(lu_panel_plain(torch.from_numpy(a))[3])


@pytest.mark.parametrize("sb", SUB_BLOCKS)
def test_blocked_nan_wins_the_pivot(sb):
    """A NaN wins the search of its column (it counts as +inf), and its
    column's multipliers become NaN, ok staying true. Before its column the
    pivots equal ``lu_panel_plain``'s. (From there on the two orders part:
    the Pallas body and ``lu_panel_plain`` select the pivot row's later
    entries by a one-hot product, which spreads the NaN over its whole
    column at the sub-block's first step; the kernel reads the pivot row.)"""
    a = _separated(64, 24, 9)
    row = 41
    a[row, 3] = np.nan
    k_t, p_t, _, o_t = _blocked(a, sb, groups=3)
    _, p_p, _, o_p = lu_panel_plain(torch.from_numpy(a))
    assert p_t[3] == row
    np.testing.assert_array_equal(p_t[:3], p_p.numpy()[:3])
    assert o_t and bool(o_p)
    assert np.isnan(k_t[4:, 3]).all() and not np.isnan(k_t[:3]).any()


@pytest.mark.parametrize("sb", SUB_BLOCKS)
@pytest.mark.parametrize("groups", [1, 3, 16])
def test_blocked_ties_go_to_the_lowest_row(sb, groups):
    """Exact ties in |v| go to the lowest row, across groups too: rows 5
    and 70 hold ∓3 in column 0 (its largest entries), and rows 9 and 71 ±4
    in column 1, which step 0 leaves exact (row 5, the pivot row, holds 0
    there)."""
    a = np.clip(_gaussian(100, 32, 10), -1, 1)
    a[5, 0], a[70, 0] = -3.0, 3.0
    a[5, 1] = 0.0
    a[9, 1], a[71, 1] = 4.0, -4.0
    _, p_t, _, _ = _blocked(a, sb, groups)
    assert p_t[0] == 5
    assert p_t[1] == 9


@pytest.mark.parametrize("case", ["gauss130x20", "gauss100x48", "sep16x40"])
def test_blocked_bits_do_not_depend_on_the_row_groups(case):
    """The row-partition rule in its CPU form: the rows split into 1, 3 or
    16 groups (as 1, 3 or 16 CTAs hold them; 130 and 100 rows are not
    multiples of 3 or 16) give the same bits."""
    a = CASES[case]()
    outs = [lu_panel_blocked_plain(torch.from_numpy(a), groups=g) for g in (1, 3, 16)]
    for out in outs[1:]:
        for x, y in zip(out, outs[0]):
            assert torch.equal(x, y)


@pytest.mark.parametrize("case", ["gauss130x20", "sep16x40", "sep96x32"])
def test_packed_order_equals_assemble(case):
    """The kernel's packed-order writes (pivot row of step k to row k, each
    unused row to kmax plus the unused rows above it) against
    ``_assemble``'s scatter, argsort and gather, on the blocked order's own
    virtual-pivot panel."""
    v, pidx, ok = _blocked_virtual(torch.from_numpy(CASES[case]()), sb=16, groups=1)
    packed, perm = _packed_order(v, pidx)
    packed2, perm2, _, _ = _assemble(v, pidx, ok)
    assert torch.equal(perm, perm2)
    assert torch.equal(packed, packed2)


@pytest.mark.parametrize("tool", ["torch_split.py", "torch_profile.py"])
def test_lu_tools_exit_without_a_card_and_import_no_jax(tool):
    """The per-call/device split and the phase profile of the LU panel
    refuse to run without a card, printing no result; loading them and the
    port's LU modules loads neither JAX nor the JAX package."""
    path = os.path.join(REPO, "tools", tool)
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, path, "lu"], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and "{" not in proc.stdout and "(4096" not in proc.stdout
    assert "CUDA card" in proc.stderr
    code = ("import sys, runpy, faer_tpu_torch.ops.kernels.lu_panel, "
            "faer_tpu_torch.linalg.lu; "
            f"runpy.run_path({path!r}); "
            "bad = sorted(m for m in sys.modules if m in ('jax', 'faer_tpu') "
            "or m.startswith(('jax.', 'faer_tpu.'))); assert not bad, bad")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
