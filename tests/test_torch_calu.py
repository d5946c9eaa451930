"""The CALU tournament leaf and the LU panel kernels v2, v3 and v1 of the
port against the JAX package.

The plain PyTorch versions in ``faer_tpu_torch/ops/kernels`` (what each
wrapper runs for a CPU tensor) are compared with their Pallas kernels run in
interpret mode on the CPU, and ``_lu_leaf_calu`` with the JAX package's, on
the same numpy inputs. Pivots are well separated (``_separated_panel``), so
``perm``, ``nt`` and ``ok`` must match exactly; the v2 and v3 dots are
HIGHEST, so the packed factors agree within faer's 8·m·eps_f32.
"""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import faer_tpu.linalg.lu as jlu
from faer_tpu_torch.core.config import KERNELS, launch_counts, reset_launch_counts
from faer_tpu_torch.core.errors import ShapeError
from faer_tpu_torch.linalg import lu as tlu
from faer_tpu_torch.ops.kernels.lu_panel_swap import lu_panel_swap, lu_panel_swap_plain
from faer_tpu_torch.ops.kernels.lu_panel_v2 import (
    lu_panel_v2, lu_panel_v2_batched, lu_panel_v2_plain)
from faer_tpu_torch.ops.kernels.lu_panel_v3 import lu_panel_v3, lu_panel_v3_plain
from faer_tpu_torch.utils.approx import assert_approx_eq, size_scale

torch.set_num_threads(1)

EPS32 = float(np.finfo(np.float32).eps)


@pytest.fixture
def interp(monkeypatch):
    """Route every pallas_call through the interpreter (as in
    tests/test_pallas_kernels.py) and drop cached traces of the kernels."""
    from jax.experimental import pallas as pl

    import faer_tpu.ops.pallas.lu_panel_v2 as v2
    import faer_tpu.ops.pallas.lu_panel_v3 as v3
    import faer_tpu.ops.pallas.panel_kernels as pk

    orig = pl.pallas_call

    def interp_call(*args, **kwargs):
        kwargs["interpret"] = True
        kwargs.pop("compiler_params", None)
        return orig(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", interp_call)
    fns = (v2.lu_panel_v2_pallas, v3.lu_panel_v3_pallas, pk.lu_panel_pallas)
    for fn in fns:
        fn.clear_cache()
    yield types.SimpleNamespace(v2=v2.lu_panel_v2_pallas, v3=v3.lu_panel_v3_pallas,
                                swap=pk.lu_panel_pallas)
    for fn in fns:
        fn.clear_cache()


def _separated_panel(m, b, rng):
    """P·L·U with |L| ≤ 1/(2√b) below a unit diagonal: every pivot beats the
    other candidates by 2√b, under any rounding (as in chip_smoke.py)."""
    lo = np.tril(rng.uniform(-0.5, 0.5, (m, b)) / np.sqrt(b), -1) + np.eye(m, b)
    up = (np.triu(rng.standard_normal((b, b)), 1) / np.sqrt(b)
          + np.diag(1 + rng.uniform(size=b)))
    p = rng.permutation(m)
    a = np.empty((m, b))
    a[p] = lo @ up
    return a.astype(np.float32), p


def _lu_residual(a, packed, perm):
    """‖A[perm] − L·U‖ / ‖A‖ in f64 for a packed (m, n) factor."""
    m, n = a.shape
    k = min(m, n)
    pk = packed.astype(np.float64)
    lo = np.tril(pk[:, :k], -1) + np.eye(m, k)
    ref = a.astype(np.float64)[perm]
    return np.linalg.norm(lo @ np.triu(pk[:k]) - ref) / np.linalg.norm(ref)


def _perm_parity(perm):
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


PLAIN = {"v2": lu_panel_v2_plain, "v3": lu_panel_v3_plain, "swap": lu_panel_swap_plain}


@pytest.mark.parametrize("kernel", ["v2", "v3", "swap"])
@pytest.mark.parametrize("m,b", [(96, 24), (130, 20)])
def test_plain_matches_pallas(kernel, m, b, interp):
    """(130, 20) is ragged for both layouts: rows not a multiple of 128 (v2,
    v3) and columns not of 128 (v1)."""
    rng = np.random.default_rng(m * b)
    panel, p = _separated_panel(m, b, rng)
    k_j, p_j, n_j, o_j = getattr(interp, kernel)(jnp.asarray(panel))
    k_t, p_t, n_t, o_t = PLAIN[kernel](torch.from_numpy(panel))
    p_t = p_t.numpy()
    np.testing.assert_array_equal(p_t, np.asarray(p_j))
    np.testing.assert_array_equal(p_t[:b], p[:b])  # the pivot rows, in order
    assert int(n_t) == int(n_j) and bool(o_t) and bool(o_j)
    assert int(n_t) % 2 == _perm_parity(p_t)
    assert_approx_eq(k_t.numpy(), np.asarray(k_j), scale=size_scale(m),
                     tol_dtype=np.float32)
    assert _lu_residual(panel, k_t.numpy(), p_t) <= 8 * m * EPS32


def test_swap_counts_swaps_and_v2_counts_transpositions():
    """The two contracts of nt on one panel: v1 counts the steps whose pivot
    was not in place, v2 the minimal transpositions of its perm."""
    rng = np.random.default_rng(5)
    panel, p = _separated_panel(130, 20, rng)
    _, p1, n1, _ = lu_panel_swap_plain(torch.from_numpy(panel))
    _, p2, n2, _ = lu_panel_v2_plain(torch.from_numpy(panel))
    cur = list(range(130))
    swaps = 0
    for j in range(20):  # replay the swaps from the known pivot rows
        pos = cur.index(p[j])
        swaps += pos != j
        cur[j], cur[pos] = cur[pos], cur[j]
    np.testing.assert_array_equal(p1.numpy(), cur)
    assert int(n1) == swaps
    assert int(n1) % 2 == int(n2) % 2 == _perm_parity(p2.numpy())
    np.testing.assert_array_equal(p1.numpy()[:20], p2.numpy()[:20])


def test_batched_plain_is_each_panel_plain():
    rng = np.random.default_rng(6)
    panels = np.stack([_separated_panel(64, 16, rng)[0] for _ in range(3)])
    got = lu_panel_v2_batched(torch.from_numpy(panels))
    assert [tuple(x.shape) for x in got] == [(3, 64, 16), (3, 64), (3,), (3,)]
    for q in range(3):
        for g, w in zip(got, lu_panel_v2(torch.from_numpy(panels[q]))):
            assert torch.equal(g[q], w)


def test_calu_leaf_matches_jax(interp):
    """(200, 16) in groups of 64: four groups, the last padded with 56 zero
    rows; perm, nt and ok exactly, packed within 8·m·eps."""
    m, b = 200, 16
    rng = np.random.default_rng(7)
    panel, p = _separated_panel(m, b, rng)
    k_j, p_j, n_j, o_j = jlu._lu_leaf_calu(jnp.asarray(panel), group=64)
    k_t, p_t, n_t, o_t = tlu._lu_leaf_calu(torch.from_numpy(panel), group=64)
    p_t = p_t.numpy()
    np.testing.assert_array_equal(p_t, np.asarray(p_j))
    np.testing.assert_array_equal(p_t[:b], p[:b])
    assert int(n_t) == int(n_j) and bool(o_t) and bool(o_j)
    assert_approx_eq(k_t.numpy(), np.asarray(k_j), scale=size_scale(m),
                     tol_dtype=np.float32)
    assert _lu_residual(panel, k_t.numpy(), p_t) <= 8 * m * EPS32


@pytest.mark.parametrize("shape", [(300, 40), (300, 300)])
def test_lu_in_place_through_calu(shape, monkeypatch):
    """With the gate at 64 every leaf taller than 64 rows is a tournament:
    A[perm] = L·U and the solve residual within 8·max(m, n)·eps of f64."""
    m, n = shape
    calls = []
    leaf = tlu._lu_leaf_calu
    monkeypatch.setattr(tlu, "_CALU_GROUP", 64)
    monkeypatch.setattr(tlu, "_lu_leaf_calu",
                        lambda panel, group: calls.append(panel.shape) or leaf(panel, group))
    rng = np.random.default_rng(m + n)
    a = rng.standard_normal((m, n)).astype(np.float32)
    lu, perm, info = tlu.lu_in_place(torch.from_numpy(a))
    # (300, 40): one 40-wide leaf; 300²: leaves of 64 columns, all but the
    # last (44 rows) taller than 64
    assert calls == ([(300, 40)] if n == 40 else
                     [(300 - k, 64) for k in range(0, 256, 64)])
    tol = 8 * max(m, n) * EPS32
    assert bool(info.success)
    assert int(info.transposition_count) % 2 == _perm_parity(perm.numpy())
    assert _lu_residual(a, lu.numpy(), perm.numpy()) <= tol
    if m == n:
        rhs = rng.standard_normal((n, 8)).astype(np.float32)
        x = tlu.lu_solve(lu, perm, torch.from_numpy(rhs)).numpy().astype(np.float64)
        a64 = a.astype(np.float64)
        res = np.linalg.norm(a64 @ x - rhs) / (np.linalg.norm(a64) * np.linalg.norm(x))
        assert res <= tol


@pytest.mark.parametrize("shape", [(300, 40), (300, 300)])
def test_default_gate_never_takes_calu(shape, monkeypatch):
    """At the default gate the recursive driver keeps its lu_leaf leaves and
    matches faer_tpu's lu_in_place on separated pivots: the same pivot rows,
    the factors within 8·m·eps."""
    def refuse(*args):
        raise AssertionError("_lu_leaf_calu reached at the default gate")

    monkeypatch.setattr(tlu, "_lu_leaf_calu", refuse)
    m, n = shape
    rng = np.random.default_rng(9 + n)
    a, p = _separated_panel(m, n, rng)
    lu_t, perm_t, info_t = tlu.lu_in_place(torch.from_numpy(a))
    lu_j, perm_j, info_j = jlu.lu_in_place(jnp.asarray(a))
    perm_t, perm_j = perm_t.numpy(), np.asarray(perm_j)
    # the pivot rows exactly; below them the JAX CPU panel leaves the swap
    # order, the port's leaf the original one: compare the factors row by
    # row of A
    np.testing.assert_array_equal(perm_t[:n], p[:n])
    np.testing.assert_array_equal(perm_t[:n], perm_j[:n])
    assert int(info_t.transposition_count) % 2 == _perm_parity(perm_t)
    assert int(info_j.transposition_count) % 2 == _perm_parity(perm_j)
    assert_approx_eq(lu_t.numpy()[np.argsort(perm_t)],
                     np.asarray(lu_j)[np.argsort(perm_j)], scale=size_scale(m),
                     tol_dtype=np.float32)


def test_cpu_wrappers_take_the_plain_version_and_count_nothing():
    panel = torch.from_numpy(_separated_panel(64, 16, np.random.default_rng(4))[0])
    reset_launch_counts()
    for wrapper, plain in ((lu_panel_v2, lu_panel_v2_plain),
                           (lu_panel_v3, lu_panel_v3_plain),
                           (lu_panel_swap, lu_panel_swap_plain)):
        for got, want in zip(wrapper(panel), plain(panel)):
            assert torch.equal(got, want)
    assert launch_counts() == dict.fromkeys(KERNELS, 0)


@pytest.mark.parametrize("call", [
    lambda: lu_panel_v2(torch.zeros(16, 8, dtype=torch.float64)),
    lambda: lu_panel_v2(torch.zeros(8)),
    lambda: lu_panel_v3(torch.zeros(16, 8, dtype=torch.float64)),
    lambda: lu_panel_v3(torch.zeros(8)),
    lambda: lu_panel_swap(torch.zeros(16, 8, dtype=torch.float64)),
    lambda: lu_panel_swap(torch.zeros(8)),
    lambda: lu_panel_v2_batched(torch.zeros(2, 16, 8, dtype=torch.float64)),
    lambda: lu_panel_v2_batched(torch.zeros(16, 8)),
    lambda: lu_panel_v2_batched(torch.zeros(2, 8, 16)),
])
def test_wrappers_reject_bad_inputs(call):
    with pytest.raises((TypeError, ShapeError)):
        call()
