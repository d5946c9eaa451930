"""The port's kernel modules against the JAX package's Pallas kernels.

Each plain PyTorch version in ``faer_tpu_torch/ops/kernels`` (what a kernel
wrapper runs for a CPU tensor) is compared with its Pallas kernel run in
interpret mode on the CPU, on the same numpy inputs. The Pallas LLT panel's
L21 product and the LU and QR panels' deferred couplings are bf16x3 while
the port is FP32, so those comparisons use the bf16x3 unit roundoff 2⁻¹⁶ in
place of eps in faer's 8·n rule; everything else (the v4 leaves' dots are
HIGHEST) uses 8·n·eps_f32.
"""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faer_tpu_torch.core.config import launch_counts, reset_launch_counts
from faer_tpu_torch.core.config import KERNELS
from faer_tpu_torch.ops.kernels.leaf import (
    llt_leaf, llt_leaf_plain, lu_leaf, lu_leaf_plain)
from faer_tpu_torch.ops.kernels.llt_panel import llt_panel, llt_panel_plain
from faer_tpu_torch.ops.kernels.lu_panel import lu_panel, lu_panel_plain
from faer_tpu_torch.ops.kernels.qr_panel import qr_panel, qr_panel_plain
from faer_tpu_torch.ops.kernels.trtri import trtri, trtri_plain
from faer_tpu_torch.utils.approx import assert_approx_eq, size_scale

torch.set_num_threads(1)

EPS32 = float(np.finfo(np.float32).eps)
U3 = 2.0 ** -16  # unit roundoff of a bf16x3 product


@pytest.fixture
def interp(monkeypatch):
    """Route every pallas_call through the interpreter (as in
    tests/test_pallas_kernels.py) and drop cached traces of the kernels."""
    from jax.experimental import pallas as pl

    import faer_tpu.ops.pallas.leaf_v4 as leaf4
    import faer_tpu.ops.pallas.llt_panel_v5 as llt5
    import faer_tpu.ops.pallas.lu_panel_v5 as lu5
    import faer_tpu.ops.pallas.panel_kernels as pk
    import faer_tpu.ops.pallas.qr_panel_v5 as qr5

    orig = pl.pallas_call

    def interp_call(*args, **kwargs):
        kwargs["interpret"] = True
        kwargs.pop("compiler_params", None)
        return orig(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", interp_call)
    fns = (pk.trtri_pallas, llt5.llt_panel_v5_pallas, lu5.lu_panel_v5_pallas,
           qr5.qr_panel_v5_pallas, leaf4.llt_block_v4_pallas,
           leaf4.lu_panel_v4_pallas)
    for fn in fns:
        fn.clear_cache()
    yield types.SimpleNamespace(pk=pk, llt5=llt5, lu5=lu5, qr5=qr5, leaf4=leaf4)
    for fn in fns:
        fn.clear_cache()


def _lower_block(n, unit, rng):
    """A well-conditioned lower-triangular block with garbage above the
    diagonal (both versions must read only the lower triangle)."""
    if unit:
        lo = rng.uniform(-1, 1, (n, n)) / np.sqrt(n)
        t = np.tril(lo, -1) + np.eye(n)
    else:
        g = rng.standard_normal((n, n))
        t = np.linalg.cholesky(g @ g.T / n + np.eye(n))
    t = t + np.triu(rng.standard_normal((n, n)), 1)
    return t.astype(np.float32)


@pytest.mark.parametrize("unit", [False, True])
@pytest.mark.parametrize("n", [32, 100, 128])
def test_trtri_plain_matches_pallas(n, unit, interp):
    rng = np.random.default_rng(n + unit)
    t = _lower_block(n, unit, rng)
    want = np.asarray(interp.pk.trtri_pallas(jnp.asarray(t), unit=unit))
    got = trtri(torch.from_numpy(t), unit=unit).numpy()
    # same Neumann + Newton–Schulz math, both in f32: 8·n·eps
    assert_approx_eq(got, want, scale=size_scale(n), tol_dtype=np.float32)
    lo = np.tril(t.astype(np.float64), -1) + (np.eye(n) if unit
                                              else np.diag(np.diag(t)))
    assert_approx_eq(got, np.linalg.inv(lo), scale=size_scale(n),
                     tol_dtype=np.float32)
    assert np.all(np.triu(got, 1) == 0)


def _spd_slab(m, b, rng, tiny_pivot=None):
    g = rng.standard_normal((m, m))
    a = g @ g.T / m + 2 * np.eye(m)
    if tiny_pivot is not None:
        # a PSD-deficient direction: pivot tiny_pivot of A11 becomes ~0
        lo = np.linalg.cholesky(a)
        lo[tiny_pivot, tiny_pivot] = 1e-4
        a = lo @ lo.T
    return a[:, :b].astype(np.float32)


@pytest.mark.parametrize("m,b,sb,reg", [
    (160, 32, 16, None),
    (256, 64, 32, None),
    (160, 32, 16, (1e-3, 1e-6)),
])
def test_llt_panel_plain_matches_pallas(m, b, sb, reg, interp):
    rng = np.random.default_rng(m + b)
    slab = _spd_slab(m, b, rng, tiny_pivot=5 if reg else None)
    # the upper triangle of A11 is never read: poison it
    slab[:b] += np.triu(np.full((b, b), np.nan, np.float32), 1)
    eps, delta = reg or (0.0, 0.0)
    s_j, c_j, o_j = interp.llt5.llt_panel_v5_pallas(
        jnp.asarray(slab), eps=eps, delta=delta, sb=sb)
    s_t, c_t, o_t = llt_panel_plain(torch.from_numpy(slab), eps=eps,
                                    delta=delta, sb=sb)
    s_j = np.asarray(s_j)
    s_t = s_t.numpy()
    assert int(c_j) == int(c_t) == (1 if reg else 0)
    assert bool(o_j) == bool(o_t) is True
    # L11: the same f32 micro-steps on both sides
    assert_approx_eq(s_t[:b], s_j[:b], scale=size_scale(b), tol_dtype=np.float32)
    # L21: bf16x3 on the TPU side
    tol = 8 * b * U3 * np.abs(s_j[b:]).max()
    assert_approx_eq(s_t[b:], s_j[b:], abs_tol=tol, rel_tol=8 * b * U3)
    if reg is None:
        s64 = slab.astype(np.float64)
        l11 = np.linalg.cholesky(np.tril(s64[:b]) + np.tril(s64[:b], -1).T)
        assert_approx_eq(s_t[:b], l11, scale=size_scale(b), tol_dtype=np.float32)
        assert_approx_eq(s_t[b:], np.linalg.solve(l11, s64[b:].T).T,
                         scale=size_scale(m), tol_dtype=np.float32)


def _separated_panel(m, b, rng):
    """P·L·U with |L| ≤ 1/(2√b) below a unit diagonal: every pivot beats the
    other candidates by 2√b. Off-diagonal entries are O(1/√b) so that L and
    U stay well conditioned (random triangular matrices with O(1) entries
    are exponentially ill conditioned, and rounding would reorder pivots).
    A wide panel (m < b) has an (m, m) L and an (m, b) U."""
    k = min(m, b)
    lo = np.tril(rng.uniform(-0.5, 0.5, (m, k)) / np.sqrt(b), -1) + np.eye(m, k)
    up = (np.triu(rng.standard_normal((k, b)), 1) / np.sqrt(b)
          + np.eye(k, b) * (1 + rng.uniform(size=k))[:, None])
    p = rng.permutation(m)
    a = np.empty((m, b))
    a[p] = lo @ up
    return a.astype(np.float32), p


def _perm_sign(perm):
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


def _lu_residual(panel, packed, perm):
    m, b = panel.shape
    k = min(m, b)
    pk = packed.astype(np.float64)
    lo = np.tril(pk[:, :k], -1) + np.eye(m, k)
    ref = panel.astype(np.float64)[perm]
    return np.linalg.norm(lo @ np.triu(pk[:k]) - ref) / np.linalg.norm(ref)


@pytest.mark.parametrize("m,b,sb", [(160, 32, 16), (256, 64, 16)])
def test_lu_panel_plain_matches_pallas_separated(m, b, sb, interp):
    rng = np.random.default_rng(m * b)
    panel, p = _separated_panel(m, b, rng)
    k_j, p_j, n_j, o_j = interp.lu5.lu_panel_v5_pallas(jnp.asarray(panel),
                                                       sb=sb, win=False)
    k_t, p_t, n_t, o_t = lu_panel_plain(torch.from_numpy(panel), sb=sb)
    np.testing.assert_array_equal(p_t.numpy(), np.asarray(p_j))
    assert int(n_t) == int(n_j)
    assert bool(o_t) and bool(o_j)
    # the pivot rows are P's first b rows in order
    np.testing.assert_array_equal(p_t.numpy()[:b], p[:b])
    k_j = np.asarray(k_j)
    tol = 8 * m * U3 * np.abs(k_j).max()
    assert_approx_eq(k_t.numpy(), k_j, abs_tol=tol, rel_tol=8 * m * U3)


@pytest.mark.parametrize("m,b,sb", [(160, 32, 16), (256, 64, 16)])
def test_lu_panel_plain_matches_pallas_generic(m, b, sb, interp):
    rng = np.random.default_rng(m + 7 * b)
    panel = rng.standard_normal((m, b)).astype(np.float32)
    k_j, p_j, n_j, o_j = interp.lu5.lu_panel_v5_pallas(jnp.asarray(panel),
                                                       sb=sb)
    k_t, p_t, n_t, o_t = lu_panel_plain(torch.from_numpy(panel), sb=sb)
    for packed, perm, nt in ((np.asarray(k_j), np.asarray(p_j), int(n_j)),
                             (k_t.numpy(), p_t.numpy(), int(n_t))):
        assert _lu_residual(panel, packed, perm) <= 8 * m * EPS32
        assert nt % 2 == _perm_sign(perm)
        assert np.abs(np.tril(packed, -1)).max() <= 1 + 1e-6
    assert int(n_t) % 2 == int(n_j) % 2
    assert bool(o_t) and bool(o_j)


def test_lu_panel_zero_column_reports_failure():
    panel = np.random.default_rng(1).standard_normal((96, 32)).astype(np.float32)
    panel[:, 7] = 0
    _, _, _, ok = lu_panel_plain(torch.from_numpy(panel))
    assert not bool(ok)


@pytest.mark.parametrize("m,b,zero_col", [(160, 32, None), (200, 40, None),
                                           (160, 32, 5)])
def test_qr_panel_plain_matches_pallas(m, b, zero_col, interp):
    """Gaussian panels; ``zero_col``: an all-zero column, whose tail stays
    exactly zero under every reflector, so τ = 0 and β = α = 0 there."""
    import scipy.linalg

    rng = np.random.default_rng(m + b)
    panel = rng.standard_normal((m, b)).astype(np.float32)
    if zero_col is not None:
        panel[:, zero_col] = 0.0
    k_j, t_j = interp.qr5.qr_panel_v5_pallas(jnp.asarray(panel), sb=16)
    k_t, t_t = qr_panel_plain(torch.from_numpy(panel), sb=16)
    k_j, t_j = np.asarray(k_j), np.asarray(t_j)
    k_t, t_t = k_t.numpy(), t_t.numpy()
    k64, t64 = scipy.linalg.qr(panel.astype(np.float64), mode="raw")[0]

    def assert_r_and_v_close(tol, want_k, want_t):
        # R (upper) and the reflector tails V (strict lower) each relative to
        # their own largest entry: the tails are much smaller than R
        for part in (lambda k: np.triu(k[:b]), lambda k: np.tril(k, -1)):
            want = part(want_k)
            assert_approx_eq(part(k_t), want, abs_tol=tol * np.abs(want).max(),
                             rel_tol=tol)
        assert_approx_eq(t_t, want_t, abs_tol=tol, rel_tol=tol)

    # the Pallas couplings are bf16x3: 8·m·u3
    assert_r_and_v_close(8 * m * U3, k_j, t_j)
    # f64 LAPACK geqrf (same larfg signs); a Gaussian (m, b) panel with
    # m ≥ 4b has κ ≤ 3, so the f32 rule 8·m·eps holds for the factor itself
    tol = 8 * m * EPS32
    assert_r_and_v_close(tol, k64, t64)
    # Q = H_0 ⋯ H_{b-1} (in f64) is orthogonal and Q·R = A, to 8·m·eps
    v = np.tril(k_t, -1).astype(np.float64) + np.eye(m, b)
    q = np.eye(m)
    for j in range(b):
        q -= np.outer(q @ v[:, j], v[:, j]) * float(t_t[j])
    q = q[:, :b]
    assert np.abs(q.T @ q - np.eye(b)).max() <= tol
    rec = np.linalg.norm(q @ np.triu(k_t[:b]) - panel) / np.linalg.norm(panel)
    assert rec <= tol
    if zero_col is not None:
        assert float(t_t[zero_col]) == float(t_j[zero_col]) == 0.0
        assert np.all(k_t[zero_col:, zero_col] == 0.0)


@pytest.mark.parametrize("b,reg", [(44, None), (64, None), (44, (1e-3, 1e-6))])
def test_llt_leaf_plain_matches_pallas(b, reg, interp):
    rng = np.random.default_rng(b)
    blk = _spd_slab(b, b, rng, tiny_pivot=5 if reg else None)
    eps, delta = reg or (0.0, 0.0)
    l_j, c_j, o_j = interp.leaf4.llt_block_v4_pallas(jnp.asarray(blk), eps=eps,
                                                     delta=delta)
    l_t, c_t, o_t = llt_leaf_plain(torch.from_numpy(blk), eps=eps, delta=delta)
    assert int(c_j) == int(c_t) == (1 if reg else 0)
    assert bool(o_j) == bool(o_t) is True
    # HIGHEST dots in the v4 kernel: the f32 rule 8·b·eps on both sides
    assert_approx_eq(l_t.numpy(), np.asarray(l_j), scale=size_scale(b),
                     tol_dtype=np.float32)
    if reg is None:
        l64 = np.linalg.cholesky(blk.astype(np.float64))
        assert_approx_eq(l_t.numpy(), l64, scale=size_scale(b), tol_dtype=np.float32)


def test_lu_leaf_plain_matches_pallas(interp):
    m, b = 160, 32
    rng = np.random.default_rng(8)
    # separated pivots: the permutation must match exactly
    panel, p = _separated_panel(m, b, rng)
    k_j, p_j, n_j, o_j = interp.leaf4.lu_panel_v4_pallas(jnp.asarray(panel))
    k_t, p_t, n_t, o_t = lu_leaf_plain(torch.from_numpy(panel))
    np.testing.assert_array_equal(p_t.numpy(), np.asarray(p_j))
    np.testing.assert_array_equal(p_t.numpy()[:b], p[:b])
    assert int(n_t) == int(n_j) and bool(o_t) and bool(o_j)
    assert_approx_eq(k_t.numpy(), np.asarray(k_j), scale=size_scale(m),
                     tol_dtype=np.float32)
    # a Gaussian panel: pivots may differ under rounding, so compare the
    # residual of each factor and the parity of nt
    panel = rng.standard_normal((m, b)).astype(np.float32)
    k_j, p_j, n_j, o_j = interp.leaf4.lu_panel_v4_pallas(jnp.asarray(panel))
    k_t, p_t, n_t, o_t = lu_leaf_plain(torch.from_numpy(panel))
    for packed, perm, nt in ((np.asarray(k_j), np.asarray(p_j), int(n_j)),
                             (k_t.numpy(), p_t.numpy(), int(n_t))):
        assert _lu_residual(panel, packed, perm) <= 8 * m * EPS32
        assert nt % 2 == _perm_sign(perm)
    assert bool(o_t) and bool(o_j)


@pytest.mark.parametrize("m,b", [(16, 40), (24, 56)])
def test_lu_wide_panels_match_pallas(m, b, interp):
    """Wide panels (m < b; (16, 40) is the probe of ROADMAP §3): the v5 panel
    and the v4 leaf take m steps and return the whole (m, b) panel, U₁₂
    right of column m. Separated pivots: perm, nt and ok exactly; the v5
    packed factor under its bf16x3 couplings' rule, the v4 leaf's (HIGHEST
    dots) within 8·m·eps; A[perm] = L·U to 8·b·eps in f64."""
    rng = np.random.default_rng(m + b)
    panel, p = _separated_panel(m, b, rng)
    for pallas, plain, tol in (
            (interp.lu5.lu_panel_v5_pallas, lu_panel, 8 * m * U3),
            (interp.leaf4.lu_panel_v4_pallas, lu_leaf, 8 * m * EPS32)):
        k_j, p_j, n_j, o_j = pallas(jnp.asarray(panel))
        k_t, p_t, n_t, o_t = plain(torch.from_numpy(panel))
        k_j, k_t, p_t = np.asarray(k_j), k_t.numpy(), p_t.numpy()
        assert k_t.shape == (m, b)
        np.testing.assert_array_equal(p_t, np.asarray(p_j))
        np.testing.assert_array_equal(p_t, p)
        assert int(n_t) == int(n_j) and bool(o_t) and bool(o_j)
        assert_approx_eq(k_t, k_j, abs_tol=tol * np.abs(k_j).max(), rel_tol=tol)
        assert _lu_residual(panel, k_t, p_t) <= 8 * b * EPS32


def test_qr_wide_panel_matches_pallas(interp):
    """The (16, 40) probe through the v5 QR panel: 16 reflectors, τ of
    length 16, Qᵀ·A right of column 16; R, V and τ under the bf16x3 rule,
    Q·R = A and QᵀQ = I to 8·b·eps in f64."""
    m, b = 16, 40
    panel = np.random.default_rng(40).standard_normal((m, b)).astype(np.float32)
    k_j, t_j = (np.asarray(x) for x in interp.qr5.qr_panel_v5_pallas(jnp.asarray(panel)))
    k_t, t_t = (x.numpy() for x in qr_panel(torch.from_numpy(panel)))
    assert k_t.shape == (m, b) and t_t.shape == t_j.shape == (m,)
    tol = 8 * m * U3
    for part in (np.triu, lambda k: np.tril(k, -1)):
        want = part(k_j)
        assert_approx_eq(part(k_t), want, abs_tol=tol * np.abs(want).max(), rel_tol=tol)
    assert_approx_eq(t_t, t_j, abs_tol=tol, rel_tol=tol)
    v = np.tril(k_t.astype(np.float64), -1) + np.eye(m, b)
    q = np.eye(m)
    for j in range(m - 1, -1, -1):
        q -= float(t_t[j]) * np.outer(v[:, j], v[:, j] @ q)
    assert np.abs(q.T @ q - np.eye(m)).max() <= 8 * b * EPS32
    rec = np.linalg.norm(q @ np.triu(k_t) - panel) / np.linalg.norm(panel)
    assert rec <= 8 * b * EPS32


def test_cpu_wrappers_take_the_plain_version_and_count_nothing():
    rng = np.random.default_rng(2)
    t = torch.from_numpy(_lower_block(64, False, rng))
    slab = torch.from_numpy(_spd_slab(128, 32, rng))
    panel = torch.from_numpy(rng.standard_normal((128, 32)).astype(np.float32))
    blk = torch.from_numpy(_spd_slab(44, 44, rng))
    reset_launch_counts()
    assert torch.equal(trtri(t), trtri_plain(t))
    for got, want in zip(llt_panel(slab), llt_panel_plain(slab)):
        assert torch.equal(got, want)
    for got, want in zip(lu_panel(panel), lu_panel_plain(panel)):
        assert torch.equal(got, want)
    for got, want in zip(qr_panel(panel), qr_panel_plain(panel)):
        assert torch.equal(got, want)
    for got, want in zip(llt_leaf(blk), llt_leaf_plain(blk)):
        assert torch.equal(got, want)
    for got, want in zip(lu_leaf(panel), lu_leaf_plain(panel)):
        assert torch.equal(got, want)
    assert launch_counts() == dict.fromkeys(KERNELS, 0)


@pytest.mark.parametrize("call", [
    lambda: trtri(torch.zeros(4, 4, dtype=torch.float64)),
    lambda: trtri(torch.zeros(129, 129)),
    lambda: trtri(torch.zeros(4, 5)),
    lambda: llt_panel(torch.zeros(16, 32)),
    lambda: lu_panel(torch.zeros(8)),
    lambda: qr_panel(torch.zeros(16, 0)),
    lambda: qr_panel(torch.zeros(32, 16, dtype=torch.float64)),
    lambda: llt_leaf(torch.zeros(4, 5)),
    lambda: lu_leaf(torch.zeros(0, 16)),
])
def test_wrappers_reject_bad_inputs(call):
    with pytest.raises((TypeError, ValueError)):
        call()
