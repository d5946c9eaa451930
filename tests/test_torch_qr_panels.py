"""The port's QR panel family (v1, v2, v3 and the v4 leaf), and the one-pass
order of the CUDA kernel (``qr_panel_onepass_plain``), against the JAX
package's Pallas kernels.

Each plain PyTorch version (what the wrapper runs for a CPU tensor) is
compared with its Pallas kernel run in interpret mode on the CPU, on the same
numpy inputs from a seed, and with an f64 numpy check of the factor:
Q = H_0 ⋯ H_{k−1} orthogonal and Q·R = A. The Pallas dots of these four
kernels are HIGHEST and the port's are FP32, so every comparison is faer's
8·n·eps_f32 (``utils/approx.py``), n the panel's row count (its larger side
for the f64 checks of wide panels). R and the reflector tails V are each
held relative to their own largest entry: the tails are much smaller than R.
"""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faer_tpu_torch.core.config import KERNELS, launch_counts, reset_launch_counts
from faer_tpu_torch.core.errors import ShapeError
from faer_tpu_torch.ops.kernels.leaf import qr_leaf, qr_leaf_plain
from faer_tpu_torch.ops.kernels.qr_panel import qr_panel_onepass_plain
from faer_tpu_torch.ops.kernels.qr_panel_v1 import qr_panel_v1, qr_panel_v1_plain
from faer_tpu_torch.ops.kernels.qr_panel_v2 import qr_panel_v2, qr_panel_v2_plain
from faer_tpu_torch.ops.kernels.qr_panel_v3 import qr_panel_v3, qr_panel_v3_plain
from faer_tpu_torch.utils.approx import assert_approx_eq

torch.set_num_threads(1)

EPS32 = float(np.finfo(np.float32).eps)


@pytest.fixture
def interp(monkeypatch):
    """Route every pallas_call through the interpreter (as in
    tests/test_pallas_kernels.py) and drop cached traces of the kernels."""
    from jax.experimental import pallas as pl

    import faer_tpu.ops.pallas.leaf_v4 as leaf4
    import faer_tpu.ops.pallas.panel_kernels as pk
    import faer_tpu.ops.pallas.qr_panel_v2 as v2
    import faer_tpu.ops.pallas.qr_panel_v3 as v3

    orig = pl.pallas_call

    def interp_call(*args, **kwargs):
        kwargs["interpret"] = True
        kwargs.pop("compiler_params", None)
        return orig(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", interp_call)
    fns = (pk.qr_panel_pallas, v2.qr_panel_v2_pallas, v3.qr_panel_v3_pallas,
           leaf4.qr_panel_v4_pallas)
    for fn in fns:
        fn.clear_cache()
    yield types.SimpleNamespace(v1=pk.qr_panel_pallas, v2=v2.qr_panel_v2_pallas,
                                v3=v3.qr_panel_v3_pallas, v4=leaf4.qr_panel_v4_pallas)
    for fn in fns:
        fn.clear_cache()


PLAIN = {"v1": qr_panel_v1_plain, "v2": qr_panel_v2_plain, "v3": qr_panel_v3_plain,
         "v4": qr_leaf_plain}
WRAPPER = {"v1": qr_panel_v1, "v2": qr_panel_v2, "v3": qr_panel_v3, "v4": qr_leaf}


def _panel(m, b, zero_col, seed, neg_zero=False):
    panel = np.random.default_rng(seed).standard_normal((m, b)).astype(np.float32)
    if zero_col is not None:
        panel[:, zero_col] = 0.0
    if neg_zero:  # α = −0.0 at step 0, with a nonzero tail
        panel[0, 0] = -0.0
    return panel


_PALLAS = {}


def _pallas(interp, kernel, panel, key):
    """The Pallas kernel's ``(packed, taus)`` on a case's panel, computed
    once per process: the one-pass test reads what the plain test made."""
    if (kernel, key) not in _PALLAS:
        _PALLAS[kernel, key] = tuple(
            np.asarray(x) for x in getattr(interp, kernel)(jnp.asarray(panel)))
    return _PALLAS[kernel, key]


def _q_of(packed, taus):
    """Q = H_0 ⋯ H_{k−1} in f64 from the packed reflectors, (m, m)."""
    m = packed.shape[0]
    k = taus.shape[0]
    v = np.tril(packed[:, :k].astype(np.float64), -1) + np.eye(m, k)
    q = np.eye(m)
    for j in range(k - 1, -1, -1):
        q -= float(taus[j]) * np.outer(v[:, j], v[:, j] @ q)
    return q


def _assert_factor_close(k_t, t_t, k_j, t_j, tol):
    for part in (np.triu, lambda k: np.tril(k, -1)):
        want = part(k_j)
        assert_approx_eq(part(k_t), want, abs_tol=tol * np.abs(want).max(),
                         rel_tol=tol)
    assert_approx_eq(t_t, t_j, abs_tol=tol, rel_tol=tol)


# (m, b, zero column): b a multiple of 8 and not, a wide panel (the probe of
# ROADMAP §3), and an exact zero column, whose tail stays zero under every
# reflector, so τ = 0 and β = α = 0 there
CASES = [(96, 40, None), (50, 13, None), (16, 40, None), (40, 16, 5)]


@pytest.mark.parametrize("kernel", ["v1", "v2", "v3", "v4"])
@pytest.mark.parametrize("m,b,zero_col", CASES)
def test_plain_matches_pallas(kernel, m, b, zero_col, interp):
    panel = _panel(m, b, zero_col, m * b)
    k_j, t_j = _pallas(interp, kernel, panel, (m, b, zero_col, False))
    k_t, t_t = (x.numpy() for x in PLAIN[kernel](torch.from_numpy(panel)))
    kmax = min(m, b)
    assert k_t.shape == (m, b) and t_t.shape == t_j.shape == (kmax,)
    _assert_factor_close(k_t, t_t, k_j, t_j, 8 * m * EPS32)
    # f64: Q orthogonal and Q·R = A, R the whole (m, b) upper part
    tol = 8 * max(m, b) * EPS32
    q = _q_of(k_t, t_t)
    assert np.abs(q.T @ q - np.eye(m)).max() <= tol
    rec = np.linalg.norm(q @ np.triu(k_t) - panel) / np.linalg.norm(panel)
    assert rec <= tol
    if zero_col is not None:
        assert float(t_t[zero_col]) == float(t_j[zero_col]) == 0.0
        assert np.all(k_t[zero_col:, zero_col] == 0.0)


# the one-pass twin's cases: CASES, and α = −0.0 at step 0 (β = −‖x‖, τ = 1)
ONEPASS_CASES = [(*case, False) for case in CASES] + [(40, 24, None, True)]


@pytest.mark.parametrize("kernel", ["v1", "v2", "v3", "v4"])
@pytest.mark.parametrize("m,b,zero_col,neg_zero", ONEPASS_CASES)
def test_onepass_plain_matches_pallas(kernel, m, b, zero_col, neg_zero, interp):
    """The CUDA kernel's order (‖tail‖² and tailᵀ·A_tail in one pass, the
    fused w = A[j, j+1:] + s·(tailᵀ·A_tail)) computes the Pallas kernels'
    function: R, V and τ within 8·m·eps, Q orthogonal and Q·R = A in f64."""
    panel = _panel(m, b, zero_col, m * b, neg_zero)
    k_j, t_j = _pallas(interp, kernel, panel, (m, b, zero_col, neg_zero))
    k_t, t_t = (x.numpy() for x in qr_panel_onepass_plain(torch.from_numpy(panel)))
    assert k_t.shape == (m, b) and t_t.shape == t_j.shape == (min(m, b),)
    _assert_factor_close(k_t, t_t, k_j, t_j, 8 * m * EPS32)
    tol = 8 * max(m, b) * EPS32
    q = _q_of(k_t, t_t)
    assert np.abs(q.T @ q - np.eye(m)).max() <= tol
    assert np.linalg.norm(q @ np.triu(k_t) - panel) / np.linalg.norm(panel) <= tol
    if zero_col is not None:
        assert float(t_t[zero_col]) == float(t_j[zero_col]) == 0.0
        assert np.all(k_t[zero_col:, zero_col] == 0.0)
    if neg_zero:  # −0.0 counts as ≥ 0: β = −‖x‖ and τ = (β − α)/β = 1
        assert k_t[0, 0] < 0 and k_j[0, 0] < 0 and float(t_t[0]) == 1.0


@pytest.mark.parametrize("m,b,zero_col,neg_zero", [(200, 44, None, False), (200, 44, 7, False),
                                                   (200, 44, None, True), (30, 50, None, False)])
def test_onepass_plain_matches_the_f64_householder_qr(m, b, zero_col, neg_zero):
    """Against LAPACK's f64 ``geqrf`` through scipy (the same ``larfg``
    signs): R, V and τ within 8·m·eps (8·b·eps for the wide panel, whose
    columns right of m are Qᵀ·A), and equal to ``qr_panel_v1_plain`` (the
    two-pass column loop) within the same limit. LAPACK's ``dlarfg`` takes
    the sign of −0.0 as negative, the contract as ≥ 0, so the f64 oracle
    gets +0.0 there: the same value, the contract's signs."""
    import scipy.linalg

    panel = _panel(m, b, zero_col, 5 * m + b, neg_zero)
    if m < b:  # κ ≤ 3, as the wide card cases make them
        panel = (panel / (4 * np.sqrt(m)) + np.eye(m, b)).astype(np.float32)
    k64, t64 = scipy.linalg.qr(panel.astype(np.float64) + 0.0, mode="raw")[0]
    k_t, t_t = (x.numpy() for x in qr_panel_onepass_plain(torch.from_numpy(panel)))
    k_1, t_1 = (x.numpy() for x in qr_panel_v1_plain(torch.from_numpy(panel)))
    tol = 8 * max(m, b) * EPS32
    _assert_factor_close(k_t, t_t, k64, t64[:min(m, b)], tol)
    _assert_factor_close(k_t, t_t, k_1, t_1, tol)
    if zero_col is not None:
        assert float(t_t[zero_col]) == 0.0 and np.all(k_t[zero_col + 1:, zero_col] == 0.0)


@pytest.mark.parametrize("m,b", [(30, 20), (16, 40)])
def test_qr_leaf_sb16_matches_pallas(m, b, interp):
    """``sb`` = 16, as ``tools/r4lab.py`` also runs the v4 leaf."""
    panel = _panel(m, b, None, 3 * m + b)
    k_j, t_j = (np.asarray(x) for x in interp.v4(jnp.asarray(panel), sb=16))
    k_t, t_t = (x.numpy() for x in qr_leaf(torch.from_numpy(panel), sb=16, rch=64))
    _assert_factor_close(k_t, t_t, k_j, t_j, 8 * m * EPS32)


def test_plain_versions_match_the_f64_householder_qr():
    """A tall Gaussian panel (κ ≤ 3) against LAPACK's f64 ``geqrf`` (the same
    ``larfg`` signs) through scipy: R, V and τ within 8·m·eps."""
    import scipy.linalg

    m, b = 200, 44
    panel = _panel(m, b, None, 11)
    k64, t64 = scipy.linalg.qr(panel.astype(np.float64), mode="raw")[0]
    for plain in PLAIN.values():
        k_t, t_t = (x.numpy() for x in plain(torch.from_numpy(panel)))
        _assert_factor_close(k_t, t_t, k64, t64, 8 * m * EPS32)


def test_cpu_wrappers_take_the_plain_version_and_count_nothing():
    tall = torch.from_numpy(_panel(64, 24, None, 4))
    wide = torch.from_numpy(_panel(12, 30, None, 5))
    reset_launch_counts()
    for kernel, wrapper in WRAPPER.items():
        for panel in (tall, wide):
            for got, want in zip(wrapper(panel), PLAIN[kernel](panel)):
                assert torch.equal(got, want)
    assert launch_counts() == dict.fromkeys(KERNELS, 0)


@pytest.mark.parametrize("call", [
    lambda: qr_panel_v1(torch.zeros(16, 8, dtype=torch.float64)),
    lambda: qr_panel_v1(torch.zeros(8)),
    lambda: qr_panel_v2(torch.zeros(16, 8, dtype=torch.float64)),
    lambda: qr_panel_v2(torch.zeros(0, 8)),
    lambda: qr_panel_v3(torch.zeros(16, 8, dtype=torch.float64)),
    lambda: qr_panel_v3(torch.zeros(16, 0)),
    lambda: qr_leaf(torch.zeros(16, 8, dtype=torch.float64)),
    lambda: qr_leaf(torch.zeros(2, 16, 8)),
    lambda: qr_leaf(torch.zeros(16, 8), sb=0),
])
def test_wrappers_reject_bad_inputs(call):
    with pytest.raises((TypeError, ShapeError, ValueError)):
        call()
