"""The port's QR panel family (v1, v2, v3 and the v4 leaf) against the JAX
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


def _panel(m, b, zero_col, seed):
    panel = np.random.default_rng(seed).standard_normal((m, b)).astype(np.float32)
    if zero_col is not None:
        panel[:, zero_col] = 0.0
    return panel


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
    k_j, t_j = (np.asarray(x) for x in getattr(interp, kernel)(jnp.asarray(panel)))
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
