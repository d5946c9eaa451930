"""The port's core and ops modules against ``faer_tpu``'s.

Inputs are made with numpy from a seed and fed to both packages (JAX on the
CPU, where it takes its plain recursive route). Tolerances follow faer's
rule ``8·n·eps_f32`` (``utils/approx.py``), against the JAX result and an
f64 numpy oracle.
"""
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import faer_tpu.ops.householder as jhh
import faer_tpu.ops.triangular as jtri
import faer_tpu.ops.triangular_solve as jts
from faer_tpu.core import flags as jflags
from faer_tpu.core import perm as jperm
from faer_tpu.utils import approx as japprox
from faer_tpu.utils import flops as jflops
from faer_tpu_torch.core import flags as tflags
from faer_tpu_torch.core import perm as tperm
from faer_tpu_torch.core.config import (
    KERNELS, check_f32_policy, launch_counts, reset_launch_counts)
from faer_tpu_torch.ops import householder as thh
from faer_tpu_torch.ops import triangular as ttri
from faer_tpu_torch.ops import triangular_solve as tts
from faer_tpu_torch.ops.matmul import matmul
from faer_tpu_torch.utils import approx as tapprox
from faer_tpu_torch.utils import flops as tflops
from faer_tpu_torch.utils.approx import assert_approx_eq, size_scale

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EPS32 = float(np.finfo(np.float32).eps)


def _lower(n, unit, rng):
    """Well-conditioned lower-triangular f32 (Cholesky factor of an SPD
    matrix, or a unit-lower factor with entries O(1/√n))."""
    if unit:
        return (np.tril(rng.standard_normal((n, n)) / np.sqrt(n), -1)
                + np.eye(n)).astype(np.float32)
    g = rng.standard_normal((n, n))
    return np.linalg.cholesky(g @ g.T / n + np.eye(n)).astype(np.float32)


@pytest.mark.parametrize("unit", [False, True])
@pytest.mark.parametrize("n", [64, 200, 512])
def test_invert_lower_triangular(n, unit):
    rng = np.random.default_rng(n + 3 * unit)
    t = _lower(n, unit, rng)
    got = ttri.invert_lower_triangular(torch.from_numpy(t), unit=unit).numpy()
    want = np.asarray(jtri.invert_lower_triangular(jnp.asarray(t), unit=unit))
    assert_approx_eq(got, want, scale=size_scale(n), tol_dtype=np.float32)
    assert_approx_eq(got, np.linalg.inv(t.astype(np.float64)),
                     scale=size_scale(n), tol_dtype=np.float32)


@pytest.mark.parametrize("n", [64, 200, 512])
def test_invert_upper_triangular(n):
    u = _lower(n, False, np.random.default_rng(n)).T.copy()
    got = ttri.invert_upper_triangular(torch.from_numpy(u)).numpy()
    want = np.asarray(jtri.invert_upper_triangular(jnp.asarray(u)))
    assert_approx_eq(got, want, scale=size_scale(n), tol_dtype=np.float32)


_SOLVES = [
    # (name, triangle of the operand, needs a unit diagonal)
    ("solve_lower_triangular", "lower", False),
    ("solve_upper_triangular", "upper", False),
    ("solve_unit_lower_triangular", "lower", True),
    ("solve_unit_upper_triangular", "upper", True),
    ("solve_lower_triangular_transpose", "lower", False),
    ("solve_upper_triangular_transpose", "upper", False),
    ("solve_lower_triangular_adjoint", "lower", False),
    ("solve_upper_triangular_adjoint", "upper", False),
]


@pytest.mark.parametrize("name,tri,unit", _SOLVES, ids=[s[0] for s in _SOLVES])
@pytest.mark.parametrize("n", [64, 200, 512])
def test_triangular_solves(n, name, tri, unit):
    rng = np.random.default_rng(n)
    t = _lower(n, unit, rng)
    if tri == "upper":
        t = t.T.copy()
    # garbage in the other triangle: never read
    other = np.triu if tri == "lower" else np.tril
    t = t + other(rng.standard_normal((n, n)), 1 if tri == "lower" else -1).astype(np.float32)
    b = rng.standard_normal((n, 8)).astype(np.float32)
    got = getattr(tts, name)(torch.from_numpy(t), torch.from_numpy(b)).numpy()
    want = np.asarray(getattr(jts, name)(jnp.asarray(t), jnp.asarray(b)))
    assert_approx_eq(got, want, scale=size_scale(n), tol_dtype=np.float32)
    # f64 oracle on the structured operand
    t64 = (np.tril(t, -1) if tri == "lower" else np.triu(t, 1)).astype(np.float64)
    t64 += np.eye(n) if unit else np.diag(np.diag(t)).astype(np.float64)
    if "transpose" in name or "adjoint" in name:
        t64 = t64.T
    assert_approx_eq(got, np.linalg.solve(t64, b.astype(np.float64)),
                     scale=size_scale(n), tol_dtype=np.float32)


def test_flags_match_jax():
    for name in ("Accum", "Conj", "Side", "Norm"):
        want = {m.name: m.value for m in getattr(jflags, name)}
        assert {m.name: m.value for m in getattr(tflags, name)} == want


@pytest.mark.parametrize("m,k,n", [(40, 30, 20), (1, 64, 8), (128, 128, 128)])
def test_matmul_front_door(m, k, n):
    rng = np.random.default_rng(m + k + n)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    got = matmul(None, torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.float32 and tuple(got.shape) == (m, n)
    assert_approx_eq(got.numpy(), a.astype(np.float64) @ b, scale=size_scale(k),
                     tol_dtype=np.float32)


@pytest.mark.parametrize("n", [1, 2, 17, 256])
def test_perm_transposition_count_matches_jax(n):
    rng = np.random.default_rng(n)
    for _ in range(5):
        p = rng.permutation(n)
        got = tperm.perm_transposition_count(torch.from_numpy(p))
        want = jperm.perm_transposition_count(jnp.asarray(p, jnp.int32))
        assert got.dtype == torch.int32 and int(got) == int(want)


def test_permute_rows_inverse_matches_jax():
    rng = np.random.default_rng(11)
    p = rng.permutation(30)
    a = rng.standard_normal((30, 4)).astype(np.float32)
    got = tperm.permute_rows_inverse(torch.from_numpy(a), torch.from_numpy(p))
    want = jperm.permute_rows_inverse(jnp.asarray(a), jnp.asarray(p, jnp.int32))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_approx_and_flops_match_jax():
    rng = np.random.default_rng(3)
    a = rng.standard_normal((20, 20)).astype(np.float32)
    for delta in (0.0, 1e-6, 1e-3):
        b = a + delta
        assert tapprox.approx_eq(a, b, scale=size_scale(20)) == \
            japprox.approx_eq(a, b, scale=size_scale(20))
        assert tapprox.approx_eq(torch.from_numpy(a), b, scale=8.0,
                                 tol_dtype=np.float32) == \
            japprox.approx_eq(a, b, scale=8.0, tol_dtype=jnp.float32)
    for n in (64, 4096):
        assert tflops.llt_flops(n) == jflops.llt_flops(n)
        assert tflops.lu_flops(n, n // 2) == jflops.lu_flops(n, n // 2)
        assert tflops.trsm_flops(n, 8) == jflops.trsm_flops(n, 8)
        assert tflops.matmul_flops(n, 3, 5) == jflops.matmul_flops(n, 3, 5)
        for m in (n // 2, n, 2 * n):
            assert tflops.qr_flops(m, n) == jflops.qr_flops(m, n)
            for vectors in (True, False):
                assert tflops.svd_flops(m, n, vectors) == jflops.svd_flops(m, n, vectors)
        for vectors in (True, False):
            assert tflops.evd_flops(n, vectors) == jflops.evd_flops(n, vectors)


def test_f32_policy_is_full_fp32(monkeypatch):
    check_f32_policy()
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    with pytest.raises(RuntimeError):
        check_f32_policy()


def test_cpu_path_launches_no_kernel():
    rng = np.random.default_rng(1)
    reset_launch_counts()
    ttri.invert_lower_triangular(torch.from_numpy(_lower(300, False, rng)))
    assert launch_counts() == dict.fromkeys(KERNELS, 0)


def test_import_leaves_jax_unloaded():
    code = ("import sys, faer_tpu_torch, faer_tpu_torch.entry, "
            "faer_tpu_torch.interop, faer_tpu_torch.linalg.qr, "
            "faer_tpu_torch.ops.kernels.leaf, faer_tpu_torch.ops.kernels.sweep, "
            "faer_tpu_torch.linalg.evd, faer_tpu_torch.linalg.svd, "
            "faer_tpu_torch.linalg.tridiag_dnc, faer_tpu_torch.linalg.bidiag_dnc, "
            "faer_tpu_torch.linalg.solvers, faer_tpu_torch.core.vec, "
            "faer_tpu_torch.ops.reductions, faer_tpu_torch.ops.kernels.syrk, "
            "faer_tpu_torch.ops.kernels.lu_panel_v2, faer_tpu_torch.ops.kernels.lu_panel_v3, "
            "faer_tpu_torch.ops.kernels.lu_panel_swap; "
            "bad = sorted(m for m in sys.modules if m in ('jax', 'faer_tpu') "
            "or m.startswith(('jax.', 'faer_tpu.'))); "
            "assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def _reflector_panel(m, b, rng):
    """V (unit lower trapezoidal) and τ of a QR of a Gaussian panel, from
    f64 LAPACK, rounded to f32."""
    import scipy.linalg

    packed, tau = scipy.linalg.qr(rng.standard_normal((m, b)), mode="raw")[0]
    v = np.tril(packed, -1) + np.eye(m, b)
    return v.astype(np.float32), tau.astype(np.float32)


@pytest.mark.parametrize("n", [1, 7, 64])
def test_make_householder_matches_jax(n):
    rng = np.random.default_rng(n)
    for x in (rng.standard_normal(n), np.r_[-2.0, np.zeros(n - 1)],
              np.r_[-0.0, rng.standard_normal(n - 1)]):
        x = x.astype(np.float32)
        got = thh.make_householder(torch.from_numpy(x))
        want = jhh.make_householder(jnp.asarray(x))
        for g, w in zip(got, want):
            assert_approx_eq(g.numpy(), np.asarray(w), scale=size_scale(n),
                             tol_dtype=np.float32)
        v, tau, beta = (t.numpy().astype(np.float64) for t in got)
        hx = x - tau * v * (v @ x)
        # H x = β e₁ to 8·n·eps relative to ‖x‖
        assert np.abs(hx - beta * np.eye(n)[0]).max() <= \
            8 * n * EPS32 * max(np.linalg.norm(x), 1e-30)


@pytest.mark.parametrize("m,b", [(96, 32), (200, 150)])
def test_form_block_t_and_block_applies_match_jax(m, b):
    """T over ≤ 128 and > 128 columns (one trtri leaf, or the recursive
    combine), with one identity reflector (τ = 0), and the four block applies
    against JAX and against the product of the b reflectors in f64."""
    rng = np.random.default_rng(m + b)
    v, tau = _reflector_panel(m, b, rng)
    v[:, 3] = np.eye(m, b)[:, 3]
    tau[3] = 0.0
    t_t = thh.form_block_t(torch.from_numpy(v), torch.from_numpy(tau))
    t_j = np.asarray(jhh.form_block_t(jnp.asarray(v), jnp.asarray(tau)))
    assert_approx_eq(t_t.numpy(), t_j, scale=size_scale(b), tol_dtype=np.float32)
    assert np.all(t_t.numpy()[3] == 0) and np.all(t_t.numpy()[:, 3] == 0)
    q64 = np.eye(m)
    for j in range(b):
        q64 = q64 @ (np.eye(m) - tau[j] * np.outer(v[:, j], v[:, j]))
    bm = rng.standard_normal((m, 5)).astype(np.float32)
    for adjoint in (False, True):
        q = q64.T if adjoint else q64
        got = thh.apply_block_on_left(torch.from_numpy(v), t_t,
                                      torch.from_numpy(bm), adjoint=adjoint)
        want = jhh.apply_block_on_left(jnp.asarray(v), jnp.asarray(t_j),
                                       jnp.asarray(bm), adjoint=adjoint)
        assert_approx_eq(got.numpy(), np.asarray(want), scale=size_scale(m),
                         tol_dtype=np.float32)
        assert_approx_eq(got.numpy(), q @ bm, scale=size_scale(m),
                         tol_dtype=np.float32)
        got = thh.apply_block_on_right(torch.from_numpy(v), t_t,
                                       torch.from_numpy(bm.T.copy()),
                                       adjoint=adjoint)
        assert_approx_eq(got.numpy(), bm.T @ q, scale=size_scale(m),
                         tol_dtype=np.float32)


@pytest.mark.parametrize("adjoint", [False, True])
def test_apply_sequences_match_jax(adjoint):
    """Q = Π_j (I − V_j T_j V_jᵀ) of a 100 × 70 factor in panels of 32
    (the last one ragged), applied on both sides."""
    import scipy.linalg

    m, n, block = 100, 70, 32
    rng = np.random.default_rng(9)
    packed, tau = scipy.linalg.qr(rng.standard_normal((m, n)), mode="raw")[0]
    packed = packed.astype(np.float32)
    tau = tau.astype(np.float32)
    ts = np.zeros((3, block, block), np.float32)
    for p, j0 in enumerate(range(0, n, block)):
        bw = min(block, n - j0)
        v = thh._extract_panel_v(torch.from_numpy(packed), j0, bw)
        ts[p, :bw, :bw] = thh.form_block_t(
            v, torch.from_numpy(tau[j0:j0 + bw])).numpy()
    bl = rng.standard_normal((m, 4)).astype(np.float32)
    br = rng.standard_normal((4, m)).astype(np.float32)
    got_l = thh.apply_sequence_on_left(torch.from_numpy(packed), torch.from_numpy(ts),
                                       torch.from_numpy(bl), adjoint=adjoint,
                                       block=block)
    got_r = thh.apply_sequence_on_right(torch.from_numpy(packed), torch.from_numpy(ts),
                                        torch.from_numpy(br), adjoint=adjoint,
                                        block=block)
    want_l = jhh.apply_sequence_on_left(jnp.asarray(packed), jnp.asarray(ts),
                                        jnp.asarray(bl), adjoint=adjoint, block=block)
    want_r = jhh.apply_sequence_on_right(jnp.asarray(packed), jnp.asarray(ts),
                                         jnp.asarray(br), adjoint=adjoint, block=block)
    assert_approx_eq(got_l.numpy(), np.asarray(want_l), scale=size_scale(m),
                     tol_dtype=np.float32)
    assert_approx_eq(got_r.numpy(), np.asarray(want_r), scale=size_scale(m),
                     tol_dtype=np.float32)
    v64 = np.tril(packed.astype(np.float64), -1) + np.eye(m, n)
    q64 = np.eye(m)
    for j in range(n):
        q64 = q64 @ (np.eye(m) - float(tau[j]) * np.outer(v64[:, j], v64[:, j]))
    q = q64.T if adjoint else q64
    assert_approx_eq(got_l.numpy(), q @ bl, scale=size_scale(m), tol_dtype=np.float32)
    assert_approx_eq(got_r.numpy(), br @ q, scale=size_scale(m), tol_dtype=np.float32)
