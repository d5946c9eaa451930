"""The port's LLT and LU factor-and-solve path against ``faer_tpu.linalg``.

Inputs are made with numpy from a seed and fed to both packages (JAX on the
CPU) and to an f64 numpy oracle. Tolerances follow faer's rule
``8·n·eps_f32`` (``utils/approx.py``): elementwise for the factors of
well-conditioned inputs, normwise (scaled by the condition number where a
forward error is compared) for solves.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import faer_tpu.linalg.cholesky as jchol
import faer_tpu.linalg.lu as jlu
from faer_tpu.core.params import LltParams as JLltParams
from faer_tpu.core.params import LltRegularization as JLltRegularization
from faer_tpu_torch import interop
from faer_tpu_torch.core.errors import ShapeError
from faer_tpu_torch.core.params import LltParams, LltRegularization
from faer_tpu_torch.entry import flagship_step
from faer_tpu_torch.linalg import cholesky as tchol
from faer_tpu_torch.linalg import lu as tlu
from faer_tpu_torch.utils.approx import assert_approx_eq, size_scale

torch.set_num_threads(1)

EPS32 = float(np.finfo(np.float32).eps)


def _spd(n, rng):
    g = rng.standard_normal((n, n))
    return (g @ g.T / n + np.eye(n)).astype(np.float32)


def _separated(n, rng):
    """P·L·U with |L| ≤ 1/(2√n) and O(1/√n) off-diagonal U: partial pivoting
    must recover P, under any rounding."""
    lo = np.tril(rng.uniform(-0.5, 0.5, (n, n)) / np.sqrt(n), -1) + np.eye(n)
    up = (np.triu(rng.standard_normal((n, n)), 1) / np.sqrt(n)
          + np.diag(1 + rng.uniform(size=n)))
    p = rng.permutation(n)
    a = np.empty((n, n))
    a[p] = lo @ up
    return a.astype(np.float32), p


def _rel(x, y):
    return np.linalg.norm(np.asarray(x, np.float64) - y) / np.linalg.norm(y)


def _perm_parity(perm):
    return (len(perm) - len(_cycles(perm))) % 2


def _cycles(perm):
    seen, out = set(), []
    for i in range(len(perm)):
        if i not in seen:
            c, j = [], i
            while j not in seen:
                seen.add(j)
                c.append(j)
                j = perm[j]
            out.append(c)
    return out


def test_llt_factor_and_solve_match_jax():
    n = 512
    rng = np.random.default_rng(0)
    a = _spd(n, rng)
    b = rng.standard_normal((n, 8)).astype(np.float32)
    l_t, info_t = tchol.llt_factor(torch.from_numpy(a),
                                   params=LltParams(block_size=128))
    l_j, info_j = jchol.llt_factor(jnp.asarray(a),
                                   params=JLltParams(block_size=128))
    assert bool(info_t.success) and bool(info_j.success)
    assert int(info_t.dynamic_regularization_count) == 0
    l64 = np.linalg.cholesky(a.astype(np.float64))
    assert_approx_eq(l_t.numpy(), np.asarray(l_j), scale=size_scale(n),
                     tol_dtype=np.float32)
    assert_approx_eq(l_t.numpy(), l64, scale=size_scale(n), tol_dtype=np.float32)
    assert np.all(np.triu(l_t.numpy(), 1) == 0)
    x_t = tchol.llt_solve(l_t, torch.from_numpy(b)).numpy()
    x_j = np.asarray(jchol.llt_solve(l_j, jnp.asarray(b)))
    x64 = np.linalg.solve(a.astype(np.float64), b)
    # cond(A) ≤ 5 here, so the 8·n·eps rule holds for the solution itself
    assert_approx_eq(x_t, x_j, scale=size_scale(n), tol_dtype=np.float32)
    assert_approx_eq(x_t, x64, scale=size_scale(n), tol_dtype=np.float32)
    rec = tchol.llt_reconstruct(l_t).numpy()
    assert_approx_eq(rec, a, scale=size_scale(n), tol_dtype=np.float32)


def test_llt_regularization_matches_jax():
    n = 256
    a = np.eye(n, dtype=np.float32)
    a[100, 100] = -1.0  # one non-positive pivot
    reg = (1e-3, 1e-3)
    l_t, info_t = tchol.llt_factor(torch.from_numpy(a),
                                   reg=LltRegularization(*reg),
                                   params=LltParams(block_size=128))
    l_j, info_j = jchol.llt_factor(jnp.asarray(a),
                                   reg=JLltRegularization(*reg),
                                   params=JLltParams(block_size=128))
    assert int(info_t.dynamic_regularization_count) == \
        int(info_j.dynamic_regularization_count) == 1
    assert not bool(info_t.success) and not bool(info_j.success)
    assert_approx_eq(l_t.numpy(), np.asarray(l_j), scale=size_scale(n),
                     tol_dtype=np.float32)


def test_llt_non_spd_reports_failure():
    rng = np.random.default_rng(1)
    a = _spd(256, rng)
    a[200, 200] = -50.0
    _, info = tchol.llt_factor(torch.from_numpy(a),
                               params=LltParams(block_size=128))
    assert not bool(info.success)


@pytest.mark.parametrize("shape,params", [
    ((512, 512), None),                       # default block 64: off route
    ((300, 300), LltParams(block_size=128)),  # n % 128 != 0
    ((128, 128), LltParams(block_size=128)),  # n == block
    ((300, 300), LltParams(block_size=64)),   # ragged: the last leaf is 44
])
def test_llt_off_route_matches_jax(shape, params):
    """The recursive driver (``llt_leaf`` leaves) against the JAX package's
    recursive driver and the f64 factor; cond(A) ≤ 5, so 8·n·eps holds
    elementwise."""
    n = shape[0]
    rng = np.random.default_rng(n + (params.block_size if params else 0))
    a = _spd(n, rng)
    jparams = JLltParams(block_size=params.block_size) if params else None
    l_t, info_t = tchol.llt_factor(torch.from_numpy(a), params=params)
    l_j, info_j = jchol.llt_factor(jnp.asarray(a), params=jparams)
    assert bool(info_t.success) and bool(info_j.success)
    assert int(info_t.dynamic_regularization_count) == 0
    assert np.all(np.triu(l_t.numpy(), 1) == 0)
    assert_approx_eq(l_t.numpy(), np.asarray(l_j), scale=size_scale(n),
                     tol_dtype=np.float32)
    assert_approx_eq(l_t.numpy(), np.linalg.cholesky(a.astype(np.float64)),
                     scale=size_scale(n), tol_dtype=np.float32)


def test_llt_off_route_regularization_matches_jax():
    n = 300
    a = np.eye(n, dtype=np.float32)
    a[290, 290] = -1.0  # one non-positive pivot, in the ragged last leaf
    reg = (1e-3, 1e-3)
    l_t, info_t = tchol.llt_factor(torch.from_numpy(a),
                                   reg=LltRegularization(*reg),
                                   params=LltParams(block_size=64))
    l_j, info_j = jchol.llt_factor(jnp.asarray(a), reg=JLltRegularization(*reg),
                                   params=JLltParams(block_size=64))
    assert int(info_t.dynamic_regularization_count) == \
        int(info_j.dynamic_regularization_count) == 1
    assert not bool(info_t.success) and not bool(info_j.success)
    assert_approx_eq(l_t.numpy(), np.asarray(l_j), scale=size_scale(n),
                     tol_dtype=np.float32)


def test_llt_rejects_bad_shapes_and_dtypes():
    with pytest.raises(ShapeError):
        tchol.llt_factor(torch.zeros(256, 128))
    # complex input factors its real embedding (item 10a); bf16 has no route
    for dt, params in ((torch.complex64, LltParams(block_size=128)), (torch.complex128, None)):
        l, info = tchol.llt_factor(torch.eye(300, dtype=dt), params=params)
        assert bool(info.success) and torch.equal(l, torch.eye(300, dtype=dt))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tchol.llt_factor(torch.eye(300, dtype=torch.bfloat16))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tlu.lu_in_place(torch.eye(300, dtype=torch.bfloat16))


def test_lu_generic_matches_jax():
    n = 1024
    rng = np.random.default_rng(2)
    a = rng.standard_normal((n, n)).astype(np.float32)
    b = rng.standard_normal((n, 8)).astype(np.float32)
    lu_t, perm_t, info_t = tlu.lu_in_place(torch.from_numpy(a))
    lu_j, perm_j, info_j = jlu.lu_in_place(jnp.asarray(a))
    assert bool(info_t.success) and bool(info_j.success)
    a64 = a.astype(np.float64)
    for lu, perm in ((lu_t.numpy(), perm_t.numpy()), (np.asarray(lu_j),
                                                      np.asarray(perm_j))):
        lo = np.tril(lu, -1) + np.eye(n)
        assert _rel(lo @ np.triu(lu), a64[perm]) <= 8 * n * EPS32
        assert np.abs(np.tril(lu, -1)).max() <= 1 + 1e-6
    assert int(info_t.transposition_count) % 2 == _perm_parity(perm_t.numpy())
    assert int(info_t.transposition_count) % 2 == \
        int(info_j.transposition_count) % 2
    rec = tlu.lu_reconstruct(lu_t, perm_t).numpy()
    assert _rel(rec, a64) <= 8 * n * EPS32
    # det: same sign as the oracle's, log-magnitude to 8·n·eps
    det = tlu.lu_determinant(lu_t.double(), perm_t, info_t.transposition_count)
    sign, logdet = np.linalg.slogdet(a64)
    assert np.sign(float(det)) == sign
    logdet_t = np.sum(np.log(np.abs(np.diag(lu_t.numpy().astype(np.float64)))))
    assert abs(logdet_t - logdet) <= 8 * n * EPS32 * abs(logdet)
    x_t = tlu.lu_solve(lu_t, perm_t, torch.from_numpy(b)).numpy()
    x_j = np.asarray(jlu.lu_solve(lu_j, perm_j, jnp.asarray(b)))
    x64 = np.linalg.solve(a64, b)
    kappa = np.linalg.cond(a64)
    assert _rel(x_t, x64) <= 8 * n * EPS32 * kappa
    assert _rel(x_t, x_j) <= 8 * n * EPS32 * kappa
    resid = np.linalg.norm(a64 @ x_t - b) / (np.linalg.norm(a64) * np.linalg.norm(x_t))
    assert resid <= 8 * n * EPS32


def test_lu_separated_pivots_match_jax_exactly():
    n = 1024
    rng = np.random.default_rng(3)
    a, p = _separated(n, rng)
    lu_t, perm_t, info_t = tlu.lu_in_place(torch.from_numpy(a))
    lu_j, perm_j, info_j = jlu.lu_in_place(jnp.asarray(a))
    np.testing.assert_array_equal(perm_t.numpy(), p)
    np.testing.assert_array_equal(perm_t.numpy(), np.asarray(perm_j))
    assert int(info_t.transposition_count) % 2 == \
        int(info_j.transposition_count) % 2
    assert_approx_eq(lu_t.numpy(), np.asarray(lu_j), scale=size_scale(n),
                     tol_dtype=np.float32)


def test_lu_singular_reports_failure():
    rng = np.random.default_rng(4)
    a = rng.standard_normal((1024, 1024)).astype(np.float32)
    a[:, 300] = 0.0
    _, _, info = tlu.lu_in_place(torch.from_numpy(a))
    assert not bool(info.success)


@pytest.mark.parametrize("shape", [(512, 512), (1000, 1000), (1024, 2048),
                                   (200, 300), (300, 200)])
def test_lu_off_route_matches_jax(shape):
    """The recursive driver (``lu_leaf`` leaves) on squares off the fused
    route, a wide and a tall matrix, against the JAX package's recursive
    driver: both factors reconstruct A[perm] within 8·max(m, n)·eps, |L| ≤ 1,
    and the parities of nt agree with each other and with perm."""
    m, n = shape
    rng = np.random.default_rng(m + 3 * n)
    a = rng.standard_normal((m, n)).astype(np.float32)
    lu_t, perm_t, info_t = tlu.lu_in_place(torch.from_numpy(a))
    lu_j, perm_j, info_j = jlu.lu_in_place(jnp.asarray(a))
    assert bool(info_t.success) and bool(info_j.success)
    assert lu_t.shape == (m, n)
    k = min(m, n)
    a64 = a.astype(np.float64)
    for lu, perm in ((lu_t.numpy(), perm_t.numpy()),
                     (np.asarray(lu_j), np.asarray(perm_j))):
        lo = np.tril(lu[:, :k], -1) + np.eye(m, k)
        assert _rel(lo @ np.triu(lu[:k]), a64[perm]) <= 8 * max(m, n) * EPS32
        assert np.abs(np.tril(lu, -1)).max() <= 1 + 1e-6
    assert int(info_t.transposition_count) % 2 == _perm_parity(perm_t.numpy())
    assert int(info_t.transposition_count) % 2 == \
        int(info_j.transposition_count) % 2
    rec = tlu.lu_reconstruct(lu_t, perm_t).numpy()
    assert _rel(rec, a64) <= 8 * max(m, n) * EPS32


def test_lu_off_route_separated_pivots_match_jax_exactly():
    n = 300
    rng = np.random.default_rng(8)
    a, p = _separated(n, rng)
    lu_t, perm_t, info_t = tlu.lu_in_place(torch.from_numpy(a))
    lu_j, perm_j, info_j = jlu.lu_in_place(jnp.asarray(a))
    np.testing.assert_array_equal(perm_t.numpy(), p)
    np.testing.assert_array_equal(perm_t.numpy(), np.asarray(perm_j))
    # nt sums per-leaf counts, which the two packages take differently (the
    # JAX CPU panel counts row swaps); the parity is the contract
    assert int(info_t.transposition_count) % 2 == \
        int(info_j.transposition_count) % 2 == _perm_parity(p)
    assert_approx_eq(lu_t.numpy(), np.asarray(lu_j), scale=size_scale(n),
                     tol_dtype=np.float32)


def test_lu_factor_v5_small_blocks_direct():
    # the v5 driver with several outer blocks at a small size, through the
    # private entry the default route never reaches below n = 2048
    n = 512
    rng = np.random.default_rng(5)
    a = rng.standard_normal((n, n)).astype(np.float32)
    lu, perm, info = tlu._lu_factor_v5(torch.from_numpy(a), block=64, ob=128)
    assert bool(info.success)
    lu = lu.numpy()
    lo = np.tril(lu, -1) + np.eye(n)
    assert _rel(lo @ np.triu(lu), a.astype(np.float64)[perm.numpy()]) <= 8 * n * EPS32
    assert int(info.transposition_count) % 2 == _perm_parity(perm.numpy())


def test_flagship_step_matches_jax_entry():
    from __graft_entry__ import entry

    n = 1024
    rng = np.random.default_rng(6)
    a_spd = _spd(n, rng)
    g = rng.standard_normal((n, n)).astype(np.float32)
    b = rng.standard_normal((n, 8)).astype(np.float32)
    fn, _ = entry()
    x_j, ok_j = fn(jnp.asarray(a_spd), jnp.asarray(g), jnp.asarray(b))
    x_t, ok_t = flagship_step(torch.from_numpy(a_spd), torch.from_numpy(g),
                              torch.from_numpy(b))
    assert bool(ok_t) and bool(ok_j)
    assert x_t.shape == (n, 8) and bool(torch.isfinite(x_t).all())
    g64 = g.astype(np.float64)
    x64 = np.linalg.solve(a_spd.astype(np.float64), b) + np.linalg.solve(g64, b)
    kappa = np.linalg.cond(g64)
    assert _rel(x_t.numpy(), x64) <= 8 * n * EPS32 * kappa
    assert _rel(x_t.numpy(), np.asarray(x_j, np.float64)) <= 8 * n * EPS32 * kappa


def test_interop_round_trip():
    n = 512
    rng = np.random.default_rng(7)
    a = _spd(n, rng)
    g = rng.standard_normal((1024, 1024)).astype(np.float32)
    b = rng.standard_normal((n, 4)).astype(np.float32)
    bg = rng.standard_normal((1024, 4)).astype(np.float32)
    x64 = np.linalg.solve(a.astype(np.float64), b)
    # JAX factor -> port solve
    l_j, info_j = jchol.llt_factor(jnp.asarray(a), params=JLltParams(block_size=128))
    l_t, info_t = interop.llt_from_numpy(np.asarray(l_j),
                                         np.asarray(info_j.dynamic_regularization_count),
                                         np.asarray(info_j.success), device="cpu")
    assert bool(info_t.success) and info_t.success.dtype == torch.bool
    x = tchol.llt_solve(l_t, torch.from_numpy(b)).numpy()
    assert_approx_eq(x, x64, scale=size_scale(n), tol_dtype=np.float32)
    # port factor -> JAX solve
    lu_t, perm_t, linfo = tlu.lu_in_place(torch.from_numpy(g))
    lu_n, perm_n, nt_n, ok_n = interop.lu_to_numpy(lu_t, perm_t, linfo)
    assert perm_n.dtype == np.int32 and bool(ok_n)
    xg = np.asarray(jlu.lu_solve(jnp.asarray(lu_n), jnp.asarray(perm_n),
                                 jnp.asarray(bg)))
    g64 = g.astype(np.float64)
    assert _rel(xg, np.linalg.solve(g64, bg)) <= 8 * 1024 * EPS32 * np.linalg.cond(g64)
    # and back: numpy -> port tensors unchanged
    lu2, perm2, info2 = interop.lu_from_numpy(lu_n, perm_n, nt_n, ok_n, device="cpu")
    assert torch.equal(lu2, lu_t) and torch.equal(perm2, perm_t)
    assert int(info2.transposition_count) == int(linfo.transposition_count)
    l_back, cnt, ok = interop.llt_to_numpy(l_t, info_t)
    np.testing.assert_array_equal(l_back, np.asarray(l_j))
    assert int(cnt) == 0 and bool(ok)
