"""The port's Householder QR path against ``faer_tpu.linalg.qr``.

Inputs are made with numpy from a seed, as U·diag(s)·Vᵀ with orthogonal U,
V and singular values s in [1, 10] (κ = 10), and fed to both packages (JAX
on the CPU, where it takes its non-kernel ``fori`` panels of 32 columns;
the port runs ``qr_panel``'s plain version on leaves of up to 128) and to
f64 numpy and LAPACK. The two packages block the same way (same ``block``,
so the ``t_stack`` shapes match) and differ in the order of rounding
inside a panel, so factors are compared under faer's rule 8·n·eps_f32
scaled by κ; least-squares solutions by 8·m·eps·κ², the sensitivity of a
least-squares problem with a residual.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch

import faer_tpu.linalg.qr as jqr
from faer_tpu.core.params import QrParams as JQrParams
from faer_tpu_torch import interop
from faer_tpu_torch.core.errors import ShapeError
from faer_tpu_torch.core.params import QrParams
from faer_tpu_torch.linalg import qr as tqr
from faer_tpu_torch.utils.approx import assert_approx_eq, size_scale

torch.set_num_threads(1)

EPS32 = float(np.finfo(np.float32).eps)
KAPPA = 10.0


def _conditioned(m, n, rng):
    """An (m, n) f32 matrix with singular values spread over [1, κ]."""
    k = min(m, n)
    u = np.linalg.qr(rng.standard_normal((m, k)))[0]
    v = np.linalg.qr(rng.standard_normal((n, k)))[0]
    s = np.linspace(1.0, KAPPA, k)
    return ((u * s) @ v.T).astype(np.float32)


def _rel(x, y):
    x = np.asarray(x, np.float64)
    return np.linalg.norm(x - y) / np.linalg.norm(y)


@pytest.fixture(scope="module")
def factor():
    """``factor(m, n)``: (a, port factor, JAX factor) of the seeded (m, n)
    input, computed once per module."""
    done = {}

    def get(m, n):
        if (m, n) not in done:
            a = _conditioned(m, n, np.random.default_rng(m * 7 + n))
            done[m, n] = (a, tqr.qr_in_place(torch.from_numpy(a)),
                          jqr.qr_in_place(jnp.asarray(a)))
        return done[m, n]

    return get


@pytest.mark.parametrize("m,n,block", [(512, 512, 128), (300, 200, 32),
                                       (200, 300, 32)])
def test_qr_in_place_matches_jax(m, n, block, factor):
    a, (pk_t, ts_t, blk_t), (pk_j, ts_j, blk_j) = factor(m, n)
    k = min(m, n)
    assert blk_t == blk_j == block
    assert tuple(ts_t.shape) == tuple(ts_j.shape) == (-(-k // block), block, block)
    scale = size_scale(max(m, n)) * KAPPA
    assert_approx_eq(pk_t.numpy(), np.asarray(pk_j), scale=scale,
                     tol_dtype=np.float32)
    assert_approx_eq(ts_t.numpy(), np.asarray(ts_j), scale=scale,
                     tol_dtype=np.float32)
    # the taus sit on the T diagonals; f64 LAPACK geqrf has the same signs
    taus_t = np.concatenate([np.diag(t) for t in ts_t.numpy()])[:k]
    pk64, tau64 = scipy.linalg.qr(a.astype(np.float64), mode="raw")[0]
    assert_approx_eq(taus_t, tau64, scale=scale, tol_dtype=np.float32)
    assert_approx_eq(np.triu(pk_t.numpy()), np.triu(pk64), scale=scale,
                     tol_dtype=np.float32)
    assert_approx_eq(np.tril(pk_t.numpy(), -1), np.tril(pk64, -1), scale=scale,
                     tol_dtype=np.float32)


@pytest.mark.parametrize("m,n", [(512, 512), (300, 200), (200, 300)])
def test_q_is_orthogonal_and_reconstructs(m, n, factor):
    a, (pk, ts, blk), _ = factor(m, n)
    bound = 8 * max(m, n) * EPS32
    for thin in (True, False):
        q = tqr.qr_compute_q(pk, ts, blk, thin=thin).numpy().astype(np.float64)
        assert q.shape == (m, min(m, n) if thin else m)
        assert np.abs(q.T @ q - np.eye(q.shape[1])).max() <= bound
    rec = tqr.qr_reconstruct(pk, ts, blk).numpy()
    assert _rel(rec, a.astype(np.float64)) <= bound


@pytest.mark.parametrize("adjoint", [False, True])
def test_qr_apply_q_matches_jax(adjoint, factor):
    a, (pk_t, ts_t, blk), (pk_j, ts_j, _) = factor(300, 200)
    b = np.random.default_rng(1).standard_normal((300, 3)).astype(np.float32)
    got = tqr.qr_apply_q(pk_t, ts_t, blk, torch.from_numpy(b),
                         adjoint=adjoint).numpy()
    want = np.asarray(jqr.qr_apply_q(pk_j, ts_j, blk, jnp.asarray(b),
                                     adjoint=adjoint))
    scale = size_scale(300) * KAPPA
    assert_approx_eq(got, want, scale=scale, tol_dtype=np.float32)
    q = tqr.qr_compute_q(pk_t, ts_t, blk, thin=False).numpy().astype(np.float64)
    assert_approx_eq(got, (q.T if adjoint else q) @ b, scale=size_scale(300),
                     tol_dtype=np.float32)


@pytest.mark.parametrize("m,n", [(300, 200), (512, 512)])
def test_qr_solve_lstsq_matches_jax_and_f64(m, n, factor):
    a, (pk_t, ts_t, blk), (pk_j, ts_j, _) = factor(m, n)
    b = np.random.default_rng(2).standard_normal((m, 4)).astype(np.float32)
    x_t = tqr.qr_solve_lstsq(pk_t, ts_t, blk, torch.from_numpy(b)).numpy()
    x_j = np.asarray(jqr.qr_solve_lstsq(pk_j, ts_j, blk, jnp.asarray(b)))
    x64 = np.linalg.lstsq(a.astype(np.float64), b.astype(np.float64), rcond=None)[0]
    tol = 8 * m * EPS32 * KAPPA ** 2
    assert x_t.shape == (n, 4)
    assert _rel(x_t, x64) <= tol
    assert _rel(x_t, x_j) <= tol
    # the residual is orthogonal to the columns
    r = b.astype(np.float64) - a.astype(np.float64) @ x_t
    assert np.linalg.norm(a.T @ r) <= 8 * m * EPS32 * KAPPA * \
        np.linalg.norm(a, 2) * max(np.linalg.norm(r), np.linalg.norm(b))


def test_qr_solve_and_inverse(factor):
    a, (pk, ts, blk), _ = factor(512, 512)
    a64 = a.astype(np.float64)
    b = np.random.default_rng(3).standard_normal((512, 2)).astype(np.float32)
    x = tqr.qr_solve(pk, ts, blk, torch.from_numpy(b)).numpy()
    tol = 8 * 512 * EPS32 * KAPPA
    assert _rel(x, np.linalg.solve(a64, b)) <= tol
    inv = tqr.qr_inverse(pk, ts, blk).numpy()
    assert _rel(inv, np.linalg.inv(a64)) <= tol


def test_qr_leaf_width_and_block_params(factor):
    """kernel_leaf 256 (rounded up from 200) and block 64 change the
    blocking, not the factor."""
    a, (pk, _, _), _ = factor(300, 200)
    pk2, ts2, blk2 = tqr.qr_in_place(torch.from_numpy(a),
                                     QrParams(block_size=64, kernel_leaf=200))
    assert blk2 == 64 and tuple(ts2.shape) == (4, 64, 64)
    assert_approx_eq(pk2.numpy(), pk.numpy(), scale=size_scale(300) * KAPPA,
                     tol_dtype=np.float32)


def test_qr_interop_round_trip(factor):
    a, (pk_t, ts_t, blk), (pk_j, ts_j, blk_j) = factor(300, 200)
    b = np.random.default_rng(4).standard_normal((300, 3)).astype(np.float32)
    x64 = np.linalg.lstsq(a.astype(np.float64), b.astype(np.float64), rcond=None)[0]
    tol = 8 * 300 * EPS32 * KAPPA ** 2
    # JAX factor -> port solve
    pk, ts, bl = interop.qr_from_numpy(np.asarray(pk_j), np.asarray(ts_j), blk_j,
                                        device="cpu")
    assert pk.dtype == torch.float32 and bl == blk_j
    x = tqr.qr_solve_lstsq(pk, ts, bl, torch.from_numpy(b)).numpy()
    assert _rel(x, x64) <= tol
    # port factor -> JAX solve
    pk_n, ts_n, bl_n = interop.qr_to_numpy(pk_t, ts_t, blk)
    xj = np.asarray(jqr.qr_solve_lstsq(jnp.asarray(pk_n), jnp.asarray(ts_n),
                                       bl_n, jnp.asarray(b)))
    assert _rel(xj, x64) <= tol
    # and back: numpy -> port tensors unchanged
    pk2, ts2, bl2 = interop.qr_from_numpy(pk_n, ts_n, bl_n, device="cpu")
    assert torch.equal(pk2, pk_t) and torch.equal(ts2, ts_t) and bl2 == blk


def test_qr_rejects_bad_shapes_and_dtypes():
    with pytest.raises(ShapeError):
        tqr.qr_in_place(torch.zeros(16))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tqr.qr_in_place(torch.eye(64, dtype=torch.bfloat16))
    # complex input runs the non-kernel body (item 10a): I = Q R with |R| = I
    for dt in (torch.complex128, torch.complex64):
        packed, ts, block = tqr.qr_in_place(torch.eye(64, dtype=dt))
        assert packed.dtype == dt and torch.equal(torch.triu(packed).abs(),
                                                  torch.eye(64, dtype=dt.to_real()))
    # the JAX package keeps its own params type; the port's has the same fields
    assert set(QrParams.__dataclass_fields__) == set(JQrParams.__dataclass_fields__)
