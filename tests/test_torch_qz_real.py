"""The port's real QZ at the JAX package's largest test size and on
singular pencils, against ``faer_tpu`` and scipy (split from
``tests/test_torch_qz.py`` to keep each file's time short; the helpers and
tolerances are that file's).

The singular cases are the JAX package's own: a B of rank n − 1 at 12
(``tests/test_qz_real.py:64-85``: exactly one infinite eigenvalue, the
finite ones against scipy), and a B of rank 3 at 8
(``tests/test_spectral.py:174-187``: the pencil equation column by column,
at least 3 infinite eigenvalues), each also against the JAX package's
count of infinite eigenvalues.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg as sla
import torch

from faer_tpu import stats
from faer_tpu.linalg import qz as jqz
from faer_tpu.linalg import qz_real as jqr
import faer_tpu_torch as ft
from faer_tpu_torch.linalg import qz_real as tqr
from faer_tpu_torch.ops.kernels import real_qz as kq
from test_torch_qz import DT, QZ_TOL, _pencil, check_qz, match_eigs, qz_eigs

torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def _jax(fn_name):
    fns = {"qz": jqr.real_qz, "pair": jqr.qz_eigenvalues_pair, "gevd": jqz.gevd_qz}
    return jax.jit(fns[fn_name])


def _jax_eigs(a, b):
    s, t, *_ = _jax("qz")(jnp.asarray(a), jnp.asarray(b))
    ar, ai, be = (np.asarray(x, np.float64) for x in _jax("pair")(s, t))
    return (ar + 1j * ai), be


@pytest.mark.parametrize("name", ["f32", "f64"])
def test_real_qz_48_matches_jax_and_scipy(name):
    tdt = DT[name][0]
    n = 48
    tol = QZ_TOL[name] * n
    a, b = _pencil(n, 70 + n, name)
    s, t = check_qz(a, b, tqr.real_qz(torch.tensor(a), torch.tensor(b)), tol)
    lam = qz_eigs(torch.tensor(s, dtype=tdt), torch.tensor(t, dtype=tdt))
    lref = sla.eigvals(a.astype(np.float64), b.astype(np.float64))
    bound = tol * max(1.0, np.abs(lref).max())
    assert match_eigs(lam, lref) < bound
    jal, jbe = _jax_eigs(a, b)
    assert match_eigs(lam, jal / jbe) < bound


@pytest.mark.parametrize("name", ["f32", "f64"])
def test_real_qz_singular_b_one_infinite_eigenvalue(name):
    """B of rank n − 1: exactly one infinite eigenvalue (β = 0), as in the
    JAX package, and the finite ones against scipy's."""
    tdt, _, npdt = DT[name]
    rng = np.random.default_rng(5)
    n = 12
    a = rng.standard_normal((n, n))
    b = rng.standard_normal((n, n))
    b[:, 3] = 0
    tol = QZ_TOL[name] * n
    an, bn = a.astype(npdt), b.astype(npdt)
    s, t = check_qz(an, bn, tqr.real_qz(torch.tensor(an), torch.tensor(bn)), tol)
    ar, ai, be = (x.double().numpy() for x in tqr.qz_eigenvalues_pair(
        torch.tensor(s, dtype=tdt), torch.tensor(t, dtype=tdt)))
    assert int(np.sum(be == 0)) == 1
    _, jbe = _jax_eigs(an, bn)
    assert int(np.sum(jbe == 0)) == 1
    lref = sla.eigvals(a, b)
    lref_fin = lref[np.isfinite(lref)]
    lam = (ar + 1j * ai)[be != 0] / be[be != 0]
    assert len(lam) == len(lref_fin)
    assert match_eigs(lam, lref_fin) < tol * max(1.0, np.abs(lref_fin).max())


def test_gevd_qz_singular_b_rank_3():
    """B = G Gᵀ of rank 3 at 8 (5 infinite eigenvalues): the pencil
    equation A v β = B v α column by column within 1e-10·max(‖A‖, ‖B‖)·100,
    at least 3 β below 1e-10, as many as the JAX package finds."""
    n = 8
    a = np.asarray(stats.standard_normal_mat(jax.random.key(62), n, n, jnp.float64))
    g = np.asarray(stats.standard_normal_mat(jax.random.key(63), n, 3, jnp.float64))
    b = g @ g.T
    alpha, beta, v, info = ft.gevd_qz(torch.tensor(a), torch.tensor(b))
    al, be, vn = alpha.numpy(), beta.numpy(), v.numpy()
    resid = np.abs(a @ vn * be[None, :] - b @ vn * al[None, :]).max()
    assert resid < 1e-10 * max(np.abs(a).max(), np.abs(b).max()) * 100
    n_inf = int(np.sum(np.abs(be) < 1e-10))
    _, jbeta, _, _ = _jax("gevd")(jnp.asarray(a), jnp.asarray(b))
    assert n_inf >= 3 and n_inf == int(np.sum(np.abs(np.asarray(jbeta)) < 1e-10))


def test_real_qz_iteration_budget_and_trivial_sizes():
    """``max_sweeps_factor=0`` runs no iteration (not converged, the
    pencil as given); n = 1 is converged with no iteration."""
    a, b = _pencil(6, 1, "f64")
    h, t, q, z = ft.hessenberg_triangular(torch.tensor(a), torch.tensor(b))
    s, t2, q2, z2, info = tqr.real_qz_iteration(h, t, q, z, max_sweeps_factor=0)
    assert not bool(info.converged) and int(info.iterations) == 0
    assert torch.equal(torch.triu(h, -1), s) and torch.equal(q2, q)
    one = torch.ones(1, 1, dtype=torch.float64)
    s1, t1, q1, z1, info1 = ft.real_qz(2 * one, 3 * one)
    assert bool(info1.converged) and int(info1.iterations) == 0
    assert float(s1 / t1 * q1 / z1) == pytest.approx(2 / 3)


def test_real_qz_batched_plain_ragged():
    """A ragged batch equals its problems run one at a time, to the bit,
    with their iteration counts and chase steps."""
    rng = np.random.default_rng(4)
    nmax, sizes = 10, [10, 6, 1, 0]
    hs, ts = [], []
    for _ in sizes:
        h, t, _, _ = ft.hessenberg_triangular(*(torch.tensor(rng.standard_normal((nmax, nmax)))
                                                for _ in range(2)))
        hs.append(h)
        ts.append(t)
    h, t = torch.stack(hs), torch.stack(ts)
    eye = torch.eye(nmax, dtype=torch.float64).repeat(len(sizes), 1, 1)
    out = kq.real_qz_batched(h, t, eye, eye.clone(), torch.tensor(sizes, dtype=torch.int32))
    for bi, n in enumerate(sizes):
        if n < 1:
            assert not bool(out[5][bi]) and int(out[4][bi]) == 0
            continue
        *mats, it, ok, steps = tqr.real_qz_iteration_plain(
            h[bi, :n, :n], t[bi, :n, :n], eye[bi, :n, :n], eye[bi, :n, :n])
        assert all(torch.equal(o[bi, :n, :n], x) for o, x in zip(out, mats))
        assert (int(out[4][bi]), bool(out[5][bi]), int(out[6][bi])) == (it, ok, steps)


@pytest.mark.parametrize("n,seed", [(4, 0), (5, 1), (12, 2)])
def test_real_qz_iteration_at_a_tiny_scale(n, seed):
    """A float32 Hessenberg/triangular pencil scaled by 2⁻⁶⁶ (≈ 1.4e-20,
    so the products of two entries are subnormal): the QZ iteration's
    backward error within 8·n·eps of the pencil's scale, as at scale 1
    (``deflate2`` scales each 2×2 block before forming A·adj(B))."""
    a, b = _pencil(n, 300 + seed, "f32")
    h, t, _, _ = ft.hessenberg_triangular(torch.tensor(a), torch.tensor(b))
    tiny = 2.0 ** -66
    h, t = h * tiny, t * tiny
    eye = torch.eye(n)
    s, t2, q, z, _, ok, _ = tqr.real_qz_iteration_plain(h, t, eye, eye)
    sd, td, qd, zd, hd, t0 = (x.double().numpy() for x in (s, t2, q, z, h, t))
    scale = max(np.abs(hd).max(), np.abs(t0).max())
    tol = 8 * n * float(np.finfo(np.float32).eps)
    assert ok
    assert np.abs(qd @ sd @ zd.T - hd).max() <= tol * scale
    assert np.abs(qd @ td @ zd.T - t0).max() <= tol * scale
