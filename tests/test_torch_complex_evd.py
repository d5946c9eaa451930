"""The port's complex general EVD (ROADMAP item 10b-i): the unitary
Hessenberg reduction, the triangular eigenvectors, ``evd`` and
``eigenvalues`` below the multishift route (n < 128: one ``complex_schur``
call), the facade (``Mat.eigen``, ``Mat.eigenvalues``, ``Eigen``,
``batched.eigenvalues``) and the scope of the slice: real input takes the
code it took before, to the bit, and a complex pencil's QZ entry points
(item 10b-ii) run. The multishift route (n ≥ 128) is in
``tests/test_torch_complex_evd_multishift.py``, split from this file to keep
each file's time short.

Inputs are made with numpy from a seed and handed to both packages; the
JAX side runs on the CPU with x64 on (``tests/conftest.py``), jitted once a
module. Tolerances: faer's 8·n·eps of the dtype, norm-wise for the
Hessenberg form against the JAX package's (the same reflectors, rounded
differently), entrywise for the eigenvectors of one T, and for the
residual ‖AV − VΛ‖/(‖A‖‖V‖); eigenvalues within 2·κ_i·η of f64 scipy
(``complex_cases.eig_ratio``).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import faer_tpu.linalg.evd as jevd
from complex_cases import DTYPES, eig_ratio, eps, hess_input, schur_backward
from faer_tpu.linalg import eigvec as jeig
import faer_tpu_torch as ft
from faer_tpu_torch.linalg import batched as tb
from faer_tpu_torch.linalg import complex_schur as tcs
from faer_tpu_torch.linalg import eigvec as teig
from faer_tpu_torch.linalg import evd as tevd
from faer_tpu_torch.linalg import schur_multishift as tms
from faer_tpu_torch.linalg import solvers as tsolvers
from faer_tpu_torch.ops.householder import make_householder
from faer_tpu_torch.ops.matmul import matmul

torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def _jax(name):
    """The JAX package's function, jitted once a module."""
    return jax.jit({"hess": jevd.hessenberg_blocked,
                    "vecs": jeig.triangular_eigenvectors}[name])


def _gauss(n, npdt, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))).astype(npdt)


def residual(a, w, v):
    """‖AV − VΛ‖/(‖A‖‖V‖) in complex128."""
    a, w, v = (np.asarray(x, np.complex128) for x in (a, w, v))
    return np.linalg.norm(a @ v - v * w[None, :]) / (np.linalg.norm(a) * np.linalg.norm(v))


@pytest.mark.parametrize("name", ["c64", "c128"])
def test_complex_hessenberg_blocked_against_jax(name):
    """``hessenberg_blocked`` at 200 (two panels of 96, then the unblocked
    tail) against the JAX package's on the same complex input: H and Q
    within 8·n·eps norm-wise (‖·‖_F/‖A‖_F and ‖·‖_F/√n), H exactly
    Hessenberg, A = QHQᴴ and QᴴQ = I within 8·n·eps."""
    tdt, npdt = DTYPES[name]
    n = 200
    a = _gauss(n, npdt, 200)
    h, q = tevd.hessenberg_blocked(torch.from_numpy(a))
    assert h.dtype == tdt and q.dtype == tdt
    hj, qj = _jax("hess")(jnp.asarray(a))
    tol = 8 * n * eps(npdt)
    an = np.linalg.norm(a)
    assert np.linalg.norm(h.numpy() - np.asarray(hj)) <= tol * an
    assert np.linalg.norm(q.numpy() - np.asarray(qj)) <= tol * np.sqrt(n)
    assert np.all(np.tril(h.numpy(), -2) == 0)
    rec, orth, _ = schur_backward(a, h.numpy(), q.numpy())
    assert rec <= tol and orth <= tol


@pytest.mark.parametrize("name", ["c64", "c128"])
def test_triangular_eigenvectors_against_jax(name):
    """``triangular_eigenvectors`` of the port's Schur form of a 48 × 48
    Hessenberg matrix: entrywise within 8·n·eps of the JAX package's on the
    same T, unit columns, ‖TX − XΛ‖/‖T‖ within 8·n·eps; a repeated
    eigenvalue (T[j, j] = T[k, k]) takes the clamped denominator and stays
    finite."""
    tdt, npdt = DTYPES[name]
    n = 48
    h = hess_input(n, npdt, seed=9)
    t, _, info = tcs.complex_schur(torch.from_numpy(h), torch.eye(n, dtype=tdt))
    assert bool(info.converged)
    x = teig.triangular_eigenvectors(t)
    assert x.dtype == tdt
    xj = np.asarray(_jax("vecs")(jnp.asarray(t.numpy())))
    tol = 8 * n * eps(npdt)
    assert np.abs(x.numpy() - xj).max() <= tol
    assert np.abs(np.linalg.norm(x.numpy().astype(np.complex128), axis=0) - 1).max() <= tol
    tn = t.numpy().astype(np.complex128)
    assert residual(tn, np.diag(tn), x.numpy()) <= tol * np.linalg.norm(x.numpy())
    t2 = t.clone()
    t2[5, 5] = t2[9, 9]
    x2 = teig.triangular_eigenvectors(t2)
    assert bool(torch.isfinite(torch.view_as_real(x2)).all())


@pytest.mark.parametrize("name,n", [("c64", 12), ("c128", 12), ("c64", 127), ("c128", 127)])
def test_complex_evd_direct_route(name, n, monkeypatch):
    """``evd`` below the multishift route: w and v of the input's dtype,
    converged, ‖AV − VΛ‖/(‖A‖‖V‖) within 8·n·eps, the eigenvalues within
    2·κ_i·η of f64 scipy (η the Schur step's backward error), w the Schur
    form's diagonal; the Schur step is one ``complex_schur`` call and no
    multishift round; ``eigenvalues`` equals ``evd``'s w to the bit (the
    same Schur form; at 12, where the CPU twin is quick)."""
    tdt, npdt = DTYPES[name]
    a = _gauss(n, npdt, n)
    schur, calls = [], []
    dispatch, direct = tevd._complex_schur_dispatch, tcs.complex_schur
    monkeypatch.setattr(tevd, "_complex_schur_dispatch",
                        lambda *x, **k: schur.append(dispatch(*x, **k)) or schur[-1])
    monkeypatch.setattr(tcs, "complex_schur",
                        lambda *x, **k: calls.append(1) or direct(*x, **k))
    monkeypatch.setattr(tms, "_sweep", None)  # no multishift round below 128
    w, v, info = tevd.evd(torch.from_numpy(a))
    assert w.dtype == tdt and v.dtype == tdt and bool(info.converged)
    assert len(schur) == len(calls) == 1
    tol = 8 * n * eps(npdt)
    assert residual(a, w.numpy(), v.numpy()) <= tol
    t, qs, _ = schur[0]
    assert torch.equal(t.diagonal(), w)
    rec, orth, eta = schur_backward(a, t.numpy(), qs.numpy())
    assert rec <= tol and orth <= tol and np.all(np.tril(t.numpy(), -1) == 0)
    assert eig_ratio(w.numpy(), a, eta) <= 1
    if n == 12:
        assert torch.equal(tevd.eigenvalues(torch.from_numpy(a)), w)


@pytest.mark.parametrize("name", ["c64", "c128"])
def test_complex_facade(name):
    """``Mat(c).eigen()``, ``Mat(c).eigenvalues()``, ``Eigen.new`` and
    ``batched.eigenvalues`` on complex input: one computation's results,
    the residual within 8·n·eps; the batch (3 × 16²) equal to the single
    calls to the bit."""
    tdt, npdt = DTYPES[name]
    n = 16
    a = _gauss(n, npdt, 16)
    eig = ft.Mat(torch.from_numpy(a)).eigen()
    assert isinstance(eig, tsolvers.Eigen)
    w, v = eig.eigenvalues, eig.eigenvectors
    assert w.dtype == tdt and v.dtype == tdt and bool(eig.info.converged)
    assert residual(a, w.numpy(), v.numpy()) <= 8 * n * eps(npdt)
    assert torch.equal(ft.Mat(torch.from_numpy(a)).eigenvalues(), w)
    e2 = tsolvers.Eigen.new(torch.from_numpy(a))
    assert torch.equal(e2.w, w) and torch.equal(e2.v, v)
    batch = np.stack([_gauss(n, npdt, 16 + k) for k in range(3)])
    wb = tb.eigenvalues(torch.from_numpy(batch))
    assert wb.shape == (3, n) and wb.dtype == tdt
    for k in range(3):
        assert torch.equal(wb[k], tevd.eigenvalues(torch.from_numpy(batch[k])))


def _old_hessenberg_in_place(a):
    """The real reduction as the port ran it before complex input (no
    conjugation anywhere)."""
    n = a.shape[0]
    q = torch.eye(n, dtype=a.dtype)
    h = a.clone()
    for j in range(n - 2):
        v, tau, _ = make_householder(h[j + 1:, j])
        w = matmul(None, v[None, :], h[j + 1:, :])[0]
        h[j + 1:, :] -= tau * v[:, None] * w[None, :]
        u = matmul(None, h[:, j + 1:], v[:, None])[:, 0]
        h[:, j + 1:] -= tau * u[:, None] * v[None, :]
        uq = matmul(None, q[:, j + 1:], v[:, None])[:, 0]
        q[:, j + 1:] -= tau * uq[:, None] * v[None, :]
    return torch.triu(h, -1), q


def _old_window_rehess(t, v, k):
    """The real window reduction of the multishift AED as it was."""
    w = t.shape[0]
    rows = torch.arange(w)
    one = torch.ones((), dtype=t.dtype)
    for j in range(max(w - 2, 0)):
        col = t[:, j]
        below1 = (rows > j + 1) & (rows < k)
        head = col[j + 1]
        tail2 = torch.where(below1, col * col, 0.0).sum()
        nrm = torch.sqrt(head * head + tail2)
        is_id = (tail2 == 0) | (j >= k - 2)
        beta = torch.where(head >= 0, -nrm, nrm)
        denom = torch.where(is_id, one, head - beta)
        u = torch.where(below1, col / denom, 0.0)
        u = u + ((rows == j + 1) & ~is_id).to(t.dtype)
        tau = torch.where(is_id, 0.0 * one, (beta - head) / torch.where(is_id, one, beta))
        wv = matmul(None, u[None, :], t)[0]
        t = t - tau * u[:, None] * wv[None, :]
        wu = matmul(None, t, u[:, None])[:, 0]
        t = t - tau * wu[:, None] * u[None, :]
        vu = matmul(None, v, u[:, None])[:, 0]
        v = v - tau * vu[:, None] * u[None, :]
    return t, v


@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
def test_real_input_takes_the_code_it_took_before(dt):
    """The conjugations of the shared code are no-ops on real tensors:
    ``hessenberg_in_place``, the AED's ``_window_rehess`` and
    ``_house3_batch`` of real input equal, to the bit, the real code they
    replaced (kept here as it was); ``evd`` of a real matrix equals its
    ``evd_pair`` combined, to the bit."""
    rng = np.random.default_rng(21)
    a = torch.from_numpy(rng.standard_normal((30, 30))).to(dt)
    for new, old in zip(tevd.hessenberg_in_place(a), _old_hessenberg_in_place(a)):
        assert torch.equal(new, old)
    t = torch.from_numpy(rng.standard_normal((24, 24))).to(dt)
    v = torch.eye(24, dtype=dt)
    for k in (24, 17):
        for new, old in zip(tms._window_rehess(t, v, torch.tensor(k)),
                            _old_window_rehess(t, v, torch.tensor(k))):
            assert torch.equal(new, old)
    v1, v2, v3 = (torch.from_numpy(rng.uniform(-1, 1, 8)).to(dt) for _ in range(3))
    v3[2] = v2[2] = 0.0
    tail2 = v2 * v2 + v3 * v3
    nrm = torch.sqrt(v1 * v1 + tail2)
    beta = torch.where(v1 >= 0, -nrm, nrm)
    is_id = tail2 == 0
    denom = torch.where(is_id, 1.0, v1 - beta)
    old = (torch.where(is_id, 0.0, (beta - v1) / torch.where(is_id, 1.0, beta)),
           torch.where(is_id, 0.0, v2 / denom), torch.where(is_id, 0.0, v3 / denom))
    for x, y in zip(tms._house3_batch(v1, v2, v3), old):
        assert torch.equal(x, y)
    w, vv, _ = tevd.evd(a[:9, :9].contiguous())
    (wr, wi), (vr, vi), _ = tevd.evd_pair(a[:9, :9].contiguous())
    assert torch.equal(w, torch.complex(wr, wi)) and torch.equal(vv, torch.complex(vr, vi))


@pytest.mark.parametrize("call", [
    lambda a, b: ft.qz(a, b), lambda a, b: ft.gevd(a, b),
    lambda a, b: ft.gevd_eigenvalues(a, b), lambda a, b: ft.Mat(a).generalized_eigen(b),
    lambda a, b: tsolvers.GeneralizedEigen.new(a, b),
])
def test_complex_qz_still_names_item_10b_ii(call):
    """Item 10b-ii ported the complex QZ and generalized EVD: each entry
    point takes the complex pencil (I, 2I), whose eigenvalues α/β are all
    1/2 (to the bit: the pencil stays diagonal); ``evd_pair`` refuses
    complex input (its pair form is the real EVD's)."""
    a = torch.eye(4, dtype=torch.complex64)
    out = call(a, 2 * a)
    if isinstance(out, torch.Tensor):
        w = out
    elif isinstance(out, tsolvers.GeneralizedEigen):
        w = out.eigenvalues
    elif len(out) == 5:  # qz: (s, t, q, z, info)
        w = out[0].diagonal() / out[1].diagonal()
    else:  # gevd: (alpha, beta, v, info)
        w = out[0] / out[1]
    assert torch.equal(w, torch.full((4,), 0.5, dtype=torch.complex64))
    with pytest.raises(TypeError, match="evd_pair"):
        tevd.evd_pair(a)
