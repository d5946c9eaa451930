"""The port's complex generalized EVD (ROADMAP item 10b-ii) as a whole:
``gevd`` (both methods), ``gevd_eigenvalues``, ``qz``, ``gevd_self_adjoint``
and the facade on complex pencils, and the triangular pencil's
eigenvectors (``eigvec.triangular_generalized_eigenvectors``), against
``faer_tpu`` (its native complex route on the CPU: ``gevd``, and
``qz_cpair._gen_eigvec_scan`` for the eigenvectors) and f64 scipy; and
the scope of the slice: a real pencil takes the code it took before, to
the bit. The multishift QZ against the JAX package's pair form is in
``tests/test_torch_complex_qz_multishift.py``, ``gevd`` at 128 and 130
(the multishift route) in ``tests/test_torch_complex_gevd_multishift.py``:
split from this file to keep each file's time short.

Inputs are complex Gaussian pencils made with numpy from a seed and
handed to both packages; the JAX side runs on the CPU with x64 on
(``tests/conftest.py``), jitted once a module and shape. Tolerances:
faer's 8·n·eps of the dtype for the QZ step's backward errors and
unitarity and for the pencil residual max_k ‖A v_k β_k − B v_k α_k‖ /
((‖A‖₂|β_k| + ‖B‖₂|α_k|)‖v_k‖); the (α, β) pairs within 2·κ_i·η of f64
``scipy.linalg.eig`` in the chordal metric, matched to the nearest (κ_i
the pencil's chordal condition number, η the QZ step's measured backward
error). The JAX package's ``gevd`` solves one triangular system a column
in a Python loop: jitted at n = 12 it costs seconds, at 127 minutes, so it
is held beside the port at 12, and scipy at every n.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg as sla
import torch

import faer_tpu_torch as ft
from complex_cases import (DTYPES, chordal_ratio, eps, pair, pencil_input, pencil_residual,
                           qz_backward)
from faer_tpu.linalg import gevd as jgevd
from faer_tpu.linalg import qz_cpair as jqp
from faer_tpu_torch.linalg import eigvec as teig
from faer_tpu_torch.linalg import qz as tqz
from faer_tpu_torch.linalg import solvers as tsolvers

torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def _jax(name):
    fns = {"gevd": jgevd.gevd, "scan": jqp._gen_eigvec_scan}
    return jax.jit(fns[name])


@pytest.mark.parametrize("name", ["c64", "c128"])
def test_triangular_generalized_eigenvectors_against_jax_scan(name):
    """The triangular pencil's eigenvectors of the port's (S, T) at 24
    against the JAX package's ``_gen_eigvec_scan`` (the same bottom-up scan
    over (re, im) pairs) on the same (S, T, α, β): each column within
    8·n·eps·κ_k of it (κ_k the column's condition, ‖y_k‖ over its
    smallest pivot's margin, bounded here by 1e3), and (β S − α T) y ≈ 0
    within 8·n·eps of ‖(S, T)‖ column by column."""
    tdt, npdt = DTYPES[name]
    n = 24
    a, b = pencil_input(n, npdt, seed=4)
    s, t, _, _, info = ft.qz(torch.from_numpy(a), torch.from_numpy(b))
    assert bool(info.converged)
    alpha, beta = s.diagonal().clone(), t.diagonal().clone()
    y = teig.triangular_generalized_eigenvectors(s, t, alpha, beta).numpy()
    jr, ji = _jax("scan")(*(pair(x.numpy()) for x in (s, t, alpha, beta)))
    yj = np.asarray(jr) + 1j * np.asarray(ji)
    assert np.abs(y - yj).max() <= 8 * n * eps(npdt) * 1e3
    sn, tn = (x.numpy().astype(np.complex128) for x in (s, t))
    al, be = (x.numpy().astype(np.complex128) for x in (alpha, beta))
    yn = y.astype(np.complex128)
    res = np.abs(sn @ yn * be[None, :] - tn @ yn * al[None, :]).max()
    assert res <= 8 * n * eps(npdt) * max(np.abs(sn).max(), np.abs(tn).max())
    assert np.allclose(np.linalg.norm(yn, axis=0), 1.0, rtol=0, atol=8 * n * eps(npdt))


@pytest.mark.parametrize("n,name", [(12, "c64"), (12, "c128"), (127, "c64")])
def test_complex_gevd_slice(n, name, monkeypatch):
    """``gevd`` of a complex pencil at 12 and at 127 (the direct route: one
    ``complex_qz`` call), as :func:`check_complex_gevd` holds it (128 and
    130, the multishift route, are in
    ``tests/test_torch_complex_gevd_multishift.py``)."""
    check_complex_gevd(n, name, monkeypatch)


def check_complex_gevd(n, name, monkeypatch):
    """``gevd`` of a complex pencil at n: the QZ step (captured inside the
    call, the computation ``qz`` returns) with S, T triangular, the backward
    errors and unitarity within 8·n·eps; the pencil residual within
    8·n·eps; (α, β) within 2·κ_i·η of scipy's. At 12 also ``qz`` itself and
    ``gevd_eigenvalues`` (α/β to the bit), and the JAX package's ``gevd``
    of the same pencil: its residual and (α, β) pass the same checks, and
    the two (α, β) sets match each other."""
    tdt, npdt = DTYPES[name]
    a, b = pencil_input(n, npdt, seed=5)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    steps = []
    complex_qz = tqz._complex_qz
    monkeypatch.setattr(tqz, "_complex_qz",
                        lambda *x, **k: steps.append(complex_qz(*x, **k)) or steps[-1])
    alpha, beta, v, info = ft.gevd(ta, tb)
    assert bool(info.converged) and all(x.dtype == tdt for x in (alpha, beta, v))
    s, t, q, z, sinfo = steps[0]
    assert (int(sinfo.iterations) <= 30 * n) and bool(sinfo.converged)
    assert torch.equal(alpha, s.diagonal()) and torch.equal(beta, t.diagonal())
    sn, tn = s.numpy(), t.numpy()
    assert np.all(np.tril(sn, -1) == 0) and np.all(np.tril(tn, -1) == 0)
    tol = 8 * n * eps(npdt)
    *errs, eta = qz_backward(a, b, sn, tn, q.numpy(), z.numpy())
    assert max(errs) <= tol, errs
    assert pencil_residual(a, b, alpha.numpy(), beta.numpy(), v.numpy()) <= tol
    assert chordal_ratio(alpha.numpy(), beta.numpy(), a, b, eta) <= 1
    if n != 12:
        return
    s2, t2, q2, z2, _ = ft.qz(ta, tb)
    assert all(torch.equal(x, y) for x, y in zip((s2, t2, q2, z2), (s, t, q, z)))
    assert torch.equal(ft.gevd_eigenvalues(ta, tb), alpha / beta)
    ja, jb, jv, jinfo = (np.asarray(x) if not hasattr(x, "converged") else x
                         for x in _jax("gevd")(jnp.asarray(a), jnp.asarray(b)))
    assert bool(jinfo.converged)
    assert pencil_residual(a, b, ja, jb, jv) <= tol
    assert chordal_ratio(ja, jb, a, b, eta) <= 1
    assert chordal_ratio(alpha.numpy(), beta.numpy(), a, b, 2 * eta, other=(ja, jb)) <= 1


@pytest.mark.parametrize("name", ["c64", "c128"])
def test_complex_gevd_reduction_method(name):
    """``method="reduction"`` on a complex pencil: C = B⁻¹A by LU, then the
    complex ``evd``, β = 1; the eigenvalues within 2·κ_i·η of scipy's, η
    the measured backward error of the two steps (‖A − BĈ‖₂ + ‖B‖₂‖Ĉv −
    λv‖ over the columns), and an unknown method refused."""
    tdt, npdt = DTYPES[name]
    n = 40
    a, b = pencil_input(n, npdt, seed=6)
    alpha, beta, v, info = ft.gevd(torch.from_numpy(a), torch.from_numpy(b),
                                   method="reduction")
    assert bool(info.converged) and bool((beta == 1).all()) and alpha.dtype == tdt
    a64, b64 = a.astype(np.complex128), b.astype(np.complex128)
    c = np.linalg.solve(b64, a64)
    vn, w = v.numpy().astype(np.complex128), alpha.numpy().astype(np.complex128)
    eta = np.linalg.norm(b64, 2) * np.linalg.norm(c @ vn - vn * w[None, :], 2) \
        + n * eps(npdt) * np.linalg.norm(b64, 2) * np.linalg.norm(c, 2)
    assert chordal_ratio(alpha.numpy(), beta.numpy(), a, b, eta) <= 1
    with pytest.raises(ValueError):
        ft.gevd(torch.from_numpy(a), torch.from_numpy(b), method="cholesky")


@pytest.mark.parametrize("name", ["c64", "c128"])
def test_complex_gevd_self_adjoint(name):
    """A Hermitian A (its lower triangle read) and a Hermitian positive
    definite B: A V = B V diag(w) and Vᴴ B V = I within 8·n·eps·κ(B), w
    real, ascending and within 8·n·eps·‖w‖ of f64 ``scipy.linalg.eigh``."""
    tdt, npdt = DTYPES[name]
    n = 24
    g, h = pencil_input(n, npdt, seed=7)
    a = ((g + g.conj().T) / 2).astype(npdt)
    b = (h @ h.conj().T / n + np.eye(n)).astype(npdt)
    lower = np.tril(a) + np.triu(np.full((n, n), np.nan), 1)  # the upper triangle unread
    w, v, info = ft.gevd_self_adjoint(torch.from_numpy(lower.astype(npdt)), torch.from_numpy(b))
    assert not w.is_complex() and v.dtype == tdt and bool((w[1:] >= w[:-1]).all())
    a64, b64 = a.astype(np.complex128), b.astype(np.complex128)
    wn, vn = w.numpy().astype(np.float64), v.numpy().astype(np.complex128)
    tol = 8 * n * eps(npdt) * np.linalg.cond(b64)
    assert np.linalg.norm(a64 @ vn - b64 @ vn * wn[None, :]) <= tol * np.linalg.norm(a64) \
        * np.linalg.norm(vn)
    assert np.abs(vn.conj().T @ b64 @ vn - np.eye(n)).max() <= tol
    ref = sla.eigh(a64, b64, eigvals_only=True)
    assert np.abs(wn - ref).max() <= 8 * n * eps(npdt) * np.abs(ref).max() * np.linalg.cond(b64)


@pytest.mark.parametrize("name", ["c64", "c128"])
def test_complex_a_with_real_b_promotes(name):
    """A complex A with a real B of its precision takes B to A's dtype (as
    the JAX package casts the pencil): the same bits as the complex B; a
    real B of the other precision is refused."""
    tdt, npdt = DTYPES[name]
    a, _ = pencil_input(10, npdt, seed=8)
    rdt, other = (np.float32, np.float64) if npdt is np.complex64 else (np.float64, np.float32)
    b = np.random.default_rng(8).standard_normal((10, 10)).astype(rdt)
    out = ft.gevd(torch.from_numpy(a), torch.from_numpy(b))
    want = ft.gevd(torch.from_numpy(a), torch.from_numpy(b.astype(npdt)))
    assert all(torch.equal(x, y) for x, y in zip(out[:3], want[:3]))
    with pytest.raises(TypeError):  # a real B of the other precision
        ft.gevd(torch.from_numpy(a), torch.from_numpy(b.astype(other)))


@pytest.mark.parametrize("name", ["c64", "c128"])
def test_complex_generalized_eigen_facade(name):
    """``Mat(a).generalized_eigen(b)`` and ``GeneralizedEigen.new`` on a
    complex pencil: ``gevd``'s α, β, V and info to the bit, eigenvalues
    α/β; B may be a ``Mat``, a tensor or an array."""
    tdt, npdt = DTYPES[name]
    a, b = pencil_input(16, npdt, seed=9)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    ge = ft.Mat(ta).generalized_eigen(ft.Mat(tb))
    alpha, beta, v, _ = ft.gevd(ta, tb)
    assert isinstance(ge, ft.GeneralizedEigen) and ge.alpha.dtype == tdt
    assert torch.equal(ge.alpha, alpha) and torch.equal(ge.beta, beta) and torch.equal(ge.v, v)
    assert torch.equal(ge.eigenvalues, alpha / beta) and bool(ge.info.converged)
    ge2 = tsolvers.GeneralizedEigen.new(ta, b)
    assert torch.equal(ge2.alpha, alpha) and torch.equal(ge2.eigenvalues, ge.eigenvalues)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_real_pencil_keeps_its_bits(dtype):
    """Scope: a real pencil takes the real QZ as before this slice, to the
    bit: ``gevd`` equals ``real_qz`` + the quasi-triangular eigenvectors,
    ``qz`` equals ``real_qz``, and ``gevd_self_adjoint`` of a real pencil
    equals its real reduction written with transposes."""
    from faer_tpu_torch.linalg.cholesky import llt_factor
    from faer_tpu_torch.linalg.evd import self_adjoint_evd
    from faer_tpu_torch.linalg.qz_real import qz_eigenvalues_pair
    from faer_tpu_torch.ops.matmul import matmul
    from faer_tpu_torch.ops.triangular_solve import (
        solve_lower_triangular,
        solve_lower_triangular_transpose,
    )

    rng = np.random.default_rng(10)
    n = 20
    a = torch.tensor(rng.standard_normal((n, n)), dtype=dtype)
    b = torch.tensor(rng.standard_normal((n, n)), dtype=dtype)
    s, t, q, z, _ = ft.real_qz(a, b)
    assert all(torch.equal(x, y) for x, y in zip(ft.qz(a, b)[:4], (s, t, q, z)))
    ar, ai, be = qz_eigenvalues_pair(s, t)
    yr, yi = teig.quasi_triangular_generalized_eigenvectors_pair(s, t, ar, ai, be)
    alpha, beta, v, _ = ft.gevd(a, b)
    assert torch.equal(alpha, torch.complex(ar, ai)) and torch.equal(beta.real, be)
    assert torch.equal(v, torch.complex(matmul(None, z, yr), matmul(None, z, yi)))
    sa = a + a.T
    spd = b @ b.T / n + torch.eye(n, dtype=dtype)
    l, _ = llt_factor(spd)
    c = solve_lower_triangular(l, torch.tril(sa) + torch.tril(sa, -1).T)
    c = solve_lower_triangular(l, c.T).T
    w, y, _ = self_adjoint_evd(0.5 * (c + c.T))
    w2, v2, _ = ft.gevd_self_adjoint(sa, spd)
    assert torch.equal(w2, w) and torch.equal(v2, solve_lower_triangular_transpose(l, y))
