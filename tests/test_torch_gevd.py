"""The port's generalized EVD (``gevd``, its two variants, the (α, β)
pairs, the pencil's eigenvectors, ``GeneralizedEigen``) against
``faer_tpu`` and scipy.

Inputs are made with numpy from a seed, or, where a case repeats one of
the JAX package's own tests, with that test's ``faer_tpu.stats`` key, and
handed to both packages as numpy arrays. The JAX side runs on the CPU,
jitted once a shape. The port side runs on the CPU (the kernels' plain
versions).

Tolerances: the (α, β) pairs and the eigenvectors of the JAX package's
own (S, T) within 1e-14 in float64 (the same arithmetic on the same
blocks, rounded in another order); ``gevd``, ``gevd_self_adjoint`` and
the QZ eigenvectors at the JAX package's tests' tolerances
(``tests/test_spectral.py:107-130``, ``tests/test_qz_real.py:101-129``);
float32 at the same scale with float32's eps.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg as sla
import torch

from faer_tpu import stats
from faer_tpu.linalg import eigvec as jeig
from faer_tpu.linalg import gevd as jgevd
from faer_tpu.linalg import qz_real as jqr
from faer_tpu.linalg import solvers as jsolvers
from faer_tpu.utils.approx import assert_approx_eq, size_scale
import faer_tpu_torch as ft
from faer_tpu_torch import interop
from faer_tpu_torch.linalg import eigvec as teig
from faer_tpu_torch.linalg import solvers as tsolvers
from test_torch_qz import match_eigs

torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def _jax(fn_name):
    fns = {"qz": jqr.real_qz, "pair": jqr.qz_eigenvalues_pair,
           "vecs": jeig.quasi_triangular_generalized_eigenvectors_pair, "gevd": jgevd.gevd}
    return jax.jit(fns[fn_name])


def _spectral_general_pencil(npdt=np.float64):
    """``tests/test_spectral.py:119``'s pencil: n = 16, B + 3I."""
    n = 16
    k1, k2 = jax.random.split(jax.random.key(56))
    a = np.asarray(stats.standard_normal_mat(k1, n, n, jnp.float64))
    b = np.asarray(stats.standard_normal_mat(k2, n, n, jnp.float64)) + 3.0 * np.eye(n)
    return a.astype(npdt), b.astype(npdt)


def _jax_schur(n, seed):
    rng = np.random.default_rng(seed)
    a, b = rng.standard_normal((n, n)), rng.standard_normal((n, n))
    s, t, *_ = _jax("qz")(jnp.asarray(a), jnp.asarray(b))
    return np.asarray(s), np.asarray(t)


def test_qz_eigenvalues_pair_on_jax_schur():
    """(α_re, α_im, β) of the JAX package's own (S, T) (1×1 and 2×2 blocks)
    within 1e-14 of its ``qz_eigenvalues_pair``."""
    s, t = _jax_schur(16, 21)
    assert np.any(np.diag(s, -1) != 0)  # complex pairs among the blocks
    got = ft.qz_eigenvalues_pair(torch.tensor(s), torch.tensor(t))
    ref = _jax("pair")(jnp.asarray(s), jnp.asarray(t))
    for g, r in zip(got, ref):
        assert np.abs(g.numpy() - np.asarray(r)).max() <= 1e-14 * max(np.abs(r).max(), 1)


def test_pencil_eigenvectors_on_jax_schur():
    """The pencil's eigenvectors of the JAX package's own (S, T) within
    1e-14 of its ``quasi_triangular_generalized_eigenvectors_pair``, and
    (β S − α T) y ≈ 0 column by column."""
    s, t = _jax_schur(16, 22)
    ar, ai, be = (np.asarray(x) for x in _jax("pair")(jnp.asarray(s), jnp.asarray(t)))
    yr, yi = teig.quasi_triangular_generalized_eigenvectors_pair(
        *(torch.tensor(x) for x in (s, t, ar, ai, be)))
    jr, ji = _jax("vecs")(*(jnp.asarray(x) for x in (s, t, ar, ai, be)))
    assert np.abs(yr.numpy() - np.asarray(jr)).max() <= 1e-14
    assert np.abs(yi.numpy() - np.asarray(ji)).max() <= 1e-14
    y = yr.numpy() + 1j * yi.numpy()
    al = ar + 1j * ai
    res = np.abs(s @ y * be[None, :] - t @ y * al[None, :]).max()
    assert res <= 1e-13 * max(np.abs(s).max(), np.abs(t).max())


@pytest.mark.parametrize("npdt", [np.float64, np.float32])
def test_gevd_general(npdt):
    """``tests/test_spectral.py:119``: A v = λ B v within
    size_scale(n)·512·eps·‖B‖·max|λ|; the eigenvalues against the JAX
    package's ``gevd`` and scipy's."""
    a, b = _spectral_general_pencil(npdt)
    n = len(a)
    eps = float(np.finfo(npdt).eps)
    alpha, beta, v, info = ft.gevd(torch.tensor(a), torch.tensor(b))
    assert bool(info.converged)
    lam = (alpha / beta).numpy().astype(np.complex128)
    ad, bd, vn = a.astype(np.float64), b.astype(np.float64), v.numpy().astype(np.complex128)
    resid = np.abs(ad @ vn - bd @ vn * lam[None, :]).max()
    assert resid < size_scale(n) * 512 * eps * np.abs(bd).max() * np.abs(lam).max()
    bound = size_scale(n) * 512 * eps * np.abs(lam).max()
    assert match_eigs(lam, sla.eigvals(ad, bd)) < bound
    ja, jb, _, _ = _jax("gevd")(jnp.asarray(a), jnp.asarray(b))
    assert match_eigs(lam, np.asarray(ja) / np.asarray(jb)) < bound
    w = ft.gevd_eigenvalues(torch.tensor(a), torch.tensor(b))
    assert torch.equal(w, alpha / beta)


@pytest.mark.parametrize("npdt", [np.float64, np.float32])
def test_gevd_reduction_method(npdt):
    """``method="reduction"``: C = B⁻¹A by LU, then ``evd``, β = 1."""
    a, b = _spectral_general_pencil(npdt)
    n = len(a)
    eps = float(np.finfo(npdt).eps)
    alpha, beta, v, info = ft.gevd(torch.tensor(a), torch.tensor(b), method="reduction")
    assert bool(info.converged) and bool((beta == 1).all())
    lam = alpha.numpy().astype(np.complex128)
    assert match_eigs(lam, sla.eigvals(a.astype(np.float64), b.astype(np.float64))) < \
        size_scale(n) * 512 * eps * np.abs(lam).max()
    with pytest.raises(ValueError):
        ft.gevd(torch.tensor(a), torch.tensor(b), method="cholesky")


@pytest.mark.parametrize("npdt", [np.float64, np.float32])
def test_gevd_self_adjoint(npdt):
    """``tests/test_spectral.py:107``: A V = B V diag(w) and Vᵀ B V = I at
    size_scale(n)·64; w against the JAX package's and scipy's ``eigh``."""
    n = 24
    k1, k2 = jax.random.split(jax.random.key(55))
    a = np.asarray(stats.self_adjoint_mat(k1, n, jnp.float64)).astype(npdt)
    b = np.asarray(stats.spd_mat(k2, n, jnp.float64)).astype(npdt)
    w, v, info = ft.gevd_self_adjoint(torch.tensor(a), torch.tensor(b))
    wn, vn = w.numpy(), v.numpy()
    scale = size_scale(n) * 64
    assert_approx_eq(a @ vn, b @ vn * wn[None, :], scale=scale)
    assert_approx_eq(vn.T @ b @ vn, np.eye(n, dtype=npdt), scale=scale)
    jw, _, _ = jgevd.gevd_self_adjoint(jnp.asarray(a), jnp.asarray(b))
    ref = sla.eigh(a.astype(np.float64), b.astype(np.float64), eigvals_only=True)
    tol = scale * float(np.finfo(npdt).eps) * np.abs(ref).max()
    assert np.abs(wn - ref).max() <= tol and np.abs(wn - np.asarray(jw)).max() <= tol


def test_real_gevd_eigenvectors():
    """``tests/test_qz_real.py:101``: A v β = B v α column by column at 48,
    the eigenvalues against scipy's, and a singular B (a zero first row and
    column) whose infinite eigenvalue surfaces."""
    rng = np.random.default_rng(5)
    n = 48
    a = rng.standard_normal((n, n))
    b = rng.standard_normal((n, n))
    al, be, v, info = (x.numpy() if isinstance(x, torch.Tensor) else x
                       for x in ft.gevd(torch.tensor(a), torch.tensor(b)))
    res = np.abs(a @ v * be[None, :] - b @ v * al[None, :]).max()
    assert res < 1e-10 * max(np.abs(a).max(), np.abs(b).max()) * n
    w = al / be
    wref = sla.eigvals(a, b)
    assert max(np.abs(wref - w[np.argmin(np.abs(w - x))]).min() for x in wref) < 1e-10
    bs = rng.standard_normal((n, n))
    bs[:, 0] = 0
    bs[0] = 0
    al, be, v, _ = (x.numpy() if isinstance(x, torch.Tensor) else x
                    for x in ft.gevd(torch.tensor(a), torch.tensor(bs)))
    assert np.abs(a @ v * be[None, :] - bs @ v * al[None, :]).max() < 1e-9
    assert (np.abs(be) < 1e-12).sum() >= 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_generalized_eigen_facade(dtype):
    """``Mat(a).generalized_eigen(b)`` is ``GeneralizedEigen.new(a, b)``:
    ``gevd``'s α, β, V and info, eigenvalues α/β; B may be a ``Mat``, a
    tensor or an array."""
    a, b = (x.astype(np.float64) for x in _spectral_general_pencil())
    ta, tb = torch.tensor(a, dtype=dtype), torch.tensor(b, dtype=dtype)
    ge = ft.Mat(ta).generalized_eigen(ft.Mat(tb))
    alpha, beta, v, _ = ft.gevd(ta, tb)
    assert isinstance(ge, ft.GeneralizedEigen)
    assert torch.equal(ge.alpha, alpha) and torch.equal(ge.beta, beta) and torch.equal(ge.v, v)
    assert torch.equal(ge.eigenvalues, alpha / beta) and bool(ge.info.converged)
    ge2 = tsolvers.GeneralizedEigen.new(ta, tb.numpy())
    assert torch.equal(ge2.alpha, alpha) and ge2.alpha.device == ta.device


def test_generalized_eigen_interop():
    """``interop`` carries ``GeneralizedEigen`` across: the JAX package's
    object becomes the port's and back, complex fields and info intact."""
    a, b = _spectral_general_pencil()
    ja, jb, jv, jinfo = _jax("gevd")(jnp.asarray(a), jnp.asarray(b))
    jobj = jsolvers.GeneralizedEigen(alpha=ja, beta=jb, v=jv, info=jinfo)
    fields = {f.name: np.asarray(getattr(jobj, f.name)) for f in dataclasses.fields(jobj)
              if f.name != "info"}
    fields["info"] = {"converged": np.asarray(jinfo.converged),
                      "iterations": np.asarray(jinfo.iterations)}
    tobj = interop.solver_from_numpy("GeneralizedEigen", device="cpu", **fields)
    assert isinstance(tobj, ft.GeneralizedEigen) and tobj.alpha.dtype == torch.complex128
    assert np.array_equal(tobj.beta.numpy(), fields["beta"])
    kind, back = interop.solver_to_numpy(ft.Mat(torch.tensor(a)).generalized_eigen(
        torch.tensor(b)))
    assert kind == "GeneralizedEigen" and back["alpha"].dtype == np.complex128
    assert match_eigs(back["alpha"] / back["beta"], np.asarray(ja) / np.asarray(jb)) < 1e-10
    jsolvers.GeneralizedEigen(alpha=jnp.asarray(back["alpha"]), beta=jnp.asarray(back["beta"]),
                              v=jnp.asarray(back["v"]), info=jinfo)


def test_complex_pencils_name_item_10():
    """Item 10b-ii ported the complex pencil: ``gevd``, ``gevd_eigenvalues``,
    ``gevd_self_adjoint``, ``hessenberg_triangular`` and the facade take
    the pencil (I, 2I) (eigenvalues 1/2, to the bit but through the
    Cholesky factor √2 of ``gevd_self_adjoint``); ``real_qz`` still refuses
    it, naming ``qz``."""
    c = torch.eye(3, dtype=torch.complex64)
    half = torch.full((3,), 0.5, dtype=torch.complex64)
    alpha, beta, _, _ = ft.gevd(c, 2 * c)
    assert torch.equal(alpha / beta, half)
    assert torch.equal(ft.gevd_eigenvalues(c, 2 * c), half)
    w, _, _ = ft.gevd_self_adjoint(c, 2 * c)  # through √2: within 8·n·eps
    assert (w - half.real).abs().max() <= 8 * 3 * torch.finfo(torch.float32).eps
    h, r, _, _ = ft.hessenberg_triangular(c, 2 * c)
    assert torch.equal(h.diagonal() / r.diagonal(), half)
    assert torch.equal(ft.Mat(c).generalized_eigen(2 * c).eigenvalues, half)
    with pytest.raises(NotImplementedError, match="qz"):
        ft.real_qz(c, c)
