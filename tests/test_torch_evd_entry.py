"""The port's general real EVD through its entry points (``evd``,
``eigenvalues``, ``evd_pair``, ``eigenvalues_pair``, ``Mat(a).eigen()``
and ``.eigenvalues()``, ``interop``'s ``Eigen``) against ``faer_tpu`` and
f64 numpy: a companion of ``tests/test_torch_evd_general.py``, split from
it to keep each file's time short.

Inputs are made with numpy from a seed; the JAX ``evd_pair`` is jitted
once a module (``_jax``) and runs on the CPU with x64 on
(``tests/conftest.py``); the port runs on the CPU (the ``real_schur``
kernel's plain version). Eigenvalues are compared sorted; eigenvectors
through ‖AV − V diag(w)‖, unit columns and adjacent conjugate pairs.
Tolerances: the JAX package's own tests' (``tests/test_real_schur.py``:
5e-5 for float32 eigenvalues, 2e-4·‖A‖ for eigenvector residuals), and
1e-12 in float64.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import faer_tpu.linalg.evd as jevd
from faer_tpu.linalg import solvers as jsolvers
import faer_tpu_torch as ft
from faer_tpu_torch import interop
from faer_tpu_torch.core.errors import ShapeError

torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def _jax(fn_name):
    """The JAX package's function, jitted once a module."""
    return jax.jit({"evd": jevd.evd_pair}[fn_name])


def _sorted_close(w, wref, tol):
    w, wref = np.sort_complex(np.asarray(w)), np.sort_complex(np.asarray(wref))
    assert np.max(np.abs(w - wref)) <= tol * max(1.0, np.max(np.abs(wref)))


def _conjugates_adjacent(w):
    w = np.asarray(w)
    i = 0
    while i < len(w):
        if w.imag[i] != 0:
            assert w.imag[i] > 0 and w[i + 1] == np.conj(w[i])
            i += 2
        else:
            i += 1


@pytest.mark.parametrize("n", [127, 128])
def test_evd_entry_points(n):
    """``evd``, ``eigenvalues``, ``Mat(a).eigen()`` and
    ``Mat(a).eigenvalues()`` in float32 on both sides of the multishift
    route edge: eigenvalues against f64 numpy and the JAX package's
    ``evd_pair`` within 5e-5, ‖AV − V diag(w)‖ ≤ 2e-4·‖A‖, unit columns,
    conjugate pairs adjacent, complex64 outputs."""
    a = np.random.default_rng(n).standard_normal((n, n))
    at = torch.tensor(a, dtype=torch.float32)
    w, v, info = ft.evd(at)
    assert bool(info.converged) and w.dtype == v.dtype == torch.complex64
    wn, vn = w.numpy().astype(np.complex128), v.numpy().astype(np.complex128)
    _sorted_close(wn, np.linalg.eigvals(a), 5e-5)
    assert np.linalg.norm(a @ vn - vn * wn) <= 2e-4 * np.linalg.norm(a)
    assert np.allclose(np.linalg.norm(vn, axis=0), 1.0, atol=1e-5)
    _conjugates_adjacent(wn)
    (wrj, wij), _, _ = _jax("evd")(jnp.asarray(a, jnp.float32))
    _sorted_close(wn, np.asarray(wrj, np.float64) + 1j * np.asarray(wij, np.float64), 5e-5)
    ev = ft.eigenvalues(at)
    assert ev.dtype == torch.complex64
    _sorted_close(ev.numpy(), wn, 5e-5)
    eig = ft.Mat(at).eigen()
    assert isinstance(eig, ft.Eigen) and torch.equal(eig.eigenvalues, w)
    assert torch.equal(eig.eigenvectors, v)
    _sorted_close(ft.Mat(at).eigenvalues().numpy(), wn, 5e-5)


def test_evd_f64_and_pairs():
    """float64 below the route edge: complex128 outputs, the residual within
    1e-12·‖A‖; ``evd_pair`` and ``eigenvalues_pair`` give the same
    eigenvalues as real (re, im) pairs."""
    n = 40
    a = np.random.default_rng(41).standard_normal((n, n))
    w, v, info = ft.evd(torch.tensor(a))
    assert w.dtype == torch.complex128 and bool(info.converged)
    wn, vn = w.numpy(), v.numpy()
    assert np.linalg.norm(a @ vn - vn * wn) <= 1e-12 * np.linalg.norm(a)
    _sorted_close(wn, np.linalg.eigvals(a), 1e-12)
    (wr, wi), (vr, vi), _ = ft.evd_pair(torch.tensor(a))
    assert np.array_equal(wr.numpy() + 1j * wi.numpy(), wn)
    wr2, wi2 = ft.eigenvalues_pair(torch.tensor(a))
    assert np.array_equal(wr2.numpy(), wr.numpy()) and np.array_equal(wi2.numpy(), wi.numpy())


def test_eigen_interop_with_jax():
    """``interop`` carries ``Eigen`` across: the JAX package's object
    becomes the port's and back, complex fields and info intact."""
    n = 12
    a = np.random.default_rng(12).standard_normal((n, n))
    jobj = jsolvers.Eigen.new(jnp.asarray(a))
    fields = {"v": np.asarray(jobj.v), "w": np.asarray(jobj.w),
              "info": {"converged": np.asarray(jobj.info.converged),
                       "iterations": np.asarray(jobj.info.iterations)}}
    tobj = interop.solver_from_numpy("Eigen", device="cpu", **fields)
    assert isinstance(tobj, ft.Eigen) and tobj.w.dtype == torch.complex128
    assert np.array_equal(tobj.w.numpy(), fields["w"])
    kind, back = interop.solver_to_numpy(ft.Mat(torch.tensor(a)).eigen())
    assert kind == "Eigen" and back["w"].dtype == np.complex128
    _sorted_close(back["w"], fields["w"], 1e-12)
    jsolvers.Eigen(v=jnp.asarray(back["v"]), w=jnp.asarray(back["w"]), info=jobj.info)


def test_general_evd_refusals():
    """The complex general EVD (item 10b-i) runs (the eigenvalues of I are
    1), and so does a complex pencil's generalized EVD (item 10b-ii): a
    complex A with a real B of its precision promotes B (the eigenvalues of
    (I, I) are 1)."""
    w, _, _ = ft.evd(torch.eye(3, dtype=torch.complex64))
    assert torch.equal(w, torch.ones(3, dtype=torch.complex64))
    gc = ft.Mat(torch.eye(3, dtype=torch.complex64)).generalized_eigen(torch.eye(3))
    assert torch.equal(gc.eigenvalues, torch.ones(3, dtype=torch.complex64))
    ge = ft.Mat(torch.eye(3)).generalized_eigen(ft.Mat(2 * torch.eye(3)))
    assert torch.equal(ge.eigenvalues, torch.full((3,), 0.5, dtype=torch.complex64))
    with pytest.raises(ShapeError):
        ft.evd(torch.zeros(3, 4))
