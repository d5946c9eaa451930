"""Complex LLT and LDLT in the port (ROADMAP item 10a), through the
interleaved real embedding, against the JAX package's native-complex
functions, its (re, im) pair functions (``factor_cpair``) and a complex128
numpy oracle. The rest of the complex dense stack is in
``test_torch_complex_dense.py``, LU and QR in ``test_torch_complex_lu_qr.py``.

Inputs come from a numpy seed: ``g gᴴ/n + I`` (Hermitian positive
definite), complex64 and complex128 at n ∈ {1, 2, 7, 33, 130} (130
crosses a 128 block). Tolerance: faer's 8·n·eps of the dtype
(``utils/approx.py``) entrywise against both JAX routes and the oracle,
norm-wise (the backward error) for the solves.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import faer_tpu.linalg.cholesky as jchol
import faer_tpu.linalg.factor_cpair as jfc
from faer_tpu_torch.linalg import cholesky as tchol

from complex_cases import DTYPES, SIZES
from complex_cases import backward as _backward
from complex_cases import close as _close
from complex_cases import inputs as _inputs
from complex_cases import pair as _pair

torch.set_num_threads(1)


@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize("n", SIZES)
def test_llt_against_jax_routes_and_numpy(name, n):
    tdt, npdt = DTYPES[name]
    a, _, b, _ = _inputs(n, npdt)
    l, info = tchol.llt_factor(torch.from_numpy(a))
    assert l.dtype == tdt and bool(info.success) and int(info.dynamic_regularization_count) == 0
    assert np.all(np.asarray(l.imag.diagonal()) == 0)
    lj, _ = jchol.llt_factor(jnp.asarray(a))
    (lr, li), _ = jfc.llt_factor_pair(*_pair(a))
    oracle = np.linalg.cholesky(a.astype(np.complex128))
    for ref in (np.asarray(lj), np.asarray(lr) + 1j * np.asarray(li), oracle):
        _close(l.numpy(), ref, n, npdt)
    x = tchol.llt_solve(l, torch.from_numpy(b))
    _backward(a, x.numpy(), b, n, npdt)
    _close(x.numpy(), np.asarray(jchol.llt_solve(lj, jnp.asarray(b))), n, npdt)
    xr, xi = jfc.llt_solve_pair((lr, li), *_pair(b))
    _close(x.numpy(), np.asarray(xr) + 1j * np.asarray(xi), n, npdt)
    _close(tchol.llt_reconstruct(l).numpy(), a, n, npdt)
    _close((tchol.llt_inverse(l) @ torch.from_numpy(a)).numpy(), np.eye(n), n, npdt)


@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize("n", SIZES)
def test_ldlt_against_jax_routes_and_numpy(name, n):
    tdt, npdt = DTYPES[name]
    a, _, b, _ = _inputs(n, npdt)
    ld, info = tchol.ldlt_factor(torch.from_numpy(a))
    assert ld.dtype == tdt and bool(info.success)
    ldj, _ = jchol.ldlt_factor(jnp.asarray(a))
    (lr, li), _ = jfc.ldlt_factor_pair(*_pair(a))
    for ref in (np.asarray(ldj), np.asarray(lr) + 1j * np.asarray(li)):
        _close(ld.numpy(), ref, n, npdt)
    _close(tchol.ldlt_reconstruct(ld).numpy(), a, n, npdt)
    x = tchol.ldlt_solve(ld, torch.from_numpy(b))
    _backward(a, x.numpy(), b, n, npdt)
    _close(x.numpy(), np.asarray(jchol.ldlt_solve(ldj, jnp.asarray(b))), n, npdt)
    xr, xi = jfc.ldlt_solve_pair((lr, li), *_pair(b))
    _close(x.numpy(), np.asarray(xr) + 1j * np.asarray(xi), n, npdt)
    x1 = tchol.ldlt_solve(ld, torch.from_numpy(b[:, 0]))  # a 1-D right-hand side
    assert x1.shape == (n,)
    _close(x1.numpy(), x.numpy()[:, 0], n, npdt)


@pytest.mark.parametrize("name", list(DTYPES))
def test_embedding_round_trip_and_kernel_route(name, monkeypatch):
    """embed/extract invert each other; a complex64 LLT factors a 2n
    float32 matrix (the kernel route), complex128 a float64 one; the
    regularization count is the embedding's halved."""
    tdt, npdt = DTYPES[name]
    a, _, b, g = _inputs(5, npdt)
    c = torch.from_numpy(g)
    assert torch.equal(tchol.extract_pair(tchol.embed_pair(c)), c)
    assert torch.equal(tchol.extract_rhs(tchol.embed_rhs(torch.from_numpy(b))),
                       torch.from_numpy(b))
    seen = []
    real = tchol._llt_factor_recursive

    def spy(x, *args):
        seen.append((x.dtype, tuple(x.shape)))
        return real(x, *args)

    monkeypatch.setattr(tchol, "_llt_factor_recursive", spy)
    tchol.llt_factor(torch.from_numpy(a))
    assert seen == [(tdt.to_real(), (10, 10))]
    from faer_tpu_torch.core.params import LltRegularization

    bad = -torch.eye(3, dtype=tdt)
    l, info = tchol.llt_factor(bad, reg=LltRegularization(epsilon=1.0, delta=0.5))
    assert int(info.dynamic_regularization_count) == 3 and bool(~info.success)
