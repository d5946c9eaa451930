"""The complex self-adjoint EVD in the port (ROADMAP item 10a): Hermitian
input reduces to a real tridiagonal, whose QR iteration (or divide &
conquer) is the same one batched launch as for the real dtypes; the
back-transform is complex. Held against the JAX package's native-complex
``self_adjoint_evd`` and ``tridiag_in_place`` and complex128 numpy (the
JAX package has no pair self-adjoint EVD). The complex SVD is in
``test_torch_complex_svd.py``.

Inputs: complex Gaussians from a numpy seed, complex64 and complex128 at
n ∈ {1, 2, 7, 33, 130} (the QR-iteration route; D&C starts at 512, its
complex case runs on the card). Eigenvalues within 8·n·eps of the
largest; vectors within 8·n·eps (times the spread over the value's gap,
the first-order bound) after a unit phase per vector;
A = V diag(w) Vᴴ and VᴴV = I within 8·n·eps.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import faer_tpu.linalg.evd as jevd
import faer_tpu.linalg.tridiag as jtr
from faer_tpu_torch.linalg import evd as tevd
from faer_tpu_torch.linalg import tridiag as ttr

from complex_cases import DTYPES, SIZES, close, inputs, vectors_close

torch.set_num_threads(1)


@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize("n", SIZES)
def test_self_adjoint_evd_against_jax_and_numpy(name, n):
    tdt, npdt = DTYPES[name]
    _, h, _, _ = inputs(n, npdt)
    w, v, info = tevd.self_adjoint_evd(torch.from_numpy(h))
    assert w.dtype == tdt.to_real() and v.dtype == tdt and bool(info.converged)
    wj, vj, _ = jevd.self_adjoint_evd(jnp.asarray(h))
    wo = np.linalg.eigvalsh(h.astype(np.complex128))
    for ref in (np.asarray(wj), wo):
        close(w.numpy(), ref, n, npdt)
    vectors_close(v.numpy(), np.asarray(vj), wo, n, npdt)
    vv = v.numpy().astype(np.complex128)
    close(vv @ np.diag(w.numpy()) @ vv.conj().T, h, n, npdt)
    close(vv.conj().T @ vv, np.eye(n), n, npdt)
    close(tevd.self_adjoint_eigenvalues(torch.from_numpy(h)).numpy(), wo, n, npdt)


@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize("n", (7, 33))
def test_tridiag_against_jax(name, n):
    """Real d and e within 8·n·eps of the JAX package's hetrd, complex
    reflectors and τ; Qᴴ A Q is the tridiagonal."""
    tdt, npdt = DTYPES[name]
    _, h, b, _ = inputs(n, npdt)
    d, e, hh, taus = ttr.tridiag_in_place(torch.from_numpy(h))
    dj, ej, hhj, tj = (np.asarray(x) for x in jtr.tridiag_in_place(jnp.asarray(h)))
    assert d.dtype == e.dtype == tdt.to_real() and hh.dtype == taus.dtype == tdt
    for got, ref in ((d, dj), (e, ej), (hh, hhj), (taus, tj)):
        close(got.numpy(), ref, n, npdt)
    q = ttr.tridiag_apply_q(hh, taus, torch.eye(n, dtype=tdt)).numpy().astype(np.complex128)
    t = np.diag(d.numpy()) + np.diag(e.numpy(), -1) + np.diag(e.numpy(), 1)
    close(q.conj().T @ h @ q, t, n, npdt)
