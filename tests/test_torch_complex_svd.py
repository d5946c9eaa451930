"""The complex SVD in the port (ROADMAP item 10a): any complex input
reduces to a real bidiagonal (real d, e: real-β reflectors, the right ones
from the conjugated rows), whose QR iteration (or divide & conquer) is the
same one batched launch as for the real dtypes; the back-transforms are
complex. Held against the JAX package's native-complex ``svd``, its pair
``svd_pair`` (``factor_cpair``) and complex128 numpy.

Inputs: complex Gaussians from a numpy seed, complex64 and complex128 at
n ∈ {1, 2, 7, 33, 130}, and up to 33 the wide (n × 2n) and tall (3n × n,
QR-preprocessed) shapes and the pseudoinverse. Singular values within 8·n·eps of the largest;
vectors within 8·n·eps (times σ's spread over its gap, the first-order
bound) after one unit phase per singular pair (u_j, v_j);
A = U diag(s) Vᴴ, UᴴU = I and VᴴV = I within 8·n·eps.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import faer_tpu.linalg.factor_cpair as jfc
import faer_tpu.linalg.svd as jsvd
from faer_tpu_torch.linalg import svd as tsvd

from complex_cases import DTYPES, SIZES, close, from_pair, inputs, pair, vectors_close

torch.set_num_threads(1)


@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize("n", SIZES)
def test_svd_against_jax_routes_and_numpy(name, n):
    """Square, and the wide (n × 2n) and tall (3n × n, QR-preprocessed)
    shapes against numpy."""
    tdt, npdt = DTYPES[name]
    _, _, _, g = inputs(n, npdt)
    u, s, v, info = tsvd.svd(torch.from_numpy(g))
    assert s.dtype == tdt.to_real() and u.dtype == v.dtype == tdt and bool(info.converged)
    uj, sj, vj, _ = jsvd.svd(jnp.asarray(g))
    sp, (ur, ui), (vr, vi), _ = jfc.svd_pair(*pair(g))
    so = np.linalg.svd(g.astype(np.complex128), compute_uv=False)
    for ref in (np.asarray(sj), np.asarray(sp), so):
        close(s.numpy(), ref, n, npdt)
    un, vn = u.numpy().astype(np.complex128), v.numpy().astype(np.complex128)
    for ru, rv in ((np.asarray(uj), np.asarray(vj)), (from_pair(ur, ui), from_pair(vr, vi))):
        # one phase per singular pair: align v, carry its phase to u
        dots = np.sum(vn.conj() * rv, axis=0)
        ph = np.where(np.abs(dots) == 0, 1.0, dots / np.where(np.abs(dots) == 0, 1.0,
                                                                np.abs(dots)))
        vectors_close(vn, rv, so, n, npdt, phases=ph)
        vectors_close(un, ru, so, n, npdt, phases=ph)
    close(un @ np.diag(s.numpy()) @ vn.conj().T, g, n, npdt)
    close(un.conj().T @ un, np.eye(n), n, npdt)
    close(vn.conj().T @ vn, np.eye(n), n, npdt)
    if n > 33:  # the plain QR sweeps are host loops: one 130 SVD a dtype on the CPU
        return
    for m_, n_ in ((n, 2 * n), (3 * n, n)):
        _, _, _, a = inputs(n_, npdt, seed=1, m=m_)
        u, s, v, _ = tsvd.svd(torch.from_numpy(a))
        k = min(m_, n_)
        assert u.shape == (m_, k) and v.shape == (n_, k)
        close(s.numpy(), np.linalg.svd(a.astype(np.complex128), compute_uv=False), k, npdt)
        un, vn = u.numpy().astype(np.complex128), v.numpy().astype(np.complex128)
        close(un @ np.diag(s.numpy()) @ vn.conj().T, a, max(m_, n_), npdt)
    pinv = tsvd.pseudoinverse(torch.from_numpy(g)).numpy().astype(np.complex128)
    if np.linalg.cond(g.astype(np.complex128)) < 1e3:
        close(pinv @ g, np.eye(n), n * np.linalg.cond(g.astype(np.complex128)), npdt)
