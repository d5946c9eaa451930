"""Complex LU and QR in the port (ROADMAP item 10a): the partial-pivot LU
and the Householder QR with every solve and apply, native complex on the
non-kernel bodies (complex reflectors: real β, complex τ), against the JAX
package's native-complex functions, its (re, im) pair functions
(``lu_in_place_pair``, ``qr_in_place_pair`` and their solves) and a
complex128 numpy oracle.

Inputs: complex Gaussians from a numpy seed, complex64 and complex128 at
n ∈ {1, 2, 7, 33, 130}, and a tall (2n × n) least squares. LU is compared
by A[perm] = L U and the parity of ``nt`` (and the packed factor where the
pivots agree, the Gaussian's case); QR by R, τ and Q entrywise within
8·n·eps (the same larfg signs) and the solves by their backward errors
(the tall least squares against numpy's, κ-scaled).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import faer_tpu.linalg.factor_cpair as jfc
import faer_tpu.linalg.lu as jlu
import faer_tpu.linalg.qr as jqr
from faer_tpu_torch.linalg import lu as tlu
from faer_tpu_torch.linalg import qr as tqr

from complex_cases import (DTYPES, SIZES, backward, close, from_pair, inputs,
                           lstsq_backward, pair)

torch.set_num_threads(1)


def _parity(perm) -> int:
    p = np.asarray(perm)
    return int(np.sum(np.triu(p[:, None] > p[None, :], 1)))  # inversions


@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize("n", SIZES)
def test_lu_against_jax_routes_and_numpy(name, n):
    tdt, npdt = DTYPES[name]
    _, _, b, g = inputs(n, npdt)
    f, perm, info = tlu.lu_in_place(torch.from_numpy(g))
    assert f.dtype == tdt and bool(info.success)
    assert int(info.transposition_count) % 2 == _parity(perm.numpy()) % 2
    close(tlu.lu_reconstruct(f, perm).numpy(), g, n, npdt)
    fj, pj, _ = jlu.lu_in_place(jnp.asarray(g))
    (fr, fi), pp, _ = jfc.lu_in_place_pair(*pair(g))
    for ref, rp in ((np.asarray(fj), pj), (from_pair(fr, fi), pp)):
        if np.array_equal(perm.numpy(), np.asarray(rp)):
            close(f.numpy(), ref, n, npdt)
    tb = torch.from_numpy(b)
    x = tlu.lu_solve(f, perm, tb)
    backward(g, x.numpy(), b, n, npdt)
    xr, xi = jfc.lu_solve_pair((fr, fi), pp, *pair(b))
    backward(g, from_pair(xr, xi), b, n, npdt)
    backward(g.T, tlu.lu_solve_transpose(f, perm, tb).numpy(), b, n, npdt)
    backward(g, tlu.lu_inverse(f, perm).numpy(), np.eye(n), n, npdt)
    det = tlu.lu_determinant(f, perm, info.transposition_count)
    want = np.linalg.det(g.astype(np.complex128))
    if n <= 33:  # |det| of a 130² complex Gaussian overflows complex64
        assert det.dtype == tdt and abs(det.item() - want) <= 8 * n * np.finfo(npdt).eps * \
            np.prod(np.abs(np.diag(f.numpy().astype(np.complex128))))


@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize("n", SIZES)
def test_qr_against_jax_routes_and_numpy(name, n):
    """R, τ (complex) and the packed reflectors within 8·n·eps of both JAX
    routes; Q unitary and A = Q R; Q, Qᴴ applied; the square solve, the
    inverse, the tall least squares."""
    tdt, npdt = DTYPES[name]
    _, _, b, g = inputs(n, npdt)
    packed, ts, block = tqr.qr_in_place(torch.from_numpy(g))
    assert packed.dtype == tdt and ts.dtype == tdt
    assert np.all(np.asarray(packed.imag.diagonal()) == 0)  # β real
    pj, tsj, bj = jqr.qr_in_place(jnp.asarray(g))
    (prr, pri), (tsr, tsi), bp = jfc.qr_in_place_pair(*pair(g))
    for ref in (np.asarray(pj), from_pair(prr, pri)):
        close(packed.numpy(), ref, n, npdt)
    q = tqr.qr_compute_q(packed, ts, block)
    close(q.numpy(), np.asarray(jqr.qr_compute_q(pj, tsj, bj)), n, npdt)
    close((q.mH @ q).numpy(), np.eye(n), n, npdt)
    close(tqr.qr_reconstruct(packed, ts, block).numpy(), g, n, npdt)
    tb = torch.from_numpy(b)
    for adjoint in (False, True):
        got = tqr.qr_apply_q(packed, ts, block, tb, adjoint=adjoint)
        close(got.numpy(), np.asarray(jqr.qr_apply_q(pj, tsj, bj, jnp.asarray(b),
                                                     adjoint=adjoint)), n, npdt)
        yr, yi = jfc.qr_apply_q_pair((prr, pri), (tsr, tsi), bp, pair(b), adjoint=adjoint)
        close(got.numpy(), from_pair(yr, yi), n, npdt)
    backward(g, tqr.qr_solve(packed, ts, block, tb).numpy(), b, n, npdt)
    backward(g, tqr.qr_inverse(packed, ts, block).numpy(), np.eye(n), n, npdt)
    _, _, bt, gt = inputs(n, npdt, seed=1, m=2 * n)
    pt, tst, blt = tqr.qr_in_place(torch.from_numpy(gt))
    x = tqr.qr_solve_lstsq(pt, tst, blt, torch.from_numpy(bt)).numpy()
    lstsq_backward(gt, x, bt, 2 * n, npdt)
    xo = np.linalg.lstsq(gt.astype(np.complex128), bt, rcond=None)[0]
    kappa = np.linalg.cond(gt.astype(np.complex128))
    assert np.linalg.norm(x - xo) <= 8 * n * np.finfo(npdt).eps * kappa * np.linalg.norm(xo)
