"""The rest of the complex dense stack in the port (ROADMAP item 10a):
the pivoted LLT, Bunch–Kaufman LBLT, the LLT and LDLT rank updates,
full-pivot LU and column-pivoted QR, native complex bodies, against the
JAX package's native-complex functions (its pair path has
``col_piv_qr_in_place_pair`` too) and a complex128 numpy oracle.

Inputs come from a numpy seed (``g gᴴ/n + I``, ``(g + gᴴ)/2``, a complex
Gaussian), complex64 and complex128 at n ∈ {1, 2, 7, 33, 130}.
Tolerance: faer's 8·n·eps of the dtype (``utils/approx.py``) entrywise
against the JAX package, norm-wise (the backward error) for solves;
pivots equal to the JAX package's where they are well separated.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import faer_tpu.linalg.cholesky as jchol
import faer_tpu.linalg.factor_cpair as jfc
import faer_tpu.linalg.lu as jlu
import faer_tpu.linalg.qr as jqr
from faer_tpu_torch.linalg import cholesky as tchol
from faer_tpu_torch.linalg import lu as tlu
from faer_tpu_torch.linalg import qr as tqr

from complex_cases import DTYPES, SIZES
from complex_cases import backward as _backward
from complex_cases import close as _close
from complex_cases import inputs as _inputs
from complex_cases import pair as _pair

torch.set_num_threads(1)


@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize("n", SIZES)
def test_pivoted_llt_and_lblt_against_jax(name, n):
    """The pivoted LLT (perm equal to the JAX package's, L within 8·n·eps)
    and Bunch–Kaufman LBLT (A[perm][:, perm] = L B Lᴴ, the solve's
    backward error, perm and the 2×2 marks equal to the JAX package's)."""
    tdt, npdt = DTYPES[name]
    a, h, b, _ = _inputs(n, npdt)
    l, perm, rank, info = tchol.piv_llt_factor(torch.from_numpy(a))
    lj, pj, rj, _ = jchol.piv_llt_factor(jnp.asarray(a))
    assert int(rank) == int(rj) == n and bool(info.success)
    assert np.array_equal(perm.numpy(), np.asarray(pj))
    _close(l.numpy(), np.asarray(lj), n, npdt)
    _close(tchol.piv_llt_reconstruct(l, perm).numpy(), a, n, npdt)
    _backward(a, tchol.piv_llt_solve(l, perm, torch.from_numpy(b)).numpy(), b, n, npdt)
    lb, sd, perm, info = tchol.lblt_factor(torch.from_numpy(h))
    lbj, sdj, pj, _ = jchol.lblt_factor(jnp.asarray(h))
    assert lb.dtype == tdt and np.array_equal(perm.numpy(), np.asarray(pj))
    assert np.array_equal(sd.numpy() != 0, np.asarray(sdj) != 0)
    _close(tchol.lblt_reconstruct(lb, sd, perm).numpy(), h, n, npdt)
    _close(lb.numpy(), np.asarray(lbj), n, npdt)
    _backward(h, tchol.lblt_solve(lb, sd, perm, torch.from_numpy(b)).numpy(), b, n, npdt)


@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize("n", SIZES)
def test_rank_updates_against_jax(name, n):
    """L Lᴴ + W Wᴴ, L Lᴴ − ε W Wᴴ (a downdate that stays definite) and
    L D Lᴴ ± W Wᴴ: the factors within 8·n·eps of the JAX package's, the
    reconstruction of the oracle's."""
    tdt, npdt = DTYPES[name]
    a, _, b, _ = _inputs(n, npdt)
    w = b[:, :2]
    l, _ = tchol.llt_factor(torch.from_numpy(a))
    lj = jnp.asarray(l.numpy())
    down = np.float32(0.25 / max(np.linalg.norm(w, 2) ** 2, 1.0))
    for alpha, want in ((1.0, a + w @ w.conj().T), (-float(down), a - down * w @ w.conj().T)):
        got = tchol.llt_rank_r_update(l, torch.from_numpy(w), alpha)
        _close(got.numpy(), np.asarray(jchol.llt_rank_r_update(lj, jnp.asarray(w), alpha)),
               n, npdt)
        _close(tchol.llt_reconstruct(got).numpy(), want, n, npdt)
    ld, _ = tchol.ldlt_factor(torch.from_numpy(a))
    got = tchol.ldlt_rank_r_update(ld, torch.from_numpy(w), 1.0)
    ref = jchol.ldlt_rank_r_update(jnp.asarray(ld.numpy()), jnp.asarray(w), 1.0)
    _close(got.numpy(), np.asarray(ref), n, npdt)
    _close(tchol.ldlt_reconstruct(got).numpy(), a + w @ w.conj().T, n, npdt)


@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize("n", SIZES)
def test_full_piv_lu_and_col_piv_qr_against_jax(name, n):
    """Full-pivot LU (A[rows][:, cols] = L U, both permutations equal to
    the JAX package's, the transposition count's parity theirs, the
    determinant complex) and column-pivoted QR (A[:, perm] = Q R, perm and
    R within 8·n·eps of the JAX native and pair routes)."""
    tdt, npdt = DTYPES[name]
    _, _, b, g = _inputs(n, npdt)
    f, rp, cp, info = tlu.full_piv_lu_in_place(torch.from_numpy(g))
    fj, rpj, cpj, infoj = jlu.full_piv_lu_in_place(jnp.asarray(g))
    assert np.array_equal(rp.numpy(), np.asarray(rpj)) and np.array_equal(cp.numpy(), np.asarray(cpj))
    assert int(info.transposition_count) % 2 == int(infoj.transposition_count) % 2
    _close(f.numpy(), np.asarray(fj), n, npdt)
    _close(tlu.full_piv_lu_reconstruct(f, rp, cp).numpy(), g, n, npdt)
    _backward(g, tlu.full_piv_lu_solve(f, rp, cp, torch.from_numpy(b)).numpy(), b, n, npdt)
    det = tlu.lu_determinant(f, rp, info.transposition_count)
    assert det.dtype == tdt
    pk, taus, perm = tqr.col_piv_qr_in_place(torch.from_numpy(g))
    pkj, tausj, permj = jqr.col_piv_qr_in_place(jnp.asarray(g))
    assert np.array_equal(perm.numpy(), np.asarray(permj))
    _close(np.triu(pk.numpy()), np.triu(np.asarray(pkj)), n, npdt)
    _close(taus.numpy(), np.asarray(tausj), n, npdt)
    (pr, pi), _, permp = jfc.col_piv_qr_in_place_pair(*_pair(g))
    assert np.array_equal(perm.numpy(), np.asarray(permp))
    _close(np.triu(pk.numpy()), np.triu(np.asarray(pr) + 1j * np.asarray(pi)), n, npdt)
    _close(tqr.col_piv_qr_reconstruct(pk, taus, perm).numpy(), g, n, npdt)
    _backward(g, tqr.col_piv_qr_solve_lstsq(pk, taus, perm, torch.from_numpy(b)).numpy(),
              b, n, npdt)
