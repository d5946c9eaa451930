"""The port's general real EVD, its first stages (Hessenberg, real Schur,
quasi-triangular eigenvectors), against ``faer_tpu`` and f64 numpy.
Multishift QR with AED is in ``tests/test_torch_evd_multishift.py`` and
the entry points (``evd``/``eigenvalues``/``Mat.eigen``) in
``tests/test_torch_evd_entry.py``, split from this file to keep each file's
time short.

Inputs are made with numpy from a seed and handed to both packages. The
JAX side runs on the CPU with x64 on (``tests/conftest.py``), jitted, each
reference built once a module (``_jax``). The port side runs on the CPU:
the ``real_schur`` kernel's plain version, which the card's kernel equals
to the bit. A Schur form can order its blocks differently under different
rounding, so the forms are compared through sorted eigenvalues,
‖A − QTQᵀ‖/‖A‖, max|QᵀQ − I|, the quasi-triangular shape, standardized
2×2 blocks, ‖AV − V diag(w)‖ and adjacent conjugate pairs; T's entries
only where the spectrum is well separated and both orders agree.
Tolerances: the JAX package's own tests' (``tests/test_real_schur.py``:
5e-5 for float32 Schur forms and eigenvalues, 1e-4 on the rotation and
defective spectra), or faer's 8·n·eps where the port is held to the JAX
package's Hessenberg form and 2×2 rotations.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import faer_tpu.linalg.evd as jevd
from faer_tpu.linalg import eigvec as jeig
from faer_tpu.linalg import real_schur as jrs
import faer_tpu_torch as ft
from faer_tpu_torch.core.errors import ShapeError
from faer_tpu_torch.linalg import eigvec as teig
from faer_tpu_torch.linalg import real_schur as trs
from faer_tpu_torch.ops.kernels import real_schur as krs

torch.set_num_threads(1)

DT = {"f32": (torch.float32, jnp.float32, np.float32),
      "f64": (torch.float64, jnp.float64, np.float64)}


def _eps(name):
    return float(np.finfo(DT[name][2]).eps)


@functools.lru_cache(maxsize=None)
def _jax(fn_name):
    """The JAX package's function, jitted once a module."""
    fns = {"hess": jevd.hessenberg_blocked, "schur": jrs.real_schur,
           "vecs": jeig.quasi_triangular_eigenvectors_pair,
           "pair": jrs.schur_eigenvalues_pair}
    return jax.jit(fns[fn_name])


def _hess_input(n, seed):
    return np.triu(np.random.default_rng(seed).standard_normal((n, n)), -1)


def _check_schur(a, t, q, tol):
    """Converged-form checks: ‖A − QTQᵀ‖ ≤ tol·max(1, ‖A‖), ‖QᵀQ − I‖ ≤
    tol·n, nothing below the subdiagonal, 1×1 and 2×2 blocks only, each 2×2
    block standardized (equal diagonal, b·c < 0)."""
    an, tn, qn = (np.asarray(x, np.float64) for x in (a, t, q))
    n = an.shape[0]
    assert np.linalg.norm(qn @ tn @ qn.T - an) <= tol * max(1.0, np.linalg.norm(an))
    assert np.linalg.norm(qn.T @ qn - np.eye(n)) <= tol * n
    assert np.all(np.tril(tn, -2) == 0)
    sd = np.diag(tn, -1) != 0
    assert not np.any(sd[:-1] & sd[1:])
    for i in np.flatnonzero(sd):
        assert tn[i, i] == tn[i + 1, i + 1] and tn[i, i + 1] * tn[i + 1, i] < 0


def _sorted_close(w, wref, tol):
    w, wref = np.sort_complex(np.asarray(w)), np.sort_complex(np.asarray(wref))
    assert np.max(np.abs(w - wref)) <= tol * max(1.0, np.max(np.abs(wref)))


def _pair_eigs(t):
    wr, wi = trs.schur_eigenvalues_pair(t)
    return wr.double().numpy() + 1j * wi.double().numpy()


def _conjugates_adjacent(w):
    w = np.asarray(w)
    i = 0
    while i < len(w):
        if w.imag[i] != 0:
            assert w.imag[i] > 0 and w[i + 1] == np.conj(w[i])
            i += 2
        else:
            i += 1


# ---------------------------------------------------------------------------
# Hessenberg
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,name", [(5, "f64"), (64, "f64"), (64, "f32"), (300, "f64")])
def test_hessenberg_against_jax(n, name):
    """``hessenberg_blocked`` (the unblocked reduction up to 192, panels of
    96 past it): H within 8·n·eps·max|A| and Q within 8·n·eps of the JAX
    package's, the same signs; A = Q H Qᵀ and H Hessenberg."""
    tdt, jdt, _ = DT[name]
    a = np.random.default_rng(n).standard_normal((n, n))
    h, q = ft.hessenberg_blocked(torch.tensor(a, dtype=tdt))
    hj, qj = _jax("hess")(jnp.asarray(a, jdt))
    tol = 8 * n * _eps(name)
    assert np.abs(h.numpy() - np.asarray(hj)).max() <= tol * np.abs(a).max()
    assert np.abs(q.numpy() - np.asarray(qj)).max() <= tol
    hn, qn = h.double().numpy(), q.double().numpy()
    assert np.all(np.tril(hn, -2) == 0)
    assert np.linalg.norm(qn @ hn @ qn.T - a) <= tol * np.linalg.norm(a)
    h2, q2 = ft.hessenberg_in_place(torch.tensor(a, dtype=tdt))
    assert np.abs(h2.numpy() - hn).max() <= tol * np.abs(a).max()


# ---------------------------------------------------------------------------
# real_schur: the plain twin of the kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,name,with_jax", [
    (1, "f32", False), (2, "f32", False), (3, "f32", True), (5, "f32", False),
    (16, "f32", True), (48, "f32", True), (16, "f64", False), (48, "f64", False)])
def test_real_schur_random(n, name, with_jax):
    """Random Hessenberg inputs: the converged form's checks, eigenvalues
    against f64 numpy and (at 3, 16 and 48 in float32; each jit of the JAX
    package's iteration costs some 2 s) the JAX package's, conjugate pairs
    adjacent."""
    tdt, jdt, _ = DT[name]
    tol = 5e-5 if name == "f32" else 1e-12
    h = _hess_input(n, n)
    t, q, info = trs.real_schur(torch.tensor(h, dtype=tdt), torch.eye(n, dtype=tdt))
    assert bool(info.converged) and t.dtype == tdt
    _check_schur(h, t, q, tol)
    w = _pair_eigs(t)
    _sorted_close(w, np.linalg.eigvals(h), tol)
    if with_jax:
        tj, _, infoj = _jax("schur")(jnp.asarray(h, jdt), jnp.eye(n, dtype=jdt))
        wrj, wij = jrs.schur_eigenvalues_pair(tj)
        assert bool(infoj.converged)
        _sorted_close(w, np.asarray(wrj, np.float64) + 1j * np.asarray(wij, np.float64), tol)
    _conjugates_adjacent(w)


@pytest.mark.parametrize("n", [5, 16])
def test_real_schur_entries_on_a_separated_spectrum(n):
    """Eigenvalues 1..n (distinct, 1 apart) on a non-normal matrix: the port
    and the JAX package deflate in the same order, and T agrees entry by
    entry up to the signs of Q's columns, within 8·n·eps·max|T|."""
    rng = np.random.default_rng(n)
    t0 = np.triu(rng.standard_normal((n, n)), 1) * 0.3 + np.diag(np.arange(1.0, n + 1))
    u, _ = np.linalg.qr(rng.standard_normal((n, n)))
    a = u @ t0 @ u.T
    h, q = ft.hessenberg_in_place(torch.tensor(a))
    t, _, _ = trs.real_schur(h, q)
    hj, qj = jevd.hessenberg_in_place(jnp.asarray(a))
    tj, _, _ = _jax("schur")(hj, qj)
    tn, tjn = t.numpy(), np.asarray(tj)
    assert np.array_equal(np.round(np.diag(tn)), np.round(np.diag(tjn)))
    assert np.abs(np.abs(tn) - np.abs(tjn)).max() <= 8 * n * _eps("f64") * np.abs(tjn).max()


@pytest.mark.parametrize("name", ["f32", "f64"])
def test_real_schur_rotation_block_spectrum(name):
    """Block-diagonal rotations, orthogonally mixed: every eigenvalue a
    complex pair on the unit circle (``tests/test_real_schur.py:53``)."""
    tdt = DT[name][0]
    thetas = [0.3, 1.1, 2.5, 0.9]
    a0 = np.zeros((8, 8))
    for i, th in enumerate(thetas):
        a0[2 * i:2 * i + 2, 2 * i:2 * i + 2] = [[np.cos(th), -np.sin(th)],
                                                [np.sin(th), np.cos(th)]]
    qh, _ = np.linalg.qr(np.random.default_rng(0).standard_normal((8, 8)))
    a = qh @ a0 @ qh.T
    h, q = ft.hessenberg_in_place(torch.tensor(a, dtype=tdt))
    t, qs, info = trs.real_schur(h, q)
    assert bool(info.converged)
    _check_schur(a, t, qs, 1e-4)
    w = _pair_eigs(t)
    _sorted_close(w, np.concatenate([np.exp(1j * np.array(thetas)),
                                     np.exp(-1j * np.array(thetas))]), 1e-4)
    assert np.all(w.imag != 0)
    _conjugates_adjacent(w)


def test_real_schur_repeated_eigenvalues():
    """I + nilpotent (one defective eigenvalue, ``tests/test_real_schur.py:
    76``): the trace is exact; and a 20 × 20 with eigenvalues 1 and 2 ten
    times each, diagonalizable, within 1e-4."""
    n = 12
    a = np.eye(n) + np.diag(np.ones(n - 1), 1)
    h, q = ft.hessenberg_in_place(torch.tensor(a, dtype=torch.float32))
    t, qs, info = trs.real_schur(h, q)
    assert bool(info.converged)
    _check_schur(a, t, qs, 1e-4)
    w = _pair_eigs(t)
    assert abs(w.real.sum() / n - 1.0) < 1e-4 and np.all(np.abs(w.imag) < 0.5)
    rng = np.random.default_rng(20)
    u, _ = np.linalg.qr(rng.standard_normal((20, 20)))
    a = u @ np.diag(np.repeat([1.0, 2.0], 10)) @ u.T
    h, q = ft.hessenberg_in_place(torch.tensor(a, dtype=torch.float32))
    t, qs, info = trs.real_schur(h, q)
    assert bool(info.converged)
    _check_schur(a, t, qs, 1e-4)
    _sorted_close(_pair_eigs(t), np.repeat([1.0, 2.0], 10), 1e-4)


@pytest.mark.parametrize("scale", [1e-14, 1e-19, 1e-20])
def test_real_schur_small_scale(scale):
    """A float32 Hessenberg matrix scaled down until the products of its
    entries (the sweep start's test, the shifts) fall near or into the
    subnormal range, which PyTorch keeps and XLA flushes: the form converges
    and holds (‖A − QTQᵀ‖ and QᵀQ − I within 5e-5); the eigenvalues are
    the scaled ones within 5e-5 of the largest while the 2×2 blocks'
    discriminants stay normal (1e-14, 1e-19)."""
    n = 16
    h = _hess_input(n, 7)
    t, q, info = trs.real_schur(torch.tensor(h * scale, dtype=torch.float32),
                                torch.eye(n))
    assert bool(info.converged)
    _check_schur(h * scale, t, q, 5e-5)
    if scale > 1e-20:
        _sorted_close(_pair_eigs(t) / scale, np.linalg.eigvals(h), 5e-5)


def test_real_schur_subnormal_couplings():
    """Subdiagonal couplings of 1e-22 among O(1) entries in float32 (their
    squares subnormal): each splits the problem, and the form still holds."""
    n = 24
    h = _hess_input(n, 9)
    h[[6, 13, 20], [5, 12, 19]] = 1e-22
    t, q, info = trs.real_schur(torch.tensor(h, dtype=torch.float32), torch.eye(n))
    assert bool(info.converged)
    _check_schur(h, t, q, 5e-5)
    _sorted_close(_pair_eigs(t), np.linalg.eigvals(h), 5e-5)


def test_house3_and_standardize_against_jax():
    """The reflector and the 2×2 rotation on normal numbers equal the JAX
    package's formulas within 4·eps; on entries whose squares underflow
    they still give an orthogonal reflector and a unit rotation."""
    rng = np.random.default_rng(4)
    f = np.float64
    for v in rng.standard_normal((20, 3)):
        tau, u2, u3, _ = trs._house3(*(f(x) for x in v))
        tj, u2j, u3j = (float(x) for x in jrs._house3(*(jnp.asarray(x) for x in v)))
        assert abs(tau - tj) <= 4 * _eps("f64") * 2 and abs(u2 - u2j) <= 1e-14 * (1 + abs(u2j))
        assert abs(u3 - u3j) <= 1e-14 * (1 + abs(u3j))
    for blk in rng.standard_normal((20, 4)):
        cs, sn, real = trs._standardize_2x2(*(f(x) for x in blk))
        csj, snj, realj = (np.asarray(x) for x in jrs._standardize_2x2(
            *(jnp.asarray(x) for x in blk)))
        assert real == bool(realj)
        assert abs(cs - csj) <= 1e-14 and abs(sn - snj) <= 1e-14
    v = np.array([3e-22, 4e-22, 0.0], np.float32)
    tau, u2, u3, beta = trs._house3(*(np.float32(x) for x in v))
    u = np.array([1.0, u2, u3])
    ref = v.astype(np.float64) - tau * u * (u @ v.astype(np.float64))
    assert abs(abs(beta) - 5e-22) <= 1e-27 and np.abs(ref[1:]).max() <= 1e-28
    cs, sn, _ = trs._standardize_2x2(*(np.float32(x) for x in (1e-25, 2e-25, 0.0, 3e-25)))
    assert abs(float(cs) ** 2 + float(sn) ** 2 - 1.0) <= 1e-6


def test_schur_eigenvalues_pair_against_jax():
    h = _hess_input(20, 3)
    t, _, _ = trs.real_schur(torch.tensor(h), torch.eye(20, dtype=torch.float64))
    wr, wi = trs.schur_eigenvalues_pair(t)
    wrj, wij = _jax("pair")(jnp.asarray(t.numpy()))
    assert np.abs(wr.numpy() - np.asarray(wrj)).max() <= 1e-14 * np.abs(wrj).max()
    assert np.abs(wi.numpy() - np.asarray(wij)).max() <= 1e-14 * np.abs(wrj).max()


def test_real_schur_batched_plain_ragged():
    """The kernel's wrapper on the CPU: a ragged batch, each problem as it
    is alone, entries past it untouched, sizes outside [1, nmax] left as
    they are with 0 iterations, not converged."""
    sizes = [12, 1, 7, 0, 13]
    nmax = 12
    h = torch.tensor(np.stack([_hess_input(nmax, s) for s in range(len(sizes))]),
                     dtype=torch.float32)
    q = torch.eye(nmax).repeat(len(sizes), 1, 1)
    t, qo, its, conv, steps = krs.real_schur_batched(h, q, torch.tensor(sizes, dtype=torch.int32))
    assert conv.tolist() == [True, True, True, False, False]
    assert its[1] == 0 and its[3] == 0 and its[4] == 0
    for b, n in enumerate(sizes):
        if not 1 <= n <= nmax:
            assert torch.equal(t[b], h[b]) and torch.equal(qo[b], q[b])
            continue
        tb, qb, itb, _, stb = trs.real_schur_plain(h[b, :n, :n], q[b, :n, :n])
        assert torch.equal(t[b, :n, :n], tb) and torch.equal(qo[b, :n, :n], qb)
        assert its[b] == itb and steps[b] == stb and (stb > 0) == (n > 2)
        assert torch.equal(t[b, n:], h[b, n:]) and torch.equal(t[b, :n, n:], h[b, :n, n:])


@pytest.mark.parametrize("call", [
    lambda h, q, s: krs.real_schur_batched(h.double(), q, s),
    lambda h, q, s: krs.real_schur_batched(h[0], q[0], s),
    lambda h, q, s: krs.real_schur_batched(h, q[:, :, :3], s),
    lambda h, q, s: krs.real_schur_batched(h, q, s.long()),
    lambda h, q, s: krs.real_schur_batched(h, q, s, max_sweeps_factor=-1),
    lambda h, q, s: krs.real_schur_batched(h.transpose(1, 2), q, s),
])
def test_real_schur_batched_rejects_bad_inputs(call):
    h = torch.zeros(2, 4, 4)
    with pytest.raises((TypeError, ValueError, ShapeError)):
        call(h, torch.zeros(2, 4, 4), torch.tensor([4, 4], dtype=torch.int32))


# ---------------------------------------------------------------------------
# eigenvectors
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [2, 5, 16])
def test_quasi_triangular_eigenvectors_against_jax(n):
    h = _hess_input(n, 100 + n)
    t, _, _ = trs.real_schur(torch.tensor(h), torch.eye(n, dtype=torch.float64))
    wr, wi = trs.schur_eigenvalues_pair(t)
    xr, xi = teig.quasi_triangular_eigenvectors_pair(t, wr, wi)
    xrj, xij = _jax("vecs")(*(jnp.asarray(x.numpy()) for x in (t, wr, wi)))
    assert np.abs(xr.numpy() - np.asarray(xrj)).max() <= 1e-10
    assert np.abs(xi.numpy() - np.asarray(xij)).max() <= 1e-10
    x = xr.numpy() + 1j * xi.numpy()
    w = wr.numpy() + 1j * wi.numpy()
    assert np.linalg.norm(t.numpy() @ x - x * w) <= 1e-12 * np.linalg.norm(t.numpy())
    assert np.allclose(np.linalg.norm(x, axis=0), 1.0)
