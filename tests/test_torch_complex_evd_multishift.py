"""The port's complex multishift QR with aggressive early deflation
(``schur_multishift.multishift_complex_schur``) against the JAX package's
pair form (``faer_tpu/linalg/schur_multishift_cpair.py:392``), and ``evd``
/ ``eigenvalues`` on the multishift route (n ≥ 128), split from
``tests/test_torch_complex_evd.py`` to keep each file's time short.

Inputs are made with numpy from a seed; the JAX multishift runs on the CPU
with x64 on (``tests/conftest.py``), once, at n = 160 with ns = 16 and an
AED window of 24. Tolerances: faer's 8·n·eps of the dtype for the Schur
step's ‖A − QTQᴴ‖/‖A‖ and max|QᴴQ − I| and for ‖AV − VΛ‖/(‖A‖‖V‖);
eigenvalues within 2·κ_i·η of f64 scipy, and the two packages' within
2·κ_i·(η + η_jax) of each other (``complex_cases.eig_ratio``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from complex_cases import DTYPES, eig_ratio, eps, hess_input, schur_backward
from faer_tpu.linalg.schur_multishift_cpair import multishift_complex_schur_pair
from faer_tpu_torch.linalg import complex_schur as tcs
from faer_tpu_torch.linalg import evd as tevd
from faer_tpu_torch.linalg import schur_multishift as tms

torch.set_num_threads(1)


def _counting(monkeypatch):
    """Count the AED rounds and the window Schur calls (one each a round)."""
    calls = {"aed": 0, "schur": 0}
    aed, schur = tms._aed, tcs.complex_schur

    def counted_aed(*a, **k):
        calls["aed"] += 1
        return aed(*a, **k)

    def counted_schur(*a, **k):
        calls["schur"] += 1
        return schur(*a, **k)

    monkeypatch.setattr(tms, "_aed", counted_aed)
    monkeypatch.setattr(tcs, "complex_schur", counted_schur)
    return calls


def test_multishift_complex_schur_against_the_pair_form(monkeypatch):
    """``multishift_complex_schur`` at 160 (ns = 16, w = 24) in complex128
    and the JAX package's ``multishift_complex_schur_pair`` on the same H:
    both converged and upper triangular, both Schur steps within 8·n·eps,
    each set of eigenvalues within 2·κ_i·η of scipy and of each other; one
    window Schur call an AED round (complex64 takes this route in
    ``test_complex_evd_multishift_route``)."""
    n = 160
    h = hess_input(n, np.complex128, seed=160)
    calls = _counting(monkeypatch)
    t, q, info = tms.multishift_complex_schur(torch.from_numpy(h),
                                              torch.eye(n, dtype=torch.complex128),
                                              ns=16, w=24)
    assert bool(info.converged) and calls["aed"] == calls["schur"] > 0
    assert np.all(np.tril(t.numpy(), -1) == 0)
    tol = 8 * n * eps(np.complex128)
    rec, orth, eta = schur_backward(h, t.numpy(), q.numpy())
    assert rec <= tol and orth <= tol
    assert eig_ratio(np.diag(t.numpy()), h, eta) <= 1
    (tr, ti), (qr, qi), infoj = multishift_complex_schur_pair(
        (jnp.asarray(h.real), jnp.asarray(h.imag)),
        (jnp.eye(n), jnp.zeros((n, n))), ns=16, w=24)
    assert bool(infoj.converged)
    tj = np.asarray(tr) + 1j * np.asarray(ti)
    rj, oj, etaj = schur_backward(h, tj, np.asarray(qr) + 1j * np.asarray(qi))
    assert rj <= tol and oj <= tol
    assert eig_ratio(np.diag(t.numpy()), h, eta + etaj, other=np.diag(tj)) <= 1


@pytest.mark.parametrize("name,n", [("c128", 128), ("c64", 130)])
def test_complex_evd_multishift_route(name, n, monkeypatch):
    """``evd`` on the multishift route (ns = 32, w = 48 by ``_params_for``):
    converged, one window Schur call an AED round and no direct call, the
    residual ‖AV − VΛ‖/(‖A‖‖V‖) within 8·n·eps, the eigenvalues within
    2·κ_i·η of f64 scipy; ``eigenvalues`` equals ``evd``'s w to the bit (at
    130: each call is seconds of the CPU twin)."""
    tdt, npdt = DTYPES[name]
    rng = np.random.default_rng(n)
    a = (rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))).astype(npdt)
    calls = _counting(monkeypatch)
    schur = []
    dispatch = tevd._complex_schur_dispatch
    monkeypatch.setattr(tevd, "_complex_schur_dispatch",
                        lambda *x, **k: schur.append(dispatch(*x, **k)) or schur[-1])
    w, v, info = tevd.evd(torch.from_numpy(a))
    assert w.dtype == tdt and v.dtype == tdt and bool(info.converged)
    assert calls["aed"] == calls["schur"] > 0
    tol = 8 * n * eps(npdt)
    an, vn, wn = (np.asarray(x, np.complex128) for x in (a, v.numpy(), w.numpy()))
    res = np.linalg.norm(an @ vn - vn * wn[None, :]) / (np.linalg.norm(an) * np.linalg.norm(vn))
    assert res <= tol
    t, qs, _ = schur[0]
    rec, orth, eta = schur_backward(a, t.numpy(), qs.numpy())
    assert rec <= tol and orth <= tol and np.all(np.tril(t.numpy(), -1) == 0)
    assert eig_ratio(wn, a, eta) <= 1
    if n == 130:
        assert torch.equal(tevd.eigenvalues(torch.from_numpy(a)), w)
