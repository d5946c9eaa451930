"""The port's multishift complex QZ with AED (``linalg/qz_multishift.py``)
against the JAX package's ``multishift_qz_pair``
(``faer_tpu/linalg/qz_multishift_cpair.py:555``, compiled once here) and
f64 scipy, and its pieces: the AED window's return to
Hessenberg–triangular form (the RQ phase and one ``complex_hess_tri``
call on the kept block) and the batched 3 × 3 restore of T.

The JAX pair form and the port take the same Hessenberg–triangular pencil
(the port's reduction of a complex Gaussian pencil made with numpy from a
seed), at n = 160 with ns = 16 and w = 24, in complex128 (the pair form's
float64). Tolerances: faer's 8·n·eps for the backward errors
‖A − QSZᴴ‖/‖A‖, ‖B − QTZᴴ‖/‖B‖ and for max|QᴴQ − I|, max|ZᴴZ − I|; the
(α, β) pairs within 2·κ_i·η of f64 ``scipy.linalg.eig`` in the chordal
metric, matched to the nearest.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from complex_cases import DTYPES, chordal_ratio, eps, pencil_input, qz_backward
from faer_tpu.linalg.qz_multishift_cpair import multishift_qz_pair
from faer_tpu_torch.linalg import qz as tqz
from faer_tpu_torch.linalg import qz_multishift as tqm

torch.set_num_threads(1)


def test_multishift_qz_against_the_pair_form():
    """``multishift_qz`` at n = 160 (ns = 16, w = 24, every AED window's QZ
    the CPU route of ``complex_qz``) and the JAX package's
    ``multishift_qz_pair`` of the same pencil both converge to S, T upper
    triangular with the backward errors and unitarity within 8·n·eps and
    (α, β) within 2·κ_i·η of scipy's; the two (α, β) sets match each other
    within the sum of their bounds."""
    npdt = np.complex128
    n = 160
    a, b = pencil_input(n, npdt, seed=11)
    red = tqz.hessenberg_triangular(torch.from_numpy(a), torch.from_numpy(b))
    s, t, q, z, info = tqm.multishift_qz(*red, ns=16, w=24)
    assert bool(info.converged) and 0 < int(info.iterations) <= 30 * (n // 16 + 2)
    tol = 8 * n * eps(npdt)
    sn, tn = s.numpy(), t.numpy()
    assert np.all(np.tril(sn, -1) == 0) and np.all(np.tril(tn, -1) == 0)
    *errs, eta = qz_backward(a, b, sn, tn, q.numpy(), z.numpy())
    assert max(errs) <= tol, errs
    assert chordal_ratio(np.diag(sn), np.diag(tn), a, b, eta) <= 1
    pairs = [(jnp.asarray(x.numpy().real), jnp.asarray(x.numpy().imag)) for x in red]
    js, jt, jq, jz, jinfo = multishift_qz_pair(*pairs, ns=16, w=24)
    assert bool(jinfo.converged)
    js, jt, jq, jz = (np.asarray(x[0]) + 1j * np.asarray(x[1]) for x in (js, jt, jq, jz))
    *jerrs, jeta = qz_backward(a, b, js, jt, jq, jz)
    assert max(jerrs) <= tol, jerrs
    assert chordal_ratio(np.diag(sn), np.diag(tn), a, b, eta + jeta,
                         other=(np.diag(js), np.diag(jt))) <= 1


@pytest.mark.parametrize("name", ["c64", "c128"])
def test_window_rehess(name):
    """The AED window's return to Hessenberg–triangular form on its kept
    block k = 7 of w = 10 (a full block above, triangular rows below, as
    the spike reflector leaves it): S[:k, :k] Hessenberg and T triangular,
    both exactly; the rows and columns from k on of S and T below the kept
    block untouched; Qw's row 0 e₀ (the coupling row is never touched from
    the left); Qw S Zwᴴ and Qw T Zwᴴ the input's within 8·w·eps."""
    tdt, npdt = DTYPES[name]
    w, k = 10, 7
    a, b = pencil_input(w, npdt, seed=12)
    rows = np.arange(w)[:, None]
    s0 = np.where((rows < k) | (rows <= np.arange(w)[None, :]), a, 0).astype(npdt)
    t0 = np.where((rows < k) | (rows <= np.arange(w)[None, :]), b, 0).astype(npdt)
    eye = torch.eye(w, dtype=tdt)
    s, t, qw, zw = tqm._window_rehess(torch.from_numpy(s0), torch.from_numpy(t0), eye, eye,
                                      torch.tensor(k))
    sn, tn, qn, zn = (x.numpy() for x in (s, t, qw, zw))
    assert np.all(np.tril(sn[:k, :k], -2) == 0) and np.all(np.tril(tn, -1) == 0)
    assert np.array_equal(sn[k:], s0[k:]) and np.array_equal(tn[k:], t0[k:])
    assert np.array_equal(qn[0], np.eye(w)[0])
    rec_a, rec_b, orth_q, orth_z, _ = qz_backward(s0, t0, sn, tn, qn, zn)
    assert max(rec_a, rec_b, orth_q, orth_z) <= 8 * w * eps(npdt)


@pytest.mark.parametrize("name", ["c64", "c128"])
def test_right_restore_t(name):
    """The batched 3 × 3 unitaries of the sweep's right restore: t3 · Z
    upper triangular within 8·eps·‖t3‖, Z unitary within 8·eps, the
    identity for a triangular t3."""
    tdt, npdt = DTYPES[name]
    a, _ = pencil_input(3, npdt, seed=13)
    rng = np.random.default_rng(13)
    t3 = np.stack([a, np.triu(a), a * 1e-20,
                   rng.standard_normal((3, 3)) + 1j * rng.standard_normal((3, 3))]).astype(npdt)
    z3 = tqm._right_restore_t(torch.from_numpy(t3)).numpy().astype(np.complex128)
    prod = t3.astype(np.complex128) @ z3
    for i in range(len(t3)):
        scale = np.abs(t3[i]).max()
        assert np.abs(np.tril(prod[i], -1)).max() <= 8 * eps(npdt) * scale
        assert np.abs(z3[i].conj().T @ z3[i] - np.eye(3)).max() <= 8 * eps(npdt)
    assert np.array_equal(z3[1], np.eye(3))


def _padded(h, t, pad):
    """(hp, tp, qp, zp): the pencil padded as ``multishift_qz`` pads it (H
    and Q, Z with zeros, T with the identity), Q = Z = I."""
    n = h.shape[0]
    big = n + 2 * pad
    hp = torch.zeros((big, big), dtype=h.dtype)
    hp[pad:pad + n, pad:pad + n] = h
    tp = torch.eye(big, dtype=h.dtype)
    tp[pad:pad + n, pad:pad + n] = t
    qp, zp = (torch.zeros((n, big), dtype=h.dtype) for _ in range(2))
    qp[:, pad:pad + n] = zp[:, pad:pad + n] = torch.eye(n, dtype=h.dtype)
    return hp, tp, qp, zp


def test_packed_sweeps_converge_on_their_shifts():
    """Four multishift sweeps at n = 100, 8 bulges packed 3 rows apart,
    each sweep's 16 shifts the eigenvalues of the trailing 16 × 16 (f64
    scipy), as AED gives them: the least coupling of the trailing 24 rows
    falls below 1e-8·‖H‖ (it stalls far above when a cleared bulge
    column's rounding residue is left for the bulge behind to mix into the
    rows below it, which blurs the shifts); after each sweep H is exactly
    Hessenberg, T exactly triangular and Q H Zᴴ, Q T Zᴴ are the input's
    within 8·n·eps."""
    import scipy.linalg

    npdt, n, nb = np.complex128, 100, 8
    a, b = pencil_input(n, npdt, seed=17)
    h, t, _, _ = tqz.hessenberg_triangular(torch.from_numpy(a), torch.from_numpy(b))
    pad = 6 * nb + 2
    mats = _padded(h, t, pad)
    inner = slice(pad, pad + n)
    smlnum = torch.tensor(np.finfo(np.float64).tiny, dtype=torch.float64)
    hn, tn = (float(torch.linalg.matrix_norm(x)) for x in (h, t))
    tol = 8 * n * eps(npdt)
    for _ in range(4):
        hs, ts = (m[inner, inner].numpy() for m in mats[:2])
        lam = torch.from_numpy(scipy.linalg.eigvals(hs[-2 * nb:, -2 * nb:], ts[-2 * nb:, -2 * nb:]))
        tqm._sweep(*mats, 0, n - 1, lam[0::2].clone(), lam[1::2].clone(), smlnum,
                   off=pad, nb=nb, step=3 * nb - 1)
        hs, ts, qs, zs = (m[inner, inner] if m.shape[0] > n else m[:, inner] for m in mats)
        assert torch.all(torch.tril(hs, -2) == 0) and torch.all(torch.tril(ts, -1) == 0)
        assert float(torch.linalg.matrix_norm(qs @ hs @ zs.mH - h)) <= tol * hn
        assert float(torch.linalg.matrix_norm(qs @ ts @ zs.mH - t)) <= tol * tn
    least = float(hs.diagonal(-1)[-(2 * nb + 8):].abs().min())
    assert least <= 1e-8 * float(torch.linalg.matrix_norm(hs)), least


def test_sweep_stays_finite_past_a_subnormal_tail():
    """A complex64 sweep on the block [0, 29] of a 40 × 40 pencil whose
    deflated rows 30.. hold subnormal entries two below the diagonal (the
    bulges idle there read them): everything stays finite. A complex
    quotient by a subnormal scale forms its reciprocal, which overflows;
    the port divides the real and imaginary parts."""
    npdt, n, hi, nb = np.complex64, 40, 29, 4
    a, b = pencil_input(n, npdt, seed=19)
    h, t, _, _ = tqz.hessenberg_triangular(torch.from_numpy(a), torch.from_numpy(b))
    h[hi + 1, hi] = 0.0
    for r in range(hi + 1, n - 1):
        h[r + 1, r] = 0.0
        if r + 1 < n:
            h[r + 1, r - 1] = 1e-39 + 1e-39j
    pad = 20
    mats = _padded(h, t, pad)
    s1, s2 = (torch.from_numpy((np.arange(nb) * (0.5 + 0.25j) + c).astype(npdt))
              for c in (0.1, -0.3j))
    smlnum = torch.tensor(float(np.finfo(np.float32).eps), dtype=torch.float32)
    tqm._sweep(*mats, 0, hi, s1, s2, smlnum, off=pad, nb=nb, step=3 * nb - 1)
    assert all(bool(torch.isfinite(torch.view_as_real(m)).all()) for m in mats)


def test_gevd_converges_on_a_gaussian_200_pencil():
    """``gevd`` of the complex64 Gaussian 200 × 200 pencil of the card test
    (numpy ``default_rng(200)``) on the CPU route: converged within 20
    multishift rounds (it used to stall, then run into non-finite values),
    the pencil residual of every column within 8·n·eps."""
    import faer_tpu_torch as ft
    from complex_cases import pencil_residual

    n = 200
    rng = np.random.default_rng(n)
    an, bn = ((rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n)))
              .astype(np.complex64) for _ in range(2))
    alpha, beta, v, info = ft.gevd(torch.from_numpy(an), torch.from_numpy(bn))
    assert bool(info.converged) and 0 < int(info.iterations) <= 20, info
    assert pencil_residual(an, bn, alpha, beta, v) <= 8 * n * eps(np.complex64)


def test_qz_budget_bounds_the_multishift_rounds():
    """``qz(..., max_sweeps_factor=0)`` at n = 128 (the multishift route)
    runs no round: not converged, no iteration, A = Q S Zᴴ and B = Q T Zᴴ
    still within 8·n·eps (S the Hessenberg H, T triangular)."""
    npdt, n = np.complex64, 128
    a, b = pencil_input(n, npdt, seed=23)
    s, t, q, z, info = tqz.qz(torch.from_numpy(a), torch.from_numpy(b), max_sweeps_factor=0)
    assert not bool(info.converged) and int(info.iterations) == 0
    errs = qz_backward(a, b, s.numpy(), t.numpy(), q.numpy(), z.numpy())[:4]
    assert max(errs) <= 8 * n * eps(npdt), errs
