"""The rest of ROADMAP item 8 in the port: ``linalg/batched.py`` (leading
batch dimensions over the drivers), ``ops/jacobi.py`` (Givens and Jacobi
rotations) and ``ops/zip.py`` (coefficient-wise helpers), against the JAX
package's functions of the same names (``jax.vmap`` for the batches), in
the real and complex dtypes; and ``interop`` round trips of complex data
and of the JAX package's (re, im) pairs.

Inputs come from a numpy seed; tolerance faer's 8·n·eps of the dtype
(``utils/approx.py``).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import faer_tpu.linalg.batched as jb
import faer_tpu.linalg.factor_cpair as jfc
import faer_tpu.ops.jacobi as jjac
import faer_tpu.ops.zip as jzip
from faer_tpu_torch import interop
from faer_tpu_torch.core.errors import ShapeError
from faer_tpu_torch.linalg import batched as tb
from faer_tpu_torch.linalg import cholesky as tchol
from faer_tpu_torch.linalg import solvers as tsolvers
from faer_tpu_torch.ops import jacobi as tjac
from faer_tpu_torch.ops import zip as tzip

from complex_cases import close, eps

torch.set_num_threads(1)
DT = {"f32": (torch.float32, np.float32), "f64": (torch.float64, np.float64),
      "c64": (torch.complex64, np.complex64), "c128": (torch.complex128, np.complex128)}


def _randn(rng, shape, npdt):
    x = rng.standard_normal(shape)
    if np.issubdtype(npdt, np.complexfloating):
        x = x + 1j * rng.standard_normal(shape)
    return x.astype(npdt)


def _spd_batch(rng, batch, n, npdt):
    g = _randn(rng, batch + (n, n), npdt)
    return (g @ np.swapaxes(g.conj(), -1, -2) / n + np.eye(n)).astype(npdt)


# -- batched -----------------------------------------------------------------------

@pytest.mark.parametrize("name", list(DT))
def test_batched_factorizations_match_vmap(name):
    """Every function of ``batched`` on a batch of 3 (and a (2, 2) batch),
    against ``jax.vmap`` of the JAX drivers (the SVD and self-adjoint EVD
    batches against numpy): the same shapes, info fields gaining the batch,
    results within 8·n·eps (the solves within 8·10n·eps)."""
    tdt, npdt = DT[name]
    rng = np.random.default_rng(8)
    n = 6
    a = _spd_batch(rng, (3,), n, npdt)
    g = _randn(rng, (3, n, n), npdt)
    b = _randn(rng, (3, n, 2), npdt)
    ta, tg, tbb = (torch.from_numpy(x) for x in (a, g, b))
    l, info = tb.llt_factor(ta)
    lj, infoj = jb.llt_factor(jnp.asarray(a))
    assert l.shape == (3, n, n) and info.success.shape == (3,) and bool(info.success.all())
    close(l.numpy(), np.asarray(lj), n, npdt)
    close(tb.llt_solve(l, tbb).numpy(), np.asarray(jb.llt_solve(lj, jnp.asarray(b))), n, npdt)
    x, info = tb.llt_solve_batched(ta, tbb)
    close(x.numpy(), np.asarray(jb.llt_solve_batched(jnp.asarray(a), jnp.asarray(b))[0]),
          n, npdt)
    f, perm, info = tb.lu_factor(tg)
    fj, pj, _ = jb.lu_factor(jnp.asarray(g))
    assert perm.shape == (3, n) and info.transposition_count.shape == (3,)
    assert np.array_equal(perm.numpy(), np.asarray(pj))
    close(f.numpy(), np.asarray(fj), n, npdt)
    close(tb.lu_solve(f, perm, tbb).numpy(),
          np.asarray(jb.lu_solve(fj, pj, jnp.asarray(b))), 10 * n, npdt)
    packed, ts = tb.qr_factor(tg)
    pkj, tsj = jb.qr_factor(jnp.asarray(g))
    close(packed.numpy(), np.asarray(pkj), n, npdt)
    close(ts.numpy(), np.asarray(tsj), n, npdt)
    close(tb.qr_solve_lstsq_batched(tg, tbb).numpy(),
          np.asarray(jb.qr_solve_lstsq_batched(jnp.asarray(g), jnp.asarray(b))), 10 * n, npdt)
    # the spectral batches against numpy (their JAX drivers are held to the
    # port's one problem at a time in the spectral test files)
    u, s, v, sinfo = tb.svd(tg)
    assert u.shape == v.shape == (3, n, n) and sinfo.converged.shape == (3,)
    close(s.numpy(), np.linalg.svd(g.astype(np.complex128), compute_uv=False), n, npdt)
    w, vw, _ = tb.self_adjoint_evd(ta)
    close(w.numpy(), np.linalg.eigvalsh(a.astype(np.complex128)), n, npdt)
    # several leading dimensions: (2, 2) problems
    a4 = _spd_batch(rng, (2, 2), n, npdt)
    l4, info4 = tb.llt_factor(torch.from_numpy(a4))
    assert l4.shape == (2, 2, n, n) and info4.success.shape == (2, 2)
    close(l4[1, 0].numpy(), tchol.llt_factor(torch.from_numpy(a4[1, 0]))[0].numpy(), n, npdt)


@pytest.mark.parametrize("name", ["f32", "f64"])
def test_batched_eigenvalues_match_vmap(name):
    """The general eigenvalues of a real batch, and of a complex one (item
    10b-i), against the JAX package's vmap."""
    tdt, npdt = DT[name]
    g = _randn(np.random.default_rng(9), (2, 5, 5), npdt)
    w = tb.eigenvalues(torch.from_numpy(g)).numpy()
    wj = np.asarray(jb.eigenvalues(jnp.asarray(g)))
    for k in range(2):
        close(np.sort_complex(w[k]), np.sort_complex(wj[k]), 5, npdt)
    c = (g + 1j * _randn(np.random.default_rng(10), (2, 5, 5), npdt)).astype(
        np.complex64 if npdt == np.float32 else np.complex128)
    wc = tb.eigenvalues(torch.from_numpy(c)).numpy()
    wcj = np.asarray(jb.eigenvalues(jnp.asarray(c)))
    assert wc.dtype == c.dtype
    for k in range(2):
        close(np.sort_complex(wc[k]), np.sort_complex(wcj[k]), 5, npdt)


def test_batched_shape_errors():
    with pytest.raises(ShapeError):
        tb.llt_factor(torch.eye(3))
    with pytest.raises(ShapeError):
        tb.llt_solve(torch.eye(3).expand(2, 3, 3), torch.ones(3, 3, 1))


# -- jacobi ------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(DT))
def test_givens_matches_jax(name):
    """c, s, r within 8·eps of the JAX package's, c real, c² + |s|² = 1,
    Gᴴ[a, b] = [r, 0]; b = 0 and a = 0 edges; both applies."""
    tdt, npdt = DT[name]
    rng = np.random.default_rng(3)
    a, b = _randn(rng, (16,), npdt), _randn(rng, (16,), npdt)
    a[0], b[1], a[2], b[2] = 0, 0, 0, 0
    rot, r = tjac.make_givens(torch.from_numpy(a), torch.from_numpy(b))
    rj, rrj = jjac.make_givens(jnp.asarray(a), jnp.asarray(b))
    assert rot.c.dtype == tdt.to_real() and rot.s.dtype == tdt
    for got, ref in ((rot.c, rj.c), (rot.s, rj.s), (r, rrj)):
        close(got.numpy(), np.asarray(ref), 1, npdt)
    e = 8 * eps(npdt)
    assert np.abs(rot.c.numpy() ** 2 + np.abs(rot.s.numpy()) ** 2 - 1).max() <= e
    x, y = tjac.apply_on_the_left(rot, torch.from_numpy(a), torch.from_numpy(b))
    scale = np.maximum(np.abs(a), np.abs(b))
    assert np.all(np.abs(y.numpy()) <= e * scale)  # Gᴴ zeroes b
    assert np.all(np.abs(x.numpy() - r.numpy()) <= e * scale)
    rows = _randn(rng, (2, 16), npdt)
    for fn in ("apply_on_the_left", "apply_on_the_right"):
        got = getattr(tjac, fn)(rot, *torch.from_numpy(rows))
        ref = getattr(jjac, fn)(rj, *jnp.asarray(rows))
        for g_, r_ in zip(got, ref):
            close(g_.numpy(), np.asarray(r_), 2, npdt)


def test_givens_at_subnormal_squares():
    """The norm is hypot: entries whose float32 squares are subnormal still
    give c² + |s|² = 1 within 4·eps (the reference's squares would not)."""
    for a, b in ((1e-20, 3e-20), (-2e-25 + 1e-25j, 1e-25), (0.0, 1e-38)):
        dt = torch.complex64 if isinstance(a, complex) else torch.float32
        rot, r = tjac.make_givens(torch.tensor(a, dtype=dt), torch.tensor(b, dtype=dt))
        assert abs(rot.c.item() ** 2 + abs(rot.s.item()) ** 2 - 1) <= 4 * eps(np.float32)
        assert abs(r.item()) == pytest.approx(np.hypot(abs(a), abs(b)), rel=1e-6)


@pytest.mark.parametrize("name", ["f32", "f64"])
def test_jacobi_symmetric_matches_jax(name):
    tdt, npdt = DT[name]
    rng = np.random.default_rng(4)
    app, apq, aqq = (_randn(rng, (12,), npdt) for _ in range(3))
    apq[0], aqq[1] = 0, app[1]
    c, s = tjac.make_jacobi_symmetric(*(torch.from_numpy(x) for x in (app, apq, aqq)))
    cj, sj = jjac.make_jacobi_symmetric(*(jnp.asarray(x) for x in (app, apq, aqq)))
    close(c.numpy(), np.asarray(cj), 1, npdt)
    close(s.numpy(), np.asarray(sj), 1, npdt)
    # Jᵀ A J is diagonal
    off = c * s * (torch.from_numpy(app) - torch.from_numpy(aqq)) \
        + (c * c - s * s) * torch.from_numpy(apq)
    scale = np.maximum.reduce([np.abs(app), np.abs(apq), np.abs(aqq)])
    assert np.all(np.abs(off.numpy()) <= 8 * eps(npdt) * scale)


# -- zip ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(DT))
def test_zip_matches_jax(name):
    tdt, npdt = DT[name]
    rng = np.random.default_rng(5)
    a, b = _randn(rng, (5, 7), npdt), _randn(rng, (5, 7), npdt)
    ta, tbm = torch.from_numpy(a), torch.from_numpy(b)
    ja, jbm = jnp.asarray(a), jnp.asarray(b)

    def same(got, ref):
        assert np.array_equal(got.numpy(), np.asarray(ref))

    # arithmetic within 8·eps (XLA may fuse a complex product); masks exact
    close(tzip.cwise(lambda x, y: x * y + 1, ta, tbm).numpy(),
          np.asarray(jzip.cwise(lambda x, y: x * y + 1, ja, jbm)), 1, npdt)
    for strict in (False, True):
        for fn in ("cwise_triangular_lower", "cwise_triangular_upper"):
            same(getattr(tzip, fn)(lambda d, x: d - 2 * x, ta, tbm, strict=strict),
                 getattr(jzip, fn)(lambda d, x: d - 2 * x, ja, jbm, strict=strict))
        for lower in (True, False):
            same(tzip.copy_triangle(ta, tbm, lower=lower, strict=strict),
                 jzip.copy_triangle(ja, jbm, lower=lower, strict=strict))
    close(tzip.cwise_with_index(lambda i, j, x: x * (i + 2 * j), ta).numpy(),
          np.asarray(jzip.cwise_with_index(lambda i, j, x: x * (i + 2 * j), ja)), 1, npdt)
    sq = torch.from_numpy(a[:, :5].copy())
    for from_lower in (True, False):
        got = tzip.make_self_adjoint(sq, from_lower=from_lower)
        same(got, jzip.make_self_adjoint(jnp.asarray(a[:, :5]), from_lower=from_lower))
        # mirrored and conjugated off the diagonal (the diagonal kept as given,
        # as in the reference)
        assert torch.equal(torch.tril(got, -1), torch.tril(got.mH, -1))
    close(tzip.kron(ta[:2, :3], tbm[:3, :2]).numpy(),
          np.asarray(jzip.kron(ja[:2, :3], jbm[:3, :2])), 1, npdt)


# -- interop -----------------------------------------------------------------------

@pytest.mark.parametrize("name", ["c64", "c128"])
def test_interop_complex_round_trips(name):
    """Complex numpy to the port's tensors and solver objects and back; the
    JAX package's pair outputs (re, im) become complex tensors that the
    port solves with."""
    tdt, npdt = DT[name]
    rng = np.random.default_rng(6)
    n = 9
    a = _spd_batch(rng, (), n, npdt)
    b = _randn(rng, (n, 2), npdt)
    (lr, li), info = jfc.llt_factor_pair(jnp.asarray(a.real), jnp.asarray(a.imag))
    l = interop.complex_from_pair(np.asarray(lr), np.asarray(li), device="cpu")
    assert l.dtype == tdt
    x = tchol.llt_solve(l, torch.from_numpy(b)).numpy()
    close(a.astype(np.complex128) @ x, b, n, npdt)
    re, im = interop.complex_to_pair(l)
    assert np.array_equal(re, np.asarray(lr)) and np.array_equal(im, np.asarray(li))
    # a solver object from the pair fields, and from complex arrays
    obj = interop.solver_from_numpy(
        "Llt", device="cpu", l=(np.asarray(lr), np.asarray(li)),
        info={"dynamic_regularization_count": np.asarray(info.dynamic_regularization_count),
              "success": np.asarray(info.success)})
    assert isinstance(obj, tsolvers.Llt) and obj.l.dtype == tdt
    kind, fields = interop.solver_to_numpy(tsolvers.Lblt.new(torch.from_numpy(a)))
    back = interop.solver_from_numpy(kind, device="cpu", **fields)
    assert back.lb.dtype == tdt and torch.equal(back.perm, tsolvers.Lblt.new(
        torch.from_numpy(a)).perm)
    close(back.solve(torch.from_numpy(b)).numpy(), np.linalg.solve(
        a.astype(np.complex128), b), 10 * n, npdt)
    lu, perm, luinfo = interop.lu_from_numpy((np.asarray(lr), np.asarray(li)), np.arange(n),
                                             0, True, device="cpu")
    assert lu.dtype == tdt and perm.dtype == torch.int64
