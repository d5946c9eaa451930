"""The port's facade (``Mat``, ``Col``, ``Row``, ``Diag``, ``Scale``, the
solver objects, ``ops.reductions``, ``interop``) against ``faer_tpu``'s.

Inputs are made with numpy from a seed and fed to both packages (JAX on the
CPU); every port object is made with ``device="cpu"``. Tolerances follow
faer's rule ``8·n·eps_f32`` (``utils/approx.py``): elementwise where both
sides compute the same thing, normwise residuals (and forward errors scaled
by the condition number) for solves; singular and eigenvectors are compared
through what their signs do not change (reconstructions, projectors,
solves).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import faer_tpu as jft
from faer_tpu.core.errors import NonPositivePivotError as JNonPositivePivotError
from faer_tpu.linalg import solvers as jsolvers
from faer_tpu.ops import reductions as jred
import faer_tpu_torch as tft
from faer_tpu_torch import interop
from faer_tpu_torch.core.config import config, launch_counts, reset_launch_counts
from faer_tpu_torch.core.errors import NonPositivePivotError, ShapeError
from faer_tpu_torch.core.flags import Norm, Side
from faer_tpu_torch.linalg import solvers as tsolvers
from faer_tpu_torch.ops import reductions as tred
from faer_tpu_torch.utils.approx import assert_approx_eq, size_scale

torch.set_num_threads(1)

EPS32 = float(np.finfo(np.float32).eps)
CPU = "cpu"


def _np(x):
    return np.asarray(x.a if hasattr(x, "a") else x)


def _close(got, want, n, **kw):
    assert_approx_eq(np.asarray(got.detach() if hasattr(got, "detach") else _np(got)),
                     _np(want), scale=size_scale(n), tol_dtype=np.float32, **kw)


def _spd(n, rng):
    g = rng.standard_normal((n, n))
    return (g @ g.T / n + np.eye(n)).astype(np.float32)


def _gauss(shape, rng, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _res(a, x, b):
    a, x, b = (np.asarray(v, np.float64) for v in (a, x, b))
    return np.linalg.norm(a @ x - b) / (np.linalg.norm(a) * np.linalg.norm(x))


def _tm(x):
    return tft.Mat(torch.from_numpy(np.ascontiguousarray(x)))


# -- Mat ----------------------------------------------------------------------

def test_mat_constructors_match_jax():
    for name in ("zeros", "ones", "identity"):
        got = getattr(tft.Mat, name)(5, 3, device=CPU)
        want = getattr(jft.Mat, name)(5, 3)
        assert got.dtype == torch.float32 and got.device.type == "cpu"
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    np.testing.assert_array_equal(np.asarray(tft.Mat.full(2, 4, 1.5, device=CPU)),
                                  np.asarray(jft.Mat.full(2, 4, 1.5)))
    f = lambda i, j: i * 10 + j  # noqa: E731
    np.testing.assert_array_equal(np.asarray(tft.Mat.from_fn(3, 4, f, device=CPU)),
                                  np.asarray(jft.Mat.from_fn(3, 4, f)))


def test_mat_device_rule():
    x = torch.ones(3, 3)
    assert tft.Mat(x).device.type == "cpu"
    assert tft.Mat(np.ones((2, 2)), device=CPU).dtype == torch.float64
    assert tft.Mat(np.ones((2, 2), np.int32), device=CPU).dtype == torch.float32
    assert tft.Mat(tft.Mat(x)).a is x
    with pytest.raises(TypeError):
        tft.Mat(np.ones((2, 2), np.float16), device=CPU)
    # array-likes go to the card unless the caller asks for the CPU
    if torch.cuda.is_available():
        assert tft.Mat(np.ones((2, 2))).device.type == "cuda"
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            tft.Mat(np.ones((2, 2)))


def test_mat_properties_and_indexing_match_jax():
    rng = np.random.default_rng(0)
    a = _gauss((6, 4), rng)
    t, j = _tm(a), jft.Mat(jnp.asarray(a))
    assert t.shape == j.shape and (t.nrows, t.ncols) == (j.nrows, j.ncols)
    for attr in ("T", "transpose", "H", "adjoint"):
        np.testing.assert_array_equal(np.asarray(getattr(t, attr)),
                                      np.asarray(getattr(j, attr)))
    np.testing.assert_array_equal(np.asarray(t.conjugate()), np.asarray(j.conjugate()))
    assert isinstance(t[1:3], tft.Mat) and not isinstance(t[1], tft.Mat)
    np.testing.assert_array_equal(np.asarray(t[1:3]), np.asarray(j[1:3]))
    np.testing.assert_array_equal(t[2].numpy(), np.asarray(j[2]))
    got = t.at_set((1, 2), 7.0)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(j.at_set((1, 2), 7.0)))
    assert t.a[1, 2] == a[1, 2]  # a new Mat: the original is unchanged
    got = t.at_set(slice(0, 2), tft.Mat(torch.zeros(2, 4)))
    np.testing.assert_array_equal(np.asarray(got)[:2], 0.0)
    assert t.astype(torch.float64).dtype == torch.float64
    assert t == _tm(a) and not (t == _tm(a + 1)) and not (t == 3)


def test_mat_operators_match_jax():
    rng = np.random.default_rng(1)
    a, b, c = _gauss((7, 7), rng), _gauss((7, 7), rng), _gauss((7, 3), rng)
    v = _gauss((7,), rng)
    ta, tb, ja, jb = _tm(a), _tm(b), jft.Mat(jnp.asarray(a)), jft.Mat(jnp.asarray(b))
    pairs = [
        (ta + tb, ja + jb), (ta - tb, ja - jb), (ta + 2.0, ja + 2.0),
        (2.0 + ta, 2.0 + ja), (1.0 - ta, 1.0 - ja), (-ta, -ja), (ta * 3.0, ja * 3.0),
        (3.0 * ta, 3.0 * ja), (ta * tb, ja * jb), (ta / 2.0, ja / 2.0),
        (ta @ tb, ja @ jb), (ta @ torch.from_numpy(c), ja @ jnp.asarray(c)),
        (torch.from_numpy(c.T.copy()) @ ta, jnp.asarray(c.T) @ ja),
    ]
    for got, want in pairs:
        assert isinstance(got, tft.Mat)
        _close(got.a, want, 7)
    got = ta @ torch.from_numpy(v)
    assert not isinstance(got, tft.Mat)
    _close(got, ja @ jnp.asarray(v), 7)


def test_mat_norms_and_reductions_match_jax():
    rng = np.random.default_rng(2)
    a = _gauss((9, 5), rng)
    t, j = _tm(a), jft.Mat(jnp.asarray(a))
    for name in ("norm_l1", "norm_l2", "norm_max", "sum"):
        _close(getattr(t, name)(), getattr(j, name)(), 45)
    sq = _gauss((6, 6), rng)
    _close(_tm(sq).trace(), jft.Mat(jnp.asarray(sq)).trace(), 6)
    for x in (a, np.zeros((3, 3), np.float32), np.full((4,), 3e30, np.float32)):
        tx, jx = torch.from_numpy(x), jnp.asarray(x)
        for kind in Norm:
            got = tred.norm(tx, kind)
            want = jred.norm(jx, getattr(jft.Norm, kind.name))
            assert got.dtype == torch.float32 and got.dim() == 0
            if np.isinf(float(want)):  # the squared norm of 3e30 overflows in both
                assert float(got) == float(want)
            else:
                _close(got, want, x.size)
        _close(tred.sum_all(tx), jred.sum_all(jx), x.size)
    assert np.isfinite(float(tred.norm_l2(torch.full((4,), 3e30))))  # no overflow
    _close(tred.prod_diag(torch.from_numpy(sq)), jred.prod_diag(jnp.asarray(sq)), 6)
    (s1, l1), (s2, l2) = (tred.log_abs_det_diag(torch.from_numpy(sq)),
                          jred.log_abs_det_diag(jnp.asarray(sq)))
    assert float(s1) == float(s2)
    _close(l1, l2, 6)


def test_scale_matches_jax():
    rng = np.random.default_rng(3)
    a = _gauss((4, 4), rng)
    t, j = _tm(a), jft.Mat(jnp.asarray(a))
    for got, want in ((tft.Scale(2.5) * t, jft.Scale(2.5) * j),
                      (t * tft.Scale(-1.0), j * jft.Scale(-1.0))):
        assert isinstance(got, tft.Mat)
        _close(got.a, want, 4)
    assert (tft.Scale(2.0) * tft.Scale(3.0)).value == 6.0
    _close(tft.Scale(2.0) * torch.from_numpy(a), jft.Scale(2.0) * jnp.asarray(a), 4)


# -- Col / Row / Diag -----------------------------------------------------------

def test_vectors_match_jax():
    rng = np.random.default_rng(4)
    x, y = _gauss((6,), rng), _gauss((6,), rng)
    m = _gauss((6, 6), rng)
    tx, ty = tft.Col(torch.from_numpy(x)), tft.Col(torch.from_numpy(y))
    jx, jy = jft.Col(jnp.asarray(x)), jft.Col(jnp.asarray(y))
    tm_, jm = torch.from_numpy(m), jnp.asarray(m)
    assert len(tx) == 6 and tx.shape == (6,) and tx.device.type == "cpu"
    pairs = [
        (tx + ty, jx + jy), (tx - ty, jx - jy), (1.0 - tx, 1.0 - jx), (tx * 2.0, jx * 2.0),
        (-tx, -jx), (tx.T, jx.T), (tx.H, jx.H), (tx.T + ty.T, jx.T + jy.T),
        (tx.T - ty.T, jx.T - jy.T), (-(tx.T), -(jx.T)), (tx.T * 3.0, jx.T * 3.0),
        (tx.T @ tm_, jx.T @ jm),
        (tft.Diag(torch.from_numpy(x)) @ ty, jft.Diag(jnp.asarray(x)) @ jy),
        (tft.Diag(torch.from_numpy(x)).inverse(), jft.Diag(jnp.asarray(x)).inverse()),
        (tft.Diag(torch.from_numpy(x)) * 2.0, jft.Diag(jnp.asarray(x)) * 2.0),
        (tft.Diag(torch.from_numpy(x)).column_vector(), jft.Diag(jnp.asarray(x)).column_vector()),
    ]
    for got, want in pairs:
        assert type(got).__name__ == type(want).__name__
        _close(got.a, want.a, 6)
    for got, want in ((tx.as_mat(), jx.as_mat()), (tx.T.as_mat(), jx.T.as_mat()),
                      (tx @ tm_[:1], jx @ jm[:1]),
                      (tft.Diag(torch.from_numpy(x)).as_mat(), jft.Diag(jnp.asarray(x)).as_mat()),
                      (tft.Diag(torch.from_numpy(x)) @ tm_, jft.Diag(jnp.asarray(x)) @ jm),
                      (_tm(m) @ tft.Diag(torch.from_numpy(x)),
                       m @ jft.Diag(jnp.asarray(x)))):  # numpy defers to Diag
        assert isinstance(got, tft.Mat)
        _close(got.a, want, 6)
    _close(tx.T @ ty, jx.T @ jy, 6)
    for name in ("norm_l1", "norm_l2", "norm_max", "sum"):
        _close(getattr(tx, name)(), getattr(jx, name)(), 6)
    for got, want in ((tft.Col.zeros(3, device=CPU), jft.Col.zeros(3)),
                      (tft.Col.ones(3, device=CPU), jft.Col.ones(3)),
                      (tft.Row.zeros(3, device=CPU), jft.Row.zeros(3)),
                      (tft.Col.from_fn(4, lambda i: i * 2, device=CPU),
                       jft.Col.from_fn(4, lambda i: i * 2))):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    with pytest.raises(ValueError):
        tx @ ty
    with pytest.raises(ValueError):
        tft.Col(torch.ones(2, 2))


# -- solvers ----------------------------------------------------------------------

@pytest.mark.parametrize("n", [64, 300])
def test_llt_solver_matches_jax(n):
    rng = np.random.default_rng(n)
    a = _spd(n, rng)
    b = _gauss((n, 5), rng)
    t, j = _tm(a).llt(), jft.Mat(jnp.asarray(a)).llt()
    assert isinstance(t, tsolvers.Llt)
    _close(t.L, j.L, n)
    _close(t.reconstruct(), a, n)
    tol = size_scale(n) * EPS32
    for got, want in ((t.solve(torch.from_numpy(b)), j.solve(jnp.asarray(b))),
                      (t.solve(_tm(b)), j.solve(jft.Mat(jnp.asarray(b)))),
                      (t.solve_conjugate(torch.from_numpy(b)),
                       j.solve_conjugate(jnp.asarray(b)))):
        assert _res(a, got, b) <= tol
        _close(got, want, n)
    inv = t.inverse()
    _close(inv, j.inverse(), n)
    assert np.abs(a.astype(np.float64) @ inv.numpy() - np.eye(n)).max() <= tol * 10
    _close(t.logdet(), j.logdet(), n)
    if n == 64:
        _close(t.determinant(), j.determinant(), n)
    ll = tft.Mat(torch.from_numpy(np.triu(a).T.copy()).T.contiguous()).llt(Side.UPPER)
    _close(ll.L, t.L, n)


@pytest.mark.parametrize("n", [64, 300])
def test_partial_piv_lu_solver_matches_jax(n):
    rng = np.random.default_rng(n + 1)
    g = _gauss((n, n), rng, 1 / np.sqrt(n))  # |det| within f32 range
    b = _gauss((n, 4), rng)
    t, j = _tm(g).partial_piv_lu(), jft.Mat(jnp.asarray(g)).partial_piv_lu()
    g64 = g.astype(np.float64)
    tol = size_scale(n) * EPS32
    kappa = np.linalg.cond(g64)
    assert np.linalg.norm(t.reconstruct().numpy() - g64) / np.linalg.norm(g64) <= tol
    _close(t.L @ t.U, g[t.row_perm.numpy()], n)
    for got, want, mat in ((t.solve(torch.from_numpy(b)), j.solve(jnp.asarray(b)), g64),
                           (t.solve_transpose(torch.from_numpy(b)),
                            j.solve_transpose(jnp.asarray(b)), g64.T)):
        assert _res(mat, got, b) <= tol
        assert np.linalg.norm(got.numpy() - np.asarray(want)) \
            <= tol * kappa * np.linalg.norm(np.asarray(want))
    inv = t.inverse()
    assert np.linalg.norm(inv.numpy() - np.asarray(j.inverse())) \
        <= tol * kappa * np.linalg.norm(np.asarray(j.inverse()))
    det_t, det_j = float(t.determinant()), float(j.determinant())
    sign, logabs = np.linalg.slogdet(g64)
    if n == 64:  # log|det| ≈ −n/2: in f32 range at 64, below it at 300
        assert np.sign(det_t) == np.sign(det_j) == sign
        assert abs(np.log(abs(det_t)) - logabs) <= tol * kappa * n
    assert float(_tm(g).determinant()) == det_t
    # sign and log|det| from the factor, at any size
    s, l = tred.log_abs_det_diag(t.U)
    assert float(s) * (1 - 2 * (int(t.info.transposition_count) % 2)) == sign
    assert abs(float(l) - logabs) <= tol * kappa * n
    _close(_tm(g).inverse().a, inv, n)
    _close(_tm(g).solve(torch.from_numpy(b)), t.solve(torch.from_numpy(b)), n)


@pytest.mark.parametrize("m,n", [(64, 64), (300, 64)])
def test_qr_solver_matches_jax(m, n):
    rng = np.random.default_rng(m + n)
    a = _gauss((m, n), rng)
    b = _gauss((m, 3), rng)
    t, j = _tm(a).qr(), jft.Mat(jnp.asarray(a)).qr()
    tol = size_scale(m) * EPS32
    _close(t.R, j.R, m)
    _close(t.reconstruct(), a, m)
    for thin in (True, False):
        _close(t.compute_q(thin=thin), j.compute_q(thin=thin), m)
    for adjoint in (False, True):
        _close(t.apply_q(torch.from_numpy(b), adjoint=adjoint),
               j.apply_q(jnp.asarray(b), adjoint=adjoint), m)
    x = t.solve_lstsq(torch.from_numpy(b)).numpy()
    a64 = a.astype(np.float64)
    r = b - a64 @ x
    if m == n:
        assert _res(a64, x, b) <= tol
    else:  # the residual is orthogonal to the columns
        assert np.linalg.norm(a64.T @ r) / (np.linalg.norm(a64) * np.linalg.norm(r)) <= tol
    _close(x, j.solve_lstsq(jnp.asarray(b)), m)
    _close(_tm(a).solve_lstsq(torch.from_numpy(b)), x, m)
    if m == n:
        _close(t.solve(torch.from_numpy(b)), j.solve(jnp.asarray(b)), m)
        _close(t.inverse(), j.inverse(), m)
    else:
        with pytest.raises(ShapeError):
            t.solve(torch.from_numpy(b))


@pytest.mark.parametrize("shape", [(48, 48), (60, 40)])
def test_svd_solver_matches_jax(shape):
    m, n = shape
    rng = np.random.default_rng(m * n)
    a = _gauss(shape, rng)
    t, j = _tm(a).svd(), jft.Mat(jnp.asarray(a)).svd()
    k = min(m, n)
    _close(t.S, j.S, max(m, n))
    _close(t.reconstruct(), a, max(m, n))
    _close(t.pseudoinverse(), j.pseudoinverse(), max(m, n), abs_tol=size_scale(m) * EPS32 * 10)
    for q in (t.U, t.V):
        _close(q.T @ q, np.eye(k), max(m, n))
    b = _gauss((m, 2), rng)
    _close(t.solve_lstsq(torch.from_numpy(b)), j.solve_lstsq(jnp.asarray(b)), max(m, n))
    assert int(t.rank()) == int(j.rank()) == k
    low = (a[:, :3] @ _gauss((3, n), rng)).astype(np.float32)  # rank 3
    assert int(_tm(low).rank()) == int(jft.Mat(jnp.asarray(low)).rank()) == 3
    _close(_tm(a).singular_values(), jft.Mat(jnp.asarray(a)).singular_values(), max(m, n))
    _close(_tm(a).thin_svd().S, t.S, max(m, n))


def test_self_adjoint_eigen_solver_matches_jax():
    n = 48
    rng = np.random.default_rng(7)
    g = _gauss((n, n), rng)
    a = ((g + g.T) / 2).astype(np.float32)
    t, j = _tm(a).self_adjoint_eigen(), jft.Mat(jnp.asarray(a)).self_adjoint_eigen()
    _close(t.eigenvalues, j.eigenvalues, n)
    _close(t.reconstruct(), a, n)
    v = t.eigenvectors.numpy()
    _close(v.T @ v, np.eye(n), n)
    b = _gauss((n, 2), rng)
    kappa = np.linalg.cond(a.astype(np.float64))
    got, want = t.solve(torch.from_numpy(b)).numpy(), np.asarray(j.solve(jnp.asarray(b)))
    assert np.linalg.norm(got - want) <= size_scale(n) * EPS32 * kappa * np.linalg.norm(want)
    up = _tm(np.triu(a)).self_adjoint_eigenvalues(Side.UPPER)
    _close(up, jft.Mat(jnp.asarray(np.triu(a))).self_adjoint_eigenvalues(jft.Side.UPPER), n)
    _close(_tm(np.tril(a)).self_adjoint_eigenvalues(), t.eigenvalues, n)


@pytest.mark.parametrize("rank", [1, 2, "Col"])
def test_self_adjoint_eigen_solve_keeps_the_rhs_shape(rank):
    """``SelfAdjointEigen.solve`` scales Vᵀb by w along its first dimension:
    an (n,) or ``Col`` right-hand side gives (n,), an (n, k) one (n, k), each
    within 8·n·eps·κ of f64 ``np.linalg.solve``, and a 1-D solve agrees
    with the 2-D solve's column to 8·n·eps (a matrix-vector product rounds
    in another order than a matrix product)."""
    n = 24
    rng = np.random.default_rng(17)
    a = _spd(n, rng)
    b2 = _gauss((n, 3), rng)
    rhs = {1: torch.from_numpy(b2[:, 0]), 2: torch.from_numpy(b2),
           "Col": tft.Col(torch.from_numpy(b2[:, 0]))}[rank]
    eig = _tm(a).self_adjoint_eigen()
    x = eig.solve(rhs)
    want_shape = (n, 3) if rank == 2 else (n,)
    assert tuple(x.shape) == want_shape
    a64 = a.astype(np.float64)
    want = np.linalg.solve(a64, b2 if rank == 2 else b2[:, 0].astype(np.float64))
    kappa = np.linalg.cond(a64)
    err = np.linalg.norm(x.numpy() - want) / np.linalg.norm(want)
    assert err <= 8 * n * EPS32 * kappa
    if rank != 2:
        _close(x, eig.solve(torch.from_numpy(b2))[:, 0].numpy(), n)


# -- errors -----------------------------------------------------------------------

def test_error_cases_match_jax():
    bad = -np.eye(8, dtype=np.float32)
    with pytest.raises(JNonPositivePivotError):
        jft.Mat(jnp.asarray(bad)).llt()
    reset_launch_counts()
    with pytest.raises(NonPositivePivotError):
        _tm(bad).llt()
    from faer_tpu_torch.core.config import host_reads

    assert host_reads() == 1  # the check reads info.success once
    assert not bool(tsolvers.Llt.new(torch.from_numpy(bad), check=False).info.success)
    with pytest.raises(ShapeError):
        _tm(np.ones((4, 3), np.float32)).partial_piv_lu()
    with pytest.raises(ShapeError):
        _tm(np.ones((4, 3), np.float32)).llt()
    # complex factorizations are ported (item 10a), and so are the complex
    # general EVD (item 10b-i) and the complex generalized EVD (item 10b-ii)
    assert tsolvers.PartialPivLu.new(torch.eye(3, dtype=torch.complex64)).lu.is_complex()
    assert tsolvers.Ldlt.new(torch.eye(3, dtype=torch.complex64)).ld.is_complex()
    ones = torch.ones(3, 3, dtype=torch.complex64)
    assert torch.allclose(tsolvers.Eigen.new(ones).w.abs().sort().values,
                          torch.tensor([0.0, 0.0, 3.0]), atol=1e-5)
    ge = tsolvers.GeneralizedEigen.new(ones + 3 * torch.eye(3, dtype=torch.complex64),
                                       torch.eye(3, dtype=torch.complex64))
    assert torch.allclose(ge.eigenvalues.abs().sort().values,
                          torch.tensor([3.0, 3.0, 6.0]), atol=1e-5)


@pytest.mark.parametrize("method,item", [
    ("eigen", "10"), ("eigenvalues", "10"), ("generalized_eigen", "10"),
])
def test_unported_methods_name_their_roadmap_item(method, item):
    """Every method of ROADMAP item 10 is ported: the complex general EVD
    (item 10b-i), the generalized EVD of a complex pencil (item 10b-ii) and
    the real ones (I, the complex pencil (I, I) and the real pencil (I, I)
    have the eigenvalues 1)."""
    c = tft.Mat(torch.eye(4, dtype=torch.complex64))
    out = getattr(c, method)(*((c,) if method == "generalized_eigen" else ()))
    w = out if method == "eigenvalues" else out.eigenvalues
    assert torch.equal(w, torch.ones(4, dtype=torch.complex64)), item
    real = _tm(np.eye(4, dtype=np.float32))
    out = getattr(real, method)(*((real,) if method == "generalized_eigen" else ()))
    w = out if method == "eigenvalues" else out.eigenvalues
    assert torch.equal(w, torch.ones(4, dtype=torch.complex64))


# -- interop: solver objects across the two packages ------------------------------

def _jax_fields(obj):
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if f.name == "info":
            out[f.name] = {k.name: np.asarray(getattr(v, k.name))
                           for k in dataclasses.fields(v)}
        elif f.name == "block":
            out[f.name] = v
        else:
            out[f.name] = np.asarray(v)
    return out


def _to_jax(kind, fields):
    from faer_tpu.core import errors as jerr

    cls = getattr(jsolvers, kind)
    info_cls = {"Llt": jerr.LltInfo, "PartialPivLu": jerr.LuInfo}.get(kind)
    args = {}
    for name, v in fields.items():
        if name == "info":
            args[name] = info_cls(**{k: jnp.asarray(x) for k, x in v.items()})
        elif name == "block":
            args[name] = v
        else:
            args[name] = jnp.asarray(v)
    return cls(**args)


@pytest.mark.parametrize("kind", ["Llt", "PartialPivLu", "Qr"])
def test_solver_objects_cross_between_packages(kind):
    n = 96
    rng = np.random.default_rng(11)
    a = _spd(n, rng) if kind == "Llt" else _gauss((n, n), rng)
    b = _gauss((n, 3), rng)
    method = "solve_lstsq" if kind == "Qr" else "solve"
    tol = size_scale(n) * EPS32 * np.linalg.cond(a.astype(np.float64))
    # JAX factor -> port
    jobj = getattr(jsolvers, kind).new(jnp.asarray(a))
    tobj = interop.solver_from_numpy(kind, device=CPU, **_jax_fields(jobj))
    assert isinstance(tobj, getattr(tsolvers, kind))
    want = np.asarray(getattr(jobj, method)(jnp.asarray(b)))
    got = getattr(tobj, method)(torch.from_numpy(b)).numpy()
    assert np.linalg.norm(got - want) <= tol * np.linalg.norm(want)
    # port factor -> JAX, through numpy
    tobj2 = getattr(tsolvers, kind).new(torch.from_numpy(a))
    kind2, fields = interop.solver_to_numpy(tobj2)
    assert kind2 == kind
    if kind == "PartialPivLu":
        assert fields["row_perm"].dtype == np.int32
    back = interop.solver_from_numpy(kind, device=CPU, **fields)
    for f in dataclasses.fields(back):
        if f.name not in ("info", "block"):
            assert torch.equal(getattr(back, f.name), getattr(tobj2, f.name))
    got2 = np.asarray(getattr(_to_jax(kind, fields), method)(jnp.asarray(b)))
    want2 = getattr(tobj2, method)(torch.from_numpy(b)).numpy()
    assert np.linalg.norm(got2 - want2) <= tol * np.linalg.norm(want2)


@pytest.mark.parametrize("name", ["llt_from_numpy", "lu_from_numpy", "qr_from_numpy",
                                  "tridiag_from_numpy", "solver_from_numpy"])
def test_interop_from_numpy_defaults_to_the_card(name):
    """Every ``*_from_numpy`` puts its tensors on the card unless the caller
    asks for the CPU, as ``Mat`` does (read from the signature: no card
    needed)."""
    import inspect

    assert inspect.signature(getattr(interop, name)).parameters["device"].default == "cuda"
    assert {n for n in dir(interop) if n.endswith("_from_numpy")} == {
        "llt_from_numpy", "lu_from_numpy", "qr_from_numpy", "tridiag_from_numpy",
        "solver_from_numpy"}


@pytest.mark.parametrize("kind", ["Svd", "SelfAdjointEigen"])
def test_spectral_solver_objects_cross_between_packages(kind):
    n = 40
    rng = np.random.default_rng(12)
    g = _gauss((n, n), rng)
    a = ((g + g.T) / 2).astype(np.float32) if kind == "SelfAdjointEigen" else g
    jobj = getattr(jsolvers, kind).new(jnp.asarray(a))
    tobj = interop.solver_from_numpy(kind, device=CPU, **_jax_fields(jobj))
    _close(tobj.reconstruct(), np.asarray(jobj.reconstruct()), n)
    assert bool(tobj.info.converged)
    kind2, fields = interop.solver_to_numpy(tobj)
    assert kind2 == kind and set(fields["info"]) == {"converged", "iterations"}


# -- the slice as a whole, with the tile GEMM switch on and off -------------------

@pytest.mark.parametrize("switch", [False, True])
def test_facade_slice_matches_jax(monkeypatch, switch):
    """``Mat(a).llt().solve``, ``partial_piv_lu().solve`` and
    ``qr().solve_lstsq`` at n = 256 against the JAX facade; with the switch
    on, the products above 128³ take ``tile_matmul`` (its plain version on
    the CPU, so no launch is counted)."""
    monkeypatch.setattr(config, "use_tile_matmul", switch)
    from faer_tpu_torch.ops import matmul as tmm

    routed = []
    real = tmm.tile_matmul
    monkeypatch.setattr(tmm, "tile_matmul", lambda a, b: routed.append(1) or real(a, b))
    n = 256
    rng = np.random.default_rng(21)
    spd, g = _spd(n, rng), _gauss((n, n), rng)
    b = _gauss((n, 8), rng)
    reset_launch_counts()
    x1 = _tm(spd).llt().solve(torch.from_numpy(b)).numpy()
    x2 = _tm(g).partial_piv_lu().solve(torch.from_numpy(b)).numpy()
    x3 = _tm(g).qr().solve_lstsq(torch.from_numpy(b)).numpy()
    assert bool(routed) is switch
    assert sum(launch_counts().values()) == 0
    tol = size_scale(n) * EPS32
    for x, mat, want in (
            (x1, spd, jft.Mat(jnp.asarray(spd)).llt().solve(jnp.asarray(b))),
            (x2, g, jft.Mat(jnp.asarray(g)).partial_piv_lu().solve(jnp.asarray(b))),
            (x3, g, jft.Mat(jnp.asarray(g)).qr().solve_lstsq(jnp.asarray(b)))):
        want = np.asarray(want)
        assert _res(mat, x, b) <= tol and _res(mat, want, b) <= tol
        kappa = np.linalg.cond(mat.astype(np.float64))
        assert np.linalg.norm(x - want) <= tol * kappa * np.linalg.norm(want)


# -- complex solver objects (ROADMAP item 10a) -------------------------------------

_COMPLEX_METHODS = {
    "llt": ("solve", "solve_conjugate", "inverse", "reconstruct", "determinant"),
    "ldlt": ("solve", "inverse", "reconstruct", "determinant"),
    "piv_llt": ("solve", "reconstruct"),
    "lblt": ("solve", "reconstruct"),
    "partial_piv_lu": ("solve", "solve_transpose", "inverse", "reconstruct", "determinant"),
    "full_piv_lu": ("solve", "reconstruct", "determinant"),
    "qr": ("solve", "solve_lstsq", "inverse", "reconstruct"),
    "col_piv_qr": ("solve", "solve_lstsq", "reconstruct"),
    "svd": ("solve_lstsq", "reconstruct"),
    "self_adjoint_eigen": ("solve", "reconstruct"),
}


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
@pytest.mark.parametrize("method", list(_COMPLEX_METHODS))
def test_complex_solver_objects_match_jax(method, dtype):
    """Each solver object of complex input against the JAX package's
    native-complex object: every method within 8·n·eps (relative to the
    largest entry; κ-scaled for the solves), a complex determinant, real L
    and D diagonals; a real right-hand side and a 1-D one are taken."""
    n = 12
    rng = np.random.default_rng(20)
    g = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    spd = method in ("llt", "ldlt", "piv_llt")
    herm = method in ("lblt", "self_adjoint_eigen")
    a = (g @ g.conj().T / n + np.eye(n) if spd else (g + g.conj().T) / 2 if herm else g)
    a = a.astype(dtype)
    b = (rng.standard_normal((n, 3)) + 1j * rng.standard_normal((n, 3))).astype(dtype)
    tobj = getattr(tft.Mat(torch.from_numpy(a)), method)()
    jobj = getattr(jft.Mat(jnp.asarray(a)), method)()
    e = float(np.finfo(dtype).eps)
    kappa = np.linalg.cond(a.astype(np.complex128))
    for name in _COMPLEX_METHODS[method]:
        args = (torch.from_numpy(b),) if name.startswith("solve") else ()
        jargs = (jnp.asarray(b),) if args else ()
        got = np.asarray(getattr(tobj, name)(*args))
        want = np.asarray(getattr(jobj, name)(*jargs))
        assert np.iscomplexobj(got), name
        scale = max(np.abs(want).max(), 1e-30) * (kappa if args or name == "inverse" else 1)
        assert np.abs(got - want).max() <= 8 * n * e * scale, name
    if spd and method != "piv_llt":
        diag = np.diagonal(np.asarray(tobj.L if method == "llt" else tobj.ld))
        assert np.all(diag.imag == 0)
    x = np.asarray(tobj.solve_lstsq(torch.from_numpy(b.real.copy())) if method == "svd"
                   else tobj.solve(torch.from_numpy(b.real.copy())))
    assert np.iscomplexobj(x)
    if method != "svd":
        x1 = tobj.solve(torch.from_numpy(b[:, 0].copy()))
        assert tuple(x1.shape) == (n,)


@pytest.mark.parametrize("call", [lambda m: m.eigen(), lambda m: m.eigenvalues(),
                                  lambda m: tft.evd(m.a), lambda m: tft.eigenvalues(m.a)])
def test_complex_general_evd_names_item_10b(call):
    """Item 10b-i ported the complex general EVD: each entry point takes a
    complex matrix (the eigenvalues of I are 1, of complex64)."""
    out = call(tft.Mat(torch.eye(4, dtype=torch.complex64)))
    w = out.eigenvalues if hasattr(out, "eigenvalues") else (
        out[0] if isinstance(out, tuple) else out)
    assert torch.equal(w, torch.ones(4, dtype=torch.complex64))
