"""The port's dense stack (LDLT, pivoted LLT, Bunch–Kaufman LBLT, the LLT
and LDLT rank updates, full-pivot LU, column-pivoted QR, and their solver
objects) against ``faer_tpu`` (JAX on the CPU) and f64 numpy, in float32
and float64.

Neither package has a kernel for these bodies; in float32 the port's
triangular solves and T factors run the ``trtri`` kernel's plain version
where the JAX package runs its non-kernel inverse, so float32 results
agree to rounding. Inputs are made with numpy from a seed, with sizes on
both sides of each driver's route edge: LDLT's 64-column panel, the
pivoted LLT's blocked form past n = 64, LBLT's past n = 96 (2×2 pivots
present), the full-pivot LU past one 256 block, the column-pivoted QR's
blocked form past 64. Tolerance: faer's rule 8·n·eps of the dtype
(``utils/approx.py``), elementwise between the packages (times the
condition number where rounding is amplified) and normwise against numpy.
Pivots are compared exactly where they are well separated (the inputs
here, in these seeds); a rank-deficient pivoted LLT is compared up to the
order of its dead columns, whose pivots are rounding noise.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import faer_tpu.linalg.cholesky as jchol
import faer_tpu.linalg.lu as jlu
import faer_tpu.linalg.qr as jqr
import faer_tpu.linalg.solvers as jsolvers
import faer_tpu_torch as tft
from faer_tpu_torch import interop
from faer_tpu_torch.core.params import LdltParams, LdltRegularization
from faer_tpu_torch.linalg import cholesky as tchol
from faer_tpu_torch.linalg import lu as tlu
from faer_tpu_torch.linalg import qr as tqr
from faer_tpu_torch.linalg import solvers as tsolvers
from faer_tpu_torch.utils.approx import assert_approx_eq, size_scale

torch.set_num_threads(1)

CPU = "cpu"
DTYPES = [np.float32, np.float64]


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, n, dt, kappa=1.0):
    assert_approx_eq(np.asarray(got), np.asarray(want), scale=size_scale(n) * kappa,
                     tol_dtype=dt)


def _rel(got, want):
    want = np.asarray(want, np.float64)
    return np.linalg.norm(np.asarray(got, np.float64) - want) / np.linalg.norm(want)


def _tol(n, dt):
    return size_scale(n) * float(np.finfo(dt).eps)


def _spd(n, rng):
    g = rng.standard_normal((n, n))
    return g @ g.T / n + np.eye(n)


def _sym(n, rng):
    g = rng.standard_normal((n, n))
    return (g + g.T) / 2


def _res(a, x, b):
    a = np.asarray(a, np.float64)
    return np.linalg.norm(a @ np.asarray(x, np.float64) - b) / (
        np.linalg.norm(a) * np.linalg.norm(np.asarray(x, np.float64)))


def _with_junk(a, rng):
    """Garbage above the diagonal: the factorizations read the lower triangle."""
    return a + np.triu(rng.standard_normal(a.shape), 1)


# -- LDLT ----------------------------------------------------------------------------

@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("n,block", [(50, None), (130, None), (300, 128)])
def test_ldlt_matches_jax(dt, n, block):
    rng = np.random.default_rng(n)
    a = _spd(n, rng).astype(dt)
    a_in = _with_junk(a, rng).astype(dt)
    params = LdltParams(block_size=block)
    ld_t, info_t = tchol.ldlt_factor(_t(a_in), params=params)
    ld_j, info_j = jchol.ldlt_factor(jnp.asarray(a_in),
                                     params=jchol.LdltParams(block_size=block))
    assert ld_t.dtype == torch.from_numpy(a).dtype and bool(info_t.success)
    assert int(info_t.dynamic_regularization_count) == int(info_j.dynamic_regularization_count)
    _close(ld_t.numpy(), ld_j, n, dt)
    assert _rel(tchol.ldlt_reconstruct(ld_t).numpy(), a) <= _tol(n, dt)
    b = rng.standard_normal((n, 3)).astype(dt)
    x = tchol.ldlt_solve(ld_t, _t(b)).numpy()
    _close(x, jchol.ldlt_solve(ld_j, jnp.asarray(b)), n, dt, np.linalg.cond(a))
    assert _res(a, x, b) <= _tol(n, dt)
    x1 = tchol.ldlt_solve(ld_t, _t(b[:, 0])).numpy()  # a 1-D right-hand side
    _close(x1, x[:, 0], n, dt, np.linalg.cond(a))


def test_ldlt_regularized_matches_jax():
    n = 80
    rng = np.random.default_rng(2)
    a = _spd(n, rng)
    bad = [3, 50]  # decoupled rows with a zero and a tiny negative pivot
    a[bad, :] = 0.0
    a[:, bad] = 0.0
    a[bad, bad] = [0.0, -1e-30]
    reg = LdltRegularization(epsilon=1e-4, delta=1e-12)
    ld_t, info_t = tchol.ldlt_factor(_t(a), reg=reg)
    ld_j, info_j = jchol.ldlt_factor(jnp.asarray(a),
                                     reg=jchol.LdltRegularization(epsilon=1e-4, delta=1e-12))
    assert int(info_t.dynamic_regularization_count) == int(info_j.dynamic_regularization_count) == 2
    _close(ld_t.numpy(), ld_j, n, np.float64)
    assert np.diag(ld_t.numpy())[bad].tolist() == [1e-4, -1e-4]


# -- pivoted LLT ----------------------------------------------------------------------

@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("n", [40, 130])
def test_piv_llt_full_rank_matches_jax(dt, n):
    rng = np.random.default_rng(n + 1)
    a = _spd(n, rng).astype(dt)
    l_t, p_t, r_t, info_t = tchol.piv_llt_factor(_t(_with_junk(a, rng).astype(dt)))
    l_j, p_j, r_j, info_j = jchol.piv_llt_factor(jnp.asarray(a))
    np.testing.assert_array_equal(p_t.numpy(), np.asarray(p_j))
    assert int(r_t) == int(r_j) == n and bool(info_t.success)
    _close(l_t.numpy(), l_j, n, dt)
    b = rng.standard_normal((n, 2)).astype(dt)
    x = tchol.piv_llt_solve(l_t, p_t, _t(b)).numpy()
    assert _res(a, x, b) <= _tol(n, dt)
    assert _rel(tchol.piv_llt_reconstruct(l_t, p_t).numpy(), a) <= _tol(n, dt)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("n", [48, 160])
def test_piv_llt_rank_deficient_matches_jax(dt, n):
    rng = np.random.default_rng(n + 2)
    k = n * 3 // 4
    h = rng.standard_normal((n, k))
    a = (h @ h.T / n).astype(dt)
    l_t, p_t, r_t, info_t = tchol.piv_llt_factor(_t(a))
    l_j, p_j, r_j, info_j = jchol.piv_llt_factor(jnp.asarray(a))
    assert int(r_t) == int(r_j) == k
    assert int(info_t.dynamic_regularization_count) == int(info_j.dynamic_regularization_count) == n - k
    assert not bool(info_t.success)
    # the live pivots agree; the dead ones are noise, and with them the order
    # of L's last rows: compare the rows by their index in A
    np.testing.assert_array_equal(p_t.numpy()[:k], np.asarray(p_j)[:k])
    inv_t, inv_j = np.argsort(p_t.numpy()), np.argsort(np.asarray(p_j))
    _close(l_t.numpy()[inv_t, :k], np.asarray(l_j)[inv_j, :k], n, dt)
    if n > 64:  # the blocked form zeroes a dead column
        assert not l_t.numpy()[:, k:].any()
    assert _rel(tchol.piv_llt_reconstruct(l_t, p_t).numpy(), a) <= _tol(n, dt)


# -- Bunch–Kaufman ------------------------------------------------------------------------

@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("n", [60, 150])
def test_lblt_matches_jax(dt, n):
    rng = np.random.default_rng(n + 3)
    a = _sym(n, rng).astype(dt)
    lb_t, sd_t, p_t, info_t = tchol.lblt_factor(_t(_with_junk(a, rng).astype(dt)))
    lb_j, sd_j, p_j, info_j = jchol.lblt_factor(jnp.asarray(a))
    assert (sd_t.numpy() != 0).sum() > 0  # 2×2 pivots present
    np.testing.assert_array_equal(p_t.numpy(), np.asarray(p_j))
    np.testing.assert_array_equal(sd_t.numpy() != 0, np.asarray(sd_j) != 0)
    assert int(info_t.transposition_count) == int(info_j.transposition_count)
    assert int(info_t.dynamic_regularization_count) == int(info_j.dynamic_regularization_count)
    kappa = np.linalg.cond(a.astype(np.float64))
    _close(lb_t.numpy(), lb_j, n, dt, kappa)
    _close(sd_t.numpy(), sd_j, n, dt, kappa)
    assert _rel(tchol.lblt_reconstruct(lb_t, sd_t, p_t).numpy(), a) <= _tol(n, dt)
    b = rng.standard_normal((n, 3)).astype(dt)
    x = tchol.lblt_solve(lb_t, sd_t, p_t, _t(b)).numpy()
    _close(x, jchol.lblt_solve(lb_j, sd_j, p_j, jnp.asarray(b)), n, dt, kappa)
    assert _res(a, x, b) <= _tol(n, dt)


def test_lblt_zero_pivot_counts():
    n = 120
    a = np.zeros((n, n))
    a[:60, :60] = _sym(60, np.random.default_rng(4))
    lb, sd, p, info = tchol.lblt_factor(_t(a))
    lb_j, sd_j, p_j, info_j = jchol.lblt_factor(jnp.asarray(a))
    assert int(info.dynamic_regularization_count) == int(info_j.dynamic_regularization_count) > 0
    assert np.isfinite(lb.numpy()).all()


# -- rank updates ----------------------------------------------------------------------

@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("r,alpha", [(1, 1.0), (3, 1.0), (3, -0.5)])
def test_rank_updates_match_jax(dt, r, alpha):
    n = 70
    rng = np.random.default_rng(r + 10)
    a = _spd(n, rng) + 2 * np.eye(n)
    w = (rng.standard_normal((n, r)) / np.sqrt(n)).astype(dt)
    if r == 1:
        w = w[:, 0]
    wm = w.reshape(n, -1).astype(np.float64)
    want = a + alpha * wm @ wm.T
    l = np.linalg.cholesky(a).astype(dt)
    l_t = tchol.llt_rank_r_update(_t(l), _t(w), alpha)
    l_j = jchol.llt_rank_r_update(jnp.asarray(l), jnp.asarray(w), alpha)
    _close(l_t.numpy(), l_j, n, dt, np.linalg.cond(a))
    assert _rel(tchol.llt_reconstruct(l_t).numpy(), want) <= _tol(n, dt)
    ld, _ = jchol.ldlt_factor(jnp.asarray(a.astype(dt)))
    ld = np.asarray(ld)
    d_t = tchol.ldlt_rank_r_update(_t(ld), _t(w), alpha)
    d_j = jchol.ldlt_rank_r_update(jnp.asarray(ld), jnp.asarray(w), alpha)
    _close(d_t.numpy(), d_j, n, dt, np.linalg.cond(a))
    assert _rel(tchol.ldlt_reconstruct(d_t).numpy(), want) <= _tol(n, dt)
    if r == 1:
        _close(tchol.llt_rank_1_update(_t(l), _t(w), alpha).numpy(), l_t.numpy(), n, dt)
        _close(tchol.ldlt_rank_1_update(_t(ld), _t(w), alpha).numpy(), d_t.numpy(), n, dt)


# -- full-pivot LU ------------------------------------------------------------------------

@pytest.mark.parametrize("dt,m,n", [(np.float32, 300, 300), (np.float64, 300, 300),
                                    (np.float64, 300, 130), (np.float32, 90, 280)])
def test_full_piv_lu_matches_jax(dt, m, n):
    rng = np.random.default_rng(m + n)
    a = rng.standard_normal((m, n)).astype(dt)
    lu_t, rp_t, cp_t, info_t = tlu.full_piv_lu_in_place(_t(a))
    lu_j, rp_j, cp_j, info_j = jlu.full_piv_lu_in_place(jnp.asarray(a))
    np.testing.assert_array_equal(rp_t.numpy(), np.asarray(rp_j))
    np.testing.assert_array_equal(cp_t.numpy(), np.asarray(cp_j))
    assert int(info_t.transposition_count) == int(info_j.transposition_count)
    assert bool(info_t.success)
    kappa = np.linalg.cond(a.astype(np.float64))
    _close(lu_t.numpy(), lu_j, max(m, n), dt, kappa)
    assert np.abs(np.tril(lu_t.numpy(), -1)).max() <= 1.0
    rec = tlu.full_piv_lu_reconstruct(lu_t, rp_t, cp_t).numpy()
    assert _rel(rec, a) <= _tol(max(m, n), dt)
    if m == n:
        b = rng.standard_normal((n, 2)).astype(dt)
        x = tlu.full_piv_lu_solve(lu_t, rp_t, cp_t, _t(b)).numpy()
        _close(x, jlu.full_piv_lu_solve(lu_j, rp_j, cp_j, jnp.asarray(b)), n, dt, kappa)
        assert _res(a, x, b) <= _tol(n, dt)


# -- column-pivoted QR -----------------------------------------------------------------

@pytest.mark.parametrize("dt,m,n", [(np.float64, 50, 40), (np.float32, 300, 60),
                                    (np.float32, 200, 150), (np.float64, 200, 150),
                                    (np.float64, 120, 200)])
def test_col_piv_qr_matches_jax(dt, m, n):
    rng = np.random.default_rng(m * n)
    a = rng.standard_normal((m, n)).astype(dt)
    pk_t, tau_t, p_t = tqr.col_piv_qr_in_place(_t(a))
    pk_j, tau_j, p_j = jqr.col_piv_qr_in_place(jnp.asarray(a))
    np.testing.assert_array_equal(p_t.numpy(), np.asarray(p_j))
    kappa = np.linalg.cond(a.astype(np.float64))
    _close(pk_t.numpy(), pk_j, max(m, n), dt, kappa)
    _close(tau_t.numpy(), tau_j, max(m, n), dt, kappa)
    r = np.abs(np.diag(pk_t.numpy()))
    assert (r[1:] <= r[:-1] * (1 + _tol(max(m, n), dt))).all()  # pivoted: |r_kk| falls
    rec = tqr.col_piv_qr_reconstruct(pk_t, tau_t, p_t).numpy()
    assert _rel(rec, a) <= _tol(max(m, n), dt)
    _close(tqr.col_piv_qr_t_stack(pk_t, tau_t, 32).numpy(),
           jqr.col_piv_qr_t_stack(pk_j, tau_j, 32), max(m, n), dt, kappa)
    if m >= n:
        b = rng.standard_normal((m, 2)).astype(dt)
        x = tqr.col_piv_qr_solve_lstsq(pk_t, tau_t, p_t, _t(b)).numpy()
        want = np.linalg.lstsq(a.astype(np.float64), b, rcond=None)[0]
        _close(x, want, m, dt, kappa ** 2)


# -- the facade objects ----------------------------------------------------------------

@pytest.mark.parametrize("dt", DTYPES)
def test_facade_objects_end_to_end(dt):
    rng = np.random.default_rng(21)
    n = 100
    spd, sym, g = (x.astype(dt) for x in (_spd(n, rng), _sym(n, rng),
                                          rng.standard_normal((n, n))))
    b = rng.standard_normal((n, 2)).astype(dt)
    tol = _tol(n, dt)
    mat = lambda x: tft.Mat(x, device=CPU)  # noqa: E731

    ldlt = mat(spd).ldlt()
    assert isinstance(ldlt, tft.Ldlt)
    assert _res(spd, ldlt.solve(_t(b)).numpy(), b) <= tol
    assert _rel(ldlt.reconstruct().numpy(), spd) <= tol
    assert _rel(ldlt.inverse().numpy() @ spd.astype(np.float64), np.eye(n)) <= tol * 10
    assert ldlt.determinant().item() > 0
    np.testing.assert_array_equal(ldlt.D.numpy(), np.diag(ldlt.ld.numpy()))
    w = rng.standard_normal((n, 2)).astype(dt) / np.sqrt(n)
    upd = spd.astype(np.float64) + w.astype(np.float64) @ w.T
    assert _rel(ldlt.rank_update(_t(w), 1.0).reconstruct().numpy(), upd) <= tol
    llt = mat(spd).llt()
    assert _rel(llt.rank_update(tft.Mat(w, device=CPU), 1.0).reconstruct().numpy(), upd) <= tol
    assert _rel(llt.rank_update(_t(w), 1.0).rank_update(_t(w), -1.0).reconstruct().numpy(),
                spd) <= tol

    piv = mat(spd).piv_llt()
    assert isinstance(piv, tft.PivLlt) and int(piv.rank) == n
    assert _res(spd, piv.solve(_t(b)).numpy(), b) <= tol
    assert _rel(piv.reconstruct().numpy(), spd) <= tol

    lblt = mat(sym).lblt()
    assert isinstance(lblt, tft.Lblt)
    assert _res(sym, lblt.solve(_t(b)).numpy(), b) <= tol
    assert _rel(lblt.reconstruct().numpy(), sym) <= tol
    upper = tft.Mat(sym.T.copy(), device=CPU).lblt(tft.Side.UPPER)
    np.testing.assert_array_equal(upper.perm.numpy(), lblt.perm.numpy())

    fp = mat(g).full_piv_lu()
    assert isinstance(fp, tft.FullPivLu)
    assert _res(g, fp.solve(_t(b)).numpy(), b) <= tol
    assert _rel(fp.reconstruct().numpy(), g) <= tol
    assert np.sign(fp.determinant().item()) == np.linalg.slogdet(g.astype(np.float64))[0]
    assert int(fp.rank()) == n
    low = g.astype(np.float64)[:, :60] @ rng.standard_normal((60, n))
    assert int(mat(low.astype(dt)).full_piv_lu().rank()) == 60

    cp = mat(g).col_piv_qr()
    assert isinstance(cp, tft.ColPivQr)
    assert _res(g, cp.solve(_t(b)).numpy(), b) <= tol
    assert _res(g, cp.solve_lstsq(_t(b)).numpy(), b) <= tol
    assert _rel(cp.reconstruct().numpy(), g) <= tol
    assert int(cp.rank()) == n
    assert int(mat(low.astype(dt)).col_piv_qr().rank()) == 60


@pytest.mark.parametrize("name", ["Ldlt", "PivLlt", "Lblt", "FullPivLu", "ColPivQr"])
def test_complex_input_names_item_10(name):
    """Item 10a took complex input: each of these objects factors a complex
    Hermitian positive definite matrix and solves with it within 8·n·eps
    (the complex general EVD, item 10b-i, and the generalized EVD, item
    10b-ii, run: the eigenvalues of I and of the pencil (I, I) are 1)."""
    rng = np.random.default_rng(10)
    g = rng.standard_normal((12, 12)) + 1j * rng.standard_normal((12, 12))
    a = (g @ g.conj().T / 12 + np.eye(12)).astype(np.complex64)
    b = rng.standard_normal((12, 2)).astype(np.complex64)
    obj = getattr(tsolvers, name).new(torch.from_numpy(a))
    x = obj.solve(torch.from_numpy(b)).numpy()
    a64, x64 = a.astype(np.complex128), x.astype(np.complex128)
    res = np.linalg.norm(a64 @ x64 - b) / (np.linalg.norm(a64) * np.linalg.norm(x64))
    assert x.dtype == np.complex64 and res <= 8 * 12 * np.finfo(np.float32).eps
    eye = torch.eye(4, dtype=torch.complex64)
    assert torch.equal(tsolvers.Eigen.new(eye).w, torch.ones(4, dtype=torch.complex64))
    assert torch.equal(tsolvers.GeneralizedEigen.new(eye, eye).eigenvalues,
                       torch.ones(4, dtype=torch.complex64))


def _jax_fields(obj):
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        out[f.name] = ({k.name: np.asarray(getattr(v, k.name)) for k in dataclasses.fields(v)}
                       if dataclasses.is_dataclass(v) else np.asarray(v))
    return out


@pytest.mark.parametrize("kind", ["Ldlt", "PivLlt", "Lblt", "FullPivLu", "ColPivQr"])
def test_interop_carries_the_new_objects(kind):
    rng = np.random.default_rng(7)
    n = 40
    a = {"Ldlt": _spd(n, rng), "PivLlt": _spd(n, rng), "Lblt": _sym(n, rng)}.get(
        kind, rng.standard_normal((n, n)))
    b = rng.standard_normal((n, 2))
    jobj = getattr(jsolvers, kind).new(jnp.asarray(a))
    tobj = interop.solver_from_numpy(kind, device=CPU, **_jax_fields(jobj))
    assert isinstance(tobj, getattr(tsolvers, kind))
    first = dataclasses.fields(tobj)[0].name
    assert getattr(tobj, first).dtype == torch.float64  # f64 stays f64
    _close(tobj.solve(_t(b)).numpy(), np.asarray(jobj.solve(jnp.asarray(b))), n,
           np.float64, np.linalg.cond(a))
    kind_back, fields = interop.solver_to_numpy(tobj)
    assert kind_back == kind
    for name, value in _jax_fields(jobj).items():
        if isinstance(value, dict):
            for k, v in value.items():
                np.testing.assert_array_equal(fields[name][k], v)
        else:
            np.testing.assert_array_equal(fields[name], value)
            assert fields[name].dtype == value.dtype


def test_dense_split_mode_exits_without_a_card_and_imports_no_jax():
    """``tools/torch_split.py dense`` refuses to run without a card, printing
    no result; loading it and the dense stack's modules loads neither JAX
    nor the JAX package."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = os.path.join(repo, "tools", "torch_split.py")
    env = dict(os.environ, PYTHONPATH=repo, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, path, "dense"], cwd=repo, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and "{" not in proc.stdout
    assert "CUDA card" in proc.stderr
    code = ("import sys, runpy, faer_tpu_torch.linalg.cholesky, faer_tpu_torch.linalg.lu, "
            "faer_tpu_torch.linalg.qr, faer_tpu_torch.linalg.solvers; "
            f"runpy.run_path({path!r}); "
            "bad = sorted(m for m in sys.modules if m in ('jax', 'faer_tpu') "
            "or m.startswith(('jax.', 'faer_tpu.'))); assert not bad, bad")
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
