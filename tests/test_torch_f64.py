"""The port's float64 route and the kernel-layer pieces of the dense stack
against ``faer_tpu`` (JAX on the CPU, ``jax_enable_x64``) and f64 numpy.

The dtype picks the route in both packages: float64 takes the JAX
package's non-kernel bodies (``_inv_lower_base`` and the recursive
combine, ``_panel_llt``, ``_panel_lu``, ``_panel_qr``), which the port
follows in plain PyTorch, at the same leaf and panel widths. Inputs are
made with numpy from a seed. Tolerances: faer's rule 8·n·eps of the dtype
(``utils/approx.py``), elementwise between the packages and normwise
(times the condition number for a forward error) against numpy.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import faer_tpu
import faer_tpu.utils.flops
import faer_tpu.core.config as jconfig
import faer_tpu.core.errors as jerrors
import faer_tpu.core.flags as jflags
import faer_tpu.core.params as jparams
import faer_tpu.core.perm as jperm
import faer_tpu.linalg.cholesky as jchol
import faer_tpu.linalg.lu as jlu
import faer_tpu.linalg.qr as jqr
import faer_tpu.ops.householder as jhh
import faer_tpu.ops.triangular as jtri
import faer_tpu.ops.triangular_solve as jts
import faer_tpu_torch as tft
from faer_tpu_torch.core import config as tconfig
from faer_tpu_torch.core import dtypes as tdtypes
from faer_tpu_torch.core import errors as terrors
from faer_tpu_torch.core import flags as tflags
from faer_tpu_torch.core import params as tparams
from faer_tpu_torch.core import perm as tperm
from faer_tpu_torch.linalg import cholesky as tchol
from faer_tpu_torch.linalg import lu as tlu
from faer_tpu_torch.linalg import qr as tqr
from faer_tpu_torch.ops import householder as thh
from faer_tpu_torch.ops import triangular as ttri
from faer_tpu_torch.ops import triangular_solve as tts
from faer_tpu_torch.utils import flops as tflops
from faer_tpu_torch.utils.approx import assert_approx_eq, size_scale

torch.set_num_threads(1)

EPS64 = float(np.finfo(np.float64).eps)
CPU = "cpu"


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _close(got, want, n, dtype=np.float64, kappa=1.0):
    assert_approx_eq(np.asarray(got), np.asarray(want), scale=size_scale(n) * kappa,
                     tol_dtype=dtype)


def _spd(n, rng):
    g = rng.standard_normal((n, n))
    return g @ g.T / n + np.eye(n)


def _lower(n, unit, rng):
    """A well-conditioned lower triangle with junk above the diagonal."""
    lo = np.tril(rng.standard_normal((n, n)) / np.sqrt(n), -1)
    lo += np.diag(1.0 + rng.uniform(size=n))
    return lo + np.triu(rng.standard_normal((n, n)), 1)


# -- item 1: the dtype policy --------------------------------------------------------

def test_dtype_policy():
    for dt in (torch.float32, torch.float64):
        tdtypes.require_real(torch.zeros(2, 2, dtype=dt), "x")
    assert tdtypes.kernel_route(torch.float32)
    assert not tdtypes.kernel_route(torch.float64)
    # complex: the factorizations (item 10a), the general EVD (item 10b-i)
    # and the generalized EVD (item 10b-ii) take it; only the real QZ's own
    # helpers refuse it, naming qz as the route for a complex pencil
    for dt in (torch.complex64, torch.complex128):
        with pytest.raises(NotImplementedError, match="takes qz"):
            tdtypes.require_real(torch.zeros(2, 2, dtype=dt), "x")
        tdtypes.require_field(torch.zeros(2, 2, dtype=dt), "x")
        assert not tdtypes.kernel_route(dt)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tdtypes.require_field(torch.zeros(2, 2, dtype=torch.bfloat16), "x")
    l, info = tchol.llt_factor(torch.eye(4, dtype=torch.complex128))
    assert bool(info.success) and torch.equal(l, torch.eye(4, dtype=torch.complex128))
    eye = tft.Mat(torch.eye(4, dtype=torch.complex64))
    assert torch.equal(eye.eigen().eigenvalues, torch.ones(4, dtype=torch.complex64))
    assert torch.equal(eye.generalized_eigen(eye).eigenvalues,
                       torch.ones(4, dtype=torch.complex64))


# -- item 2: errors, params, flags, permutations ------------------------------------

def test_errors_params_and_flags_match_jax():
    for name in ("FaerError", "NonPositivePivotError", "NoConvergenceError",
                 "SingularMatrixError", "ShapeError"):
        assert issubclass(getattr(terrors, name), terrors.FaerError)
        assert getattr(tft, name) is getattr(terrors, name)
        assert hasattr(jerrors, name)
    for name in ("LdltInfo", "LbltInfo", "LltInfo", "LuInfo"):
        fields = [f.name for f in dataclasses.fields(getattr(terrors, name))]
        assert fields == [f.name for f in dataclasses.fields(getattr(jerrors, name))]
    for name in ("LdltParams", "LdltRegularization", "LbltParams", "FullPivLuParams",
                 "ColPivQrParams", "LltParams", "PartialPivLuParams"):
        t, j = getattr(tparams, name)(), getattr(jparams, name)()
        assert dataclasses.asdict(t) == dataclasses.asdict(j), name
    for dt, jdt in ((torch.float32, jnp.float32), (torch.float64, jnp.float64)):
        assert dataclasses.asdict(tparams.LdltRegularization.auto(dt)) == \
            dataclasses.asdict(jparams.LdltRegularization.auto(jdt))
        assert tparams.auto(tparams.LdltParams, dt) == tparams.LdltParams()
    for name in ("Accum", "Conj", "Side", "Norm", "Par", "BlockStructure", "NanHandling"):
        want = {m.name: m.value for m in getattr(jflags, name)}
        assert {m.name: m.value for m in getattr(tflags, name)} == want
    for b in jflags.BlockStructure:
        tb = tflags.BlockStructure[b.name]
        assert tb.transpose.name == b.transpose.name
        for prop in ("is_lower", "is_upper", "is_strict", "is_unit"):
            assert getattr(tb, prop) == getattr(b, prop)
    assert tflags.Conj.NO.flip is tflags.Conj.YES
    assert tconfig.get_global_parallelism() is tflags.Par.AUTO
    tft.set_global_parallelism(tflags.Par.SEQ)
    assert tft.get_global_parallelism() is tflags.Par.SEQ
    tft.set_global_parallelism(tflags.Par.AUTO)
    assert jconfig.get_global_parallelism() is not None
    assert tflops.ldlt_flops(4096) == faer_tpu.utils.flops.ldlt_flops(4096)


def test_package_exports_match_jax():
    missing = [n for n in faer_tpu.__all__ if n not in tft.__all__]
    assert not missing
    for n in tft.__all__:
        assert hasattr(tft, n), n


def test_perm_helpers_match_jax():
    rng = np.random.default_rng(5)
    n = 11
    p = rng.permutation(n)
    a = rng.standard_normal((n, n))
    pt, pj = _t(p), jnp.asarray(p, jnp.int32)
    np.testing.assert_array_equal(tperm.identity_perm(n).numpy(), np.asarray(jperm.identity_perm(n)))
    for name in ("permute_rows", "permute_cols", "permute_rows_inverse",
                 "permute_cols_inverse"):
        np.testing.assert_array_equal(getattr(tperm, name)(_t(a), pt).numpy(),
                                      np.asarray(getattr(jperm, name)(jnp.asarray(a), pj)))
    for i, j in ((2, 7), (4, 4), (0, torch.tensor(9))):
        jj = int(j)
        np.testing.assert_array_equal(tperm.swap_rows(_t(a), i, j).numpy(),
                                      np.asarray(jperm.swap_rows(jnp.asarray(a), i, jj)))
        np.testing.assert_array_equal(tperm.swap_cols(_t(a), i, j).numpy(),
                                      np.asarray(jperm.swap_cols(jnp.asarray(a), i, jj)))
    np.testing.assert_array_equal(tperm.perm_to_matrix(pt, torch.float64).numpy(),
                                  np.asarray(jperm.perm_to_matrix(pj, jnp.float64)))
    swaps = np.array([3, 1, 5, 3, 9, 5, 6, 10, 8, 9, 10])
    np.testing.assert_array_equal(
        tperm.swaps_to_perm(_t(swaps)).numpy(),
        np.asarray(jperm.swaps_to_perm(jnp.asarray(swaps, jnp.int32))))


# -- item 3: the triangular inverse and structured products --------------------------

@pytest.mark.parametrize("n,unit,base", [(20, False, None), (32, True, None),
                                         (33, False, None), (100, True, None),
                                         (129, False, 128), (300, False, None),
                                         (256, True, 256)])
def test_invert_lower_triangular_f64_matches_jax(n, unit, base):
    rng = np.random.default_rng(n)
    t = _lower(n, unit, rng)
    got = ttri.invert_lower_triangular(_t(t), unit=unit, base=base)
    want = jtri.invert_lower_triangular(jnp.asarray(t), unit=unit, base=base)
    assert got.dtype == torch.float64
    _close(got.numpy(), want, n)
    lo = np.tril(t, -1) + (np.eye(n) if unit else np.diag(np.diag(t)))
    _close(got.numpy(), np.linalg.inv(lo), n, kappa=np.linalg.cond(lo))
    up = ttri.invert_upper_triangular(_t(t.T.copy()), unit=unit, base=base)
    _close(up.numpy(), np.asarray(want).T, n)


def test_invert_unit_triangular_and_diagonal_blocks():
    rng = np.random.default_rng(2)
    n = 300
    t = _lower(n, True, rng)
    _close(ttri.invert_unit_lower_triangular(_t(t)).numpy(),
           jtri.invert_unit_lower_triangular(jnp.asarray(t)), n)
    _close(ttri.invert_unit_upper_triangular(_t(t.T.copy())).numpy(),
           jtri.invert_unit_upper_triangular(jnp.asarray(t.T)), n)
    blocks = [(0, 128), (128, 128), (256, 44)]
    inv = ttri.invert_diagonal_blocks_generic(_t(t), blocks, unit=False)
    assert tuple(inv.shape) == (3, 128, 128)
    for k, (o, s) in enumerate(blocks):
        want = jtri.invert_lower_triangular(jnp.asarray(t[o:o + s, o:o + s]))
        _close(inv[k, :s, :s].numpy(), want, s)
        assert not inv[k, s:].any() and not inv[k, :, s:].any()


@pytest.mark.parametrize("dst,lhs,rhs", [
    ("RECTANGULAR", "TRIANGULAR_LOWER", "RECTANGULAR"),
    ("TRIANGULAR_UPPER", "UNIT_TRIANGULAR_UPPER", "TRIANGULAR_LOWER"),
    ("STRICT_TRIANGULAR_LOWER", "STRICT_TRIANGULAR_UPPER", "UNIT_TRIANGULAR_LOWER"),
])
def test_structured_products_match_jax(dst, lhs, rhs):
    rng = np.random.default_rng(9)
    a, b, c = (rng.standard_normal((12, 12)) for _ in range(3))
    tb, jb = tflags.BlockStructure, jflags.BlockStructure
    for s in (lhs, rhs):
        np.testing.assert_array_equal(ttri.apply_structure(_t(a), tb[s]).numpy(),
                                      np.asarray(jtri.apply_structure(jnp.asarray(a), jb[s])))
    got = ttri.triangular_matmul(_t(c), _t(a), _t(b), dst_structure=tb[dst],
                                 lhs_structure=tb[lhs], rhs_structure=tb[rhs],
                                 alpha=0.5, accum=tflags.Accum.ADD)
    want = jtri.triangular_matmul(jnp.asarray(c), jnp.asarray(a), jnp.asarray(b),
                                  dst_structure=jb[dst], lhs_structure=jb[lhs],
                                  rhs_structure=jb[rhs], alpha=0.5,
                                  accum=jflags.Accum.ADD)
    _close(got.numpy(), want, 12)
    assert ttri.structure_mask(3, 3, tb.RECTANGULAR, torch.float64) is None


# -- item 4: triangular solves -------------------------------------------------------

_SOLVES = ["solve_lower_triangular", "solve_upper_triangular",
           "solve_lower_triangular_transpose", "solve_upper_triangular_transpose",
           "solve_lower_triangular_on_right", "solve_upper_triangular_on_right"]


@pytest.mark.parametrize("name", _SOLVES)
@pytest.mark.parametrize("n,unit", [(100, False), (300, True)])
def test_triangular_solves_f64_match_jax(name, n, unit):
    rng = np.random.default_rng(n)
    t = _lower(n, unit, rng)
    if "upper" in name:
        t = t.T.copy()
    b = rng.standard_normal((5, n) if "right" in name else (n, 5))
    got = getattr(tts, name)(_t(t), _t(b), unit=unit)
    want = getattr(jts, name)(jnp.asarray(t), jnp.asarray(b), unit=unit)
    assert got.dtype == torch.float64
    _close(got.numpy(), want, n)


def test_right_solves_f32():
    rng = np.random.default_rng(4)
    n = 200
    t = _lower(n, False, rng).astype(np.float32)
    b = rng.standard_normal((3, n)).astype(np.float32)
    lo = np.tril(t.astype(np.float64))
    x = tts.solve_lower_triangular_on_right(_t(t), _t(b)).numpy()
    _close(x, b.astype(np.float64) @ np.linalg.inv(lo), n, np.float32, np.linalg.cond(lo))
    x = tts.solve_upper_triangular_on_right(_t(t.T.copy()), _t(b)).numpy()
    _close(x, b.astype(np.float64) @ np.linalg.inv(lo.T), n, np.float32, np.linalg.cond(lo))


# -- item 5: Householder in f64 ------------------------------------------------------

def test_form_block_t_and_applies_f64_match_jax():
    rng = np.random.default_rng(8)
    m, b = 90, 40
    packed, taus = jqr._panel_qr(jnp.asarray(rng.standard_normal((m, b))))
    v = np.tril(np.asarray(packed), -1) + np.eye(m, b)
    taus = np.asarray(taus)
    t_t = thh.form_block_t(_t(v), _t(taus))
    t_j = jhh.form_block_t(jnp.asarray(v), jnp.asarray(taus))
    _close(t_t.numpy(), t_j, m)
    c = rng.standard_normal((m, 7))
    for adjoint in (False, True):
        _close(thh.apply_block_on_left(_t(v), t_t, _t(c), adjoint=adjoint).numpy(),
               jhh.apply_block_on_left(jnp.asarray(v), t_j, jnp.asarray(c), adjoint=adjoint), m)


# -- item 6: the f64 LLT --------------------------------------------------------------

@pytest.mark.parametrize("n,block", [(50, None), (130, None), (520, 256)])
def test_llt_f64_matches_jax(n, block):
    rng = np.random.default_rng(n)
    a = _spd(n, rng)
    a_junk = a + np.triu(rng.standard_normal((n, n)), 1)  # only the lower triangle is read
    tp = tparams.LltParams(block_size=block)
    jp = jparams.LltParams(block_size=block)
    l_t, info_t = tchol.llt_factor(_t(a_junk), params=tp)
    l_j, info_j = jchol.llt_factor(jnp.asarray(a_junk), params=jp)
    assert l_t.dtype == torch.float64 and bool(info_t.success)
    assert int(info_t.dynamic_regularization_count) == int(info_j.dynamic_regularization_count) == 0
    _close(l_t.numpy(), l_j, n)
    _close(l_t.numpy(), np.linalg.cholesky(a), n)
    b = rng.standard_normal((n, 4))
    x = tchol.llt_solve(l_t, _t(b)).numpy()
    _close(x, np.asarray(jchol.llt_solve(l_j, jnp.asarray(b))), n)
    _close(x, np.linalg.solve(a, b), n, kappa=np.linalg.cond(a))
    _close(tchol.llt_inverse(l_t).numpy(), np.linalg.inv(a), n, kappa=np.linalg.cond(a))


def test_llt_f64_regularized_matches_jax():
    n = 70
    rng = np.random.default_rng(1)
    a = _spd(n, rng)
    bad = [5, 40, 66]  # decoupled rows whose pivots are not positive
    a[bad, :] = 0.0
    a[:, bad] = 0.0
    a[bad, bad] = [-1.0, 0.0, 1e-20]
    reg_t = tparams.LltRegularization(epsilon=1e-3, delta=1e-10)
    reg_j = jparams.LltRegularization(epsilon=1e-3, delta=1e-10)
    l_t, info_t = tchol.llt_factor(_t(a), reg=reg_t)
    l_j, info_j = jchol.llt_factor(jnp.asarray(a), reg=reg_j)
    assert int(info_t.dynamic_regularization_count) == int(info_j.dynamic_regularization_count) == 3
    assert bool(info_t.success) == bool(info_j.success)
    _close(l_t.numpy(), l_j, n)


# -- items 11 and 12: the f64 LU and QR -----------------------------------------------

@pytest.mark.parametrize("m,n,block", [(200, 200, None), (300, 130, None),
                                       (90, 300, None), (520, 520, 256)])
def test_lu_f64_matches_jax(m, n, block):
    rng = np.random.default_rng(m + n)
    a = rng.standard_normal((m, n))
    lu_t, p_t, info_t = tlu.lu_in_place(_t(a), tparams.PartialPivLuParams(block_size=block))
    lu_j, p_j, info_j = jlu.lu_in_place(jnp.asarray(a), jparams.PartialPivLuParams(block_size=block))
    assert lu_t.dtype == torch.float64 and bool(info_t.success)
    np.testing.assert_array_equal(p_t.numpy(), np.asarray(p_j))
    assert int(info_t.transposition_count) == int(info_j.transposition_count)
    # a forward error: the two packages round their products in other orders
    _close(lu_t.numpy(), lu_j, max(m, n), kappa=np.linalg.cond(a))
    _close(tlu.lu_reconstruct(lu_t, p_t).numpy(), a, max(m, n))
    if m == n:
        b = rng.standard_normal((n, 3))
        kappa = np.linalg.cond(a)
        _close(tlu.lu_solve(lu_t, p_t, _t(b)).numpy(), np.linalg.solve(a, b), n, kappa=kappa)
        _close(tlu.lu_solve_transpose(lu_t, p_t, _t(b)).numpy(), np.linalg.solve(a.T, b), n,
               kappa=kappa)
        sign, _ = np.linalg.slogdet(a)
        det = tlu.lu_determinant(lu_t, p_t, info_t.transposition_count).item()
        assert np.sign(det) == sign


@pytest.mark.parametrize("m,n", [(200, 200), (300, 130), (130, 300), (520, 520)])
def test_qr_f64_matches_jax(m, n):
    rng = np.random.default_rng(m * n)
    a = rng.standard_normal((m, n))
    pk_t, ts_t, blk = tqr.qr_in_place(_t(a))
    pk_j, ts_j, blk_j = jqr.qr_in_place(jnp.asarray(a))
    assert blk == blk_j and pk_t.dtype == torch.float64
    _close(pk_t.numpy(), pk_j, max(m, n))
    _close(ts_t.numpy(), ts_j, max(m, n))
    _close(tqr.qr_reconstruct(pk_t, ts_t, blk).numpy(), a, max(m, n))
    if m >= n:
        b = rng.standard_normal((m, 3))
        want = np.linalg.lstsq(a, b, rcond=None)[0]
        kappa = np.linalg.cond(a)
        _close(tqr.qr_solve_lstsq(pk_t, ts_t, blk, _t(b)).numpy(), want, m, kappa=kappa ** 2)


# -- the facade in f64, and the route ---------------------------------------------------

def test_facade_f64_end_to_end():
    rng = np.random.default_rng(12)
    n = 150
    a, g = _spd(n, rng), rng.standard_normal((n, n))
    b = rng.standard_normal((n, 2))
    llt = tft.Mat(a, device=CPU).llt()
    assert llt.l.dtype == torch.float64
    _close(llt.solve(_t(b)).numpy(), np.linalg.solve(a, b), n, kappa=np.linalg.cond(a))
    _close(llt.reconstruct().numpy(), a, n)
    lu = tft.Mat(g, device=CPU).partial_piv_lu()
    _close(lu.solve(_t(b)).numpy(), np.linalg.solve(g, b), n, kappa=np.linalg.cond(g))
    assert np.sign(lu.determinant().item()) == np.linalg.slogdet(g)[0]
    qr = tft.Mat(g, device=CPU).qr()
    _close(qr.solve_lstsq(_t(b)).numpy(), np.linalg.solve(g, b), n, kappa=np.linalg.cond(g))
    _close(tft.Mat(g, device=CPU).inverse().a.numpy(), np.linalg.inv(g), n,
           kappa=np.linalg.cond(g))


_KERNEL_WRAPPERS = [
    ("faer_tpu_torch.ops.triangular", ("trtri", "trtri_batched")),
    ("faer_tpu_torch.ops.triangular_solve", ("trtri_batched",)),
    ("faer_tpu_torch.linalg.cholesky", ("llt_leaf", "llt_panel")),
    ("faer_tpu_torch.linalg.lu", ("lu_leaf", "lu_panel", "lu_panel_v2", "lu_panel_v2_batched")),
    ("faer_tpu_torch.linalg.qr", ("qr_panel",)),
]


def _forbid_kernels(monkeypatch, calls):
    import importlib

    for mod, names in _KERNEL_WRAPPERS:
        m = importlib.import_module(mod)
        for name in names:
            real = getattr(m, name)

            def spy(*args, _real=real, _name=name, **kw):
                calls.append(_name)
                return _real(*args, **kw)

            monkeypatch.setattr(m, name, spy)


def test_f64_takes_no_kernel_wrapper(monkeypatch):
    """float64 runs the non-kernel bodies by its dtype: no kernel wrapper is
    called (a CUDA tensor would launch there), and every counter stays 0;
    the same calls in float32 go through the wrappers."""
    rng = np.random.default_rng(3)
    n = 260
    a, g = _spd(n, rng), rng.standard_normal((n, n))
    b = rng.standard_normal((n, 2))

    def run(dt):
        at, gt, bt = (_t(x).to(dt) for x in (a, g, b))
        l, _ = tchol.llt_factor(at)
        tchol.llt_solve(l, bt)
        ld, _ = tchol.ldlt_factor(at)
        tchol.ldlt_solve(ld, bt)
        tchol.llt_rank_r_update(l, bt, 1.0)
        lu, p, _ = tlu.lu_in_place(gt)
        tlu.lu_solve(lu, p, bt)
        pk, ts, blk = tqr.qr_in_place(gt)
        tqr.qr_solve_lstsq(pk, ts, blk, bt)
        f = tlu.full_piv_lu_in_place(gt[:70, :70])
        tlu.full_piv_lu_solve(f[0], f[1], f[2], bt[:70])
        c = tqr.col_piv_qr_in_place(gt[:, :100])
        tqr.col_piv_qr_solve_lstsq(*c, bt)
        lb = tchol.lblt_factor(at + at.mT)
        tchol.lblt_solve(*lb[:3], bt)
        pl = tchol.piv_llt_factor(at)
        tchol.piv_llt_solve(pl[0], pl[1], bt)

    calls = []
    _forbid_kernels(monkeypatch, calls)
    tconfig.reset_launch_counts()
    run(torch.float64)
    assert calls == []
    assert tconfig.launch_counts() == dict.fromkeys(tconfig.KERNELS, 0)
    run(torch.float32)
    assert {"trtri", "trtri_batched", "llt_leaf", "lu_leaf", "qr_panel"} <= set(calls)
