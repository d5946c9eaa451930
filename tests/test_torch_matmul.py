"""The port's GEMM front door and its two tile kernels against ``faer_tpu``.

Inputs are made with numpy from a seed and fed to both packages (JAX on the
CPU). The front door is compared with ``faer_tpu.ops.matmul.matmul`` over
every option; the plain versions of ``tile_matmul`` and ``syrk_lower_sub``
(what the wrappers run for a CPU tensor) with ``pallas_matmul`` and
``syrk_lower_sub`` in Pallas interpret mode, in both f32 modes, with the JAX
``config.f32_precision`` set to match. Tolerances: faer's ``8·k·eps_f32``
(``utils/approx.py``); where the two sides compute the same exact bf16
products in another order, ``8·k·eps_f32`` relative to max‖a_i‖·max‖b_j‖.
"""
import importlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import faer_tpu.linalg.cholesky as jchol
import faer_tpu.linalg.lu as jlu
import faer_tpu.linalg.qr as jqr
from faer_tpu.core import flags as jflags
from faer_tpu_torch.core import flags as tflags
from faer_tpu_torch.core.config import KERNELS, config, launch_counts, reset_launch_counts
from faer_tpu_torch.linalg import cholesky as tchol
from faer_tpu_torch.linalg import lu as tlu
from faer_tpu_torch.linalg import qr as tqr
from faer_tpu_torch.ops import matmul as tmm
from faer_tpu_torch.ops.kernels.matmul import tile_matmul, tile_matmul_plain
from faer_tpu_torch.ops.kernels.syrk import syrk_lower_sub, syrk_lower_sub_plain
from faer_tpu_torch.utils.approx import assert_approx_eq, size_scale

# the package re-exports a function under the module's name
jmm = importlib.import_module("faer_tpu.ops.matmul")

torch.set_num_threads(1)

EPS32 = float(np.finfo(np.float32).eps)


def _mats(rng, *shapes):
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.fixture
def tile_on(monkeypatch):
    monkeypatch.setattr(config, "use_tile_matmul", True)


@pytest.fixture
def jax_precision(monkeypatch):
    """Set the JAX package's f32 precision (read by the Pallas kernels at
    trace time) for one test."""
    from faer_tpu.core.config import config as jconfig

    def set_(p):
        monkeypatch.setattr(jconfig, "f32_precision", p)
    return set_


@pytest.fixture
def interp(monkeypatch):
    """Route the two GEMM-shaped Pallas kernels through the interpreter, as
    tests/test_pallas_kernels.py does, and drop their cached traces."""
    from jax.experimental import pallas as pl

    import faer_tpu.ops.pallas.matmul_kernel as mk
    import faer_tpu.ops.pallas.syrk_kernel as sk

    orig = pl.pallas_call

    def interp_call(*args, **kwargs):
        kwargs["interpret"] = True
        kwargs.pop("compiler_params", None)
        return orig(*args, **kwargs)

    for mod in (mk, sk):
        monkeypatch.setattr(mod.pl, "pallas_call", interp_call)
    mk._mm_padded.clear_cache()
    sk._syrk_padded.clear_cache()
    yield mk, sk
    mk._mm_padded.clear_cache()
    sk._syrk_padded.clear_cache()


def _row_col_scale(a, b):
    """max_i ‖a_i‖₂ · max_j ‖b_j‖₂ (a bound on (|A||B|)_ij)."""
    return float(np.linalg.norm(a, axis=1).max() * np.linalg.norm(b, axis=0).max())


# -- the front door -----------------------------------------------------------

@pytest.mark.parametrize("precision", [None, "highest"])
@pytest.mark.parametrize("transpose", [(False, False), (True, False), (False, True),
                                       (True, True)])
@pytest.mark.parametrize("conj", [(jflags.Conj.NO, tflags.Conj.NO),
                                  (jflags.Conj.YES, tflags.Conj.YES)])
@pytest.mark.parametrize("accum,alpha", [("REPLACE", 1.0), ("ADD", 1.0), ("ADD", -0.5),
                                         ("REPLACE", 2)])
def test_front_door_matches_jax(precision, transpose, conj, accum, alpha):
    m, k, n = 20, 30, 12
    rng = np.random.default_rng(m + int(transpose[0]) + 2 * int(transpose[1]))
    a, b, c = _mats(rng, (m, k), (k, n), (m, n))
    a = a.T.copy() if transpose[0] else a
    b = b.T.copy() if transpose[1] else b
    kw = dict(alpha=alpha, conj_lhs=conj[0], conj_rhs=conj[0],
              transpose_lhs=transpose[0], transpose_rhs=transpose[1])
    want = jmm.matmul(jnp.asarray(c), jnp.asarray(a), jnp.asarray(b),
                      accum=getattr(jflags.Accum, accum),
                      precision=jax.lax.Precision.HIGHEST if precision else None, **kw)
    kw.update(conj_lhs=conj[1], conj_rhs=conj[1])
    got = tmm.matmul(_t(c), _t(a), _t(b), accum=getattr(tflags.Accum, accum),
                     precision=precision, **kw)
    assert got.dtype == torch.float32 and tuple(got.shape) == (m, n)
    assert_approx_eq(got.numpy(), np.asarray(want), scale=size_scale(k),
                     tol_dtype=np.float32)


def test_front_door_batched_and_accum_errors():
    rng = np.random.default_rng(1)
    # a stack of left operands against one right operand (the JAX front
    # door contracts the last axis of lhs with the second-to-last of rhs)
    a, b = _mats(rng, (3, 10, 7), (7, 5))
    got = tmm.matmul(None, _t(a), _t(b))
    want = jmm.matmul(None, jnp.asarray(a), jnp.asarray(b))
    assert_approx_eq(got.numpy(), np.asarray(want), scale=size_scale(7),
                     tol_dtype=np.float32)
    with pytest.raises(ValueError):
        tmm.matmul(None, _t(a), _t(b), accum=tflags.Accum.ADD)
    with pytest.raises(ValueError):
        tmm.matmul(None, _t(a), _t(b), precision="high")


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("vec", [True, False])
def test_matvec_matches_jax(transpose, vec):
    rng = np.random.default_rng(3)
    a, x = _mats(rng, (25, 25), (25,) if vec else (25, 4))
    got = tmm.matvec(_t(a), _t(x), transpose_a=transpose)
    want = jmm.matvec(jnp.asarray(a), jnp.asarray(x), transpose_a=transpose)
    assert_approx_eq(got.numpy(), np.asarray(want), scale=size_scale(25),
                     tol_dtype=np.float32)


@pytest.mark.parametrize("accum,alpha", [("ADD", 1.0), ("ADD", 0.25), ("REPLACE", -1.0)])
def test_rank_update_matches_jax(accum, alpha):
    rng = np.random.default_rng(4)
    c, u, v = _mats(rng, (9, 6), (9,), (6,))
    got = tmm.rank_update(_t(c), _t(u), _t(v), alpha=alpha,
                          accum=getattr(tflags.Accum, accum))
    want = jmm.rank_update(jnp.asarray(c), jnp.asarray(u), jnp.asarray(v), alpha=alpha,
                           accum=getattr(jflags.Accum, accum))
    assert_approx_eq(got.numpy(), np.asarray(want), scale=8.0, tol_dtype=np.float32)


def test_norm_flag_matches_jax():
    assert {m.name: m.value for m in tflags.Norm} == {m.name: m.value for m in jflags.Norm}


@pytest.mark.parametrize("precision", [None, "highest"])
def test_dispatch_rule(tile_on, monkeypatch, precision):
    """With the switch on, exactly the 2-D same-dtype f32/bf16 products above
    128³ and without a pinned precision take ``tile_matmul``."""
    calls = []
    monkeypatch.setattr(tmm, "tile_matmul", lambda a, b: calls.append(a.shape) or a @ b)
    big = (torch.ones(160, 130), torch.ones(130, 120))  # 2.5e6 > 128³
    small = (torch.ones(100, 100), torch.ones(100, 100))  # 1e6
    for a, b in (big, small, (big[0][None], big[1][None]),
                 (big[0].double(), big[1].double()),
                 (big[0].bfloat16(), big[1].bfloat16())):
        tmm.matmul(None, a, b, precision=precision)
    assert calls == ([] if precision else [(160, 130), (160, 130)])
    monkeypatch.setattr(config, "use_tile_matmul", False)
    tmm.matmul(None, *big)
    assert len(calls) == (0 if precision else 2)


def test_switch_reads_the_jax_variable(monkeypatch):
    monkeypatch.setattr(config, "use_tile_matmul", None)
    monkeypatch.delenv("FAER_TPU_USE_PALLAS", raising=False)
    assert not config.tile_matmul_enabled()
    for value, want in (("1", True), ("0", False), ("", False), ("true", True)):
        monkeypatch.setenv("FAER_TPU_USE_PALLAS", value)
        assert config.tile_matmul_enabled() is want
    monkeypatch.setattr(config, "f32_precision", "fast")
    with pytest.raises(ValueError):
        tile_matmul_plain(torch.ones(2, 2), torch.ones(2, 2))


# -- the kernels' plain versions against the Pallas kernels --------------------

@pytest.mark.parametrize("precision", ["highest", "high"])
@pytest.mark.parametrize("shape", [(256, 128, 256), (300, 200, 260)])
def test_tile_matmul_plain_matches_pallas(interp, jax_precision, monkeypatch,
                                          precision, shape):
    mk, _ = interp
    jax_precision(precision)
    monkeypatch.setattr(config, "f32_precision", precision)
    m, k, n = shape
    rng = np.random.default_rng(m + n)
    a, b = _mats(rng, (m, k), (k, n))
    got = tile_matmul_plain(_t(a), _t(b)).numpy()
    want = np.asarray(mk.pallas_matmul(jnp.asarray(a), jnp.asarray(b), bm=128,
                                       bn=128, bk=128))
    # the same products (exact in f32 for the bf16 split), summed in another order
    assert np.abs(got - want).max() <= 8 * k * EPS32 * _row_col_scale(a, b)
    assert_approx_eq(got, a.astype(np.float64) @ b, scale=size_scale(k) * 8,
                     tol_dtype=np.float32)
    # the CPU wrapper runs the plain version and launches nothing
    reset_launch_counts()
    assert torch.equal(tile_matmul(_t(a), _t(b)), tile_matmul_plain(_t(a), _t(b)))
    assert launch_counts() == dict.fromkeys(KERNELS, 0)


def test_tile_matmul_plain_bf16_matches_pallas(interp):
    mk, _ = interp
    m, k, n = 256, 128, 160
    rng = np.random.default_rng(9)
    a, b = _mats(rng, (m, k), (k, n))
    ab, bb = jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16)
    want = np.asarray(mk.pallas_matmul(ab, bb, bm=128, bn=128, bk=128), np.float32)
    tb = _t(a).bfloat16(), _t(b).bfloat16()
    got = tile_matmul_plain(*tb)
    assert got.dtype == torch.bfloat16
    scale = _row_col_scale(tb[0].float().numpy(), tb[1].float().numpy())
    # f32 sums of exact products, each side rounded once to bf16
    assert np.abs(got.float().numpy() - want).max() <= (8 * k * EPS32 + 2 ** -8) * scale
    got32 = tile_matmul_plain(*tb, out_dtype=torch.float32).numpy()
    exact = tb[0].double().numpy() @ tb[1].double().numpy()
    assert np.abs(got32 - exact).max() <= 8 * k * EPS32 * scale


def test_high_split_is_exact_products():
    """Each of the three split products is exact in f32: bf16 operands
    carry 8 significant bits, so their products carry at most 16."""
    from faer_tpu_torch.ops.kernels.matmul import split_bf16

    rng = np.random.default_rng(5)
    x = _t(rng.standard_normal(1000).astype(np.float32))
    hi, lo = split_bf16(x)
    assert torch.equal(hi, hi.bfloat16().float()) and torch.equal(lo, lo.bfloat16().float())
    assert ((x - hi - lo).abs() <= 2.0 ** -16 * x.abs()).all()
    assert torch.equal((hi * lo).double(), hi.double() * lo.double())


@pytest.mark.parametrize("precision", ["highest", "high"])
@pytest.mark.parametrize("m,k", [(256, 128), (300, 200)])
def test_syrk_lower_sub_plain_matches_pallas(interp, jax_precision, monkeypatch,
                                             precision, m, k):
    _, sk = interp
    jax_precision(precision)
    monkeypatch.setattr(config, "f32_precision", precision)
    rng = np.random.default_rng(m + k)
    c, a = _mats(rng, (m, m), (m, k))
    got = syrk_lower_sub_plain(_t(c), _t(a)).numpy()
    want = np.asarray(sk.syrk_lower_sub(jnp.asarray(c), jnp.asarray(a), bm=128, bk=128))
    scale = float(np.linalg.norm(a, axis=1).max() ** 2)
    assert np.abs(np.tril(got) - np.tril(want)).max() <= 8 * k * EPS32 * scale
    want64 = c.astype(np.float64) - a.astype(np.float64) @ a.T
    assert_approx_eq(np.tril(got), np.tril(want64), scale=size_scale(k) * 8,
                     tol_dtype=np.float32)
    np.testing.assert_array_equal(np.triu(got, 1), np.triu(c, 1))
    assert torch.equal(syrk_lower_sub(_t(c), _t(a)), syrk_lower_sub_plain(_t(c), _t(a)))


@pytest.mark.parametrize("call", [
    lambda: tile_matmul(torch.ones(3, 4), torch.ones(5, 2)),
    lambda: tile_matmul(torch.ones(3, 4, dtype=torch.float64), torch.ones(4, 2)),
    lambda: tile_matmul(torch.ones(3, 4), torch.ones(4, 2).bfloat16()),
    lambda: tile_matmul(torch.ones(2, 3, 4), torch.ones(4, 2)),
    lambda: tile_matmul(torch.ones(3, 4), torch.ones(4, 2), out_dtype=torch.float64),
    lambda: syrk_lower_sub(torch.ones(3, 4), torch.ones(3, 2)),
    lambda: syrk_lower_sub(torch.ones(3, 3), torch.ones(4, 2)),
    lambda: syrk_lower_sub(torch.ones(3, 3).bfloat16(), torch.ones(3, 2)),
])
def test_tile_wrappers_reject_bad_inputs(call):
    with pytest.raises((TypeError, ValueError)):
        call()


# -- dispatch through the factorizations --------------------------------------

# products the JAX package pins to HIGHEST are made by these functions, or
# are U12 solves (``u12 = …``); none of them may take the tile kernel
_PINNED_FUNCS = {"_mm_hi", "invert_lower_triangular", "invert_upper_triangular"}


def _recorder(monkeypatch):
    sites = []
    real = tmm.tile_matmul

    def record(a, b):
        frame = sys._getframe(2)  # the front door's caller
        import linecache

        line = linecache.getline(frame.f_code.co_filename, frame.f_lineno).strip()
        sites.append((frame.f_code.co_name, line))
        return real(a, b)

    monkeypatch.setattr(tmm, "tile_matmul", record)
    return sites


def test_factorizations_route_through_tile_matmul(tile_on, monkeypatch):
    """At n = 512 with the switch on, the LLT, LU and QR factors and the two
    solves send some products to ``tile_matmul``, none from a site the JAX
    package pins; the results match ``faer_tpu`` and f64 as with the switch
    off."""
    n = 512
    rng = np.random.default_rng(0)
    g = rng.standard_normal((n, n))
    spd = (g @ g.T / n + np.eye(n)).astype(np.float32)
    g = g.astype(np.float32)
    b = rng.standard_normal((n, 64)).astype(np.float32)
    sites = _recorder(monkeypatch)
    per_call = {}

    def run(name, fn):
        start = len(sites)
        out = fn()
        per_call[name] = sites[start:]
        return out

    l, info = run("llt_factor", lambda: tchol.llt_factor(_t(spd)))
    lu, perm, linfo = run("lu_in_place", lambda: tlu.lu_in_place(_t(g)))
    packed, ts, block = run("qr_in_place", lambda: tqr.qr_in_place(_t(g)))
    x1 = run("llt_solve", lambda: tchol.llt_solve(l, _t(b)))
    x2 = run("lu_solve", lambda: tlu.lu_solve(lu, perm, _t(b)))
    for name, calls in per_call.items():
        assert calls, f"{name} sent no product to tile_matmul"
        for func, line in calls:
            assert func not in _PINNED_FUNCS and "highest" not in line \
                and not line.startswith("u12"), (name, func, line)
    assert bool(info.success) and bool(linfo.success)
    tol = size_scale(n) * EPS32
    a64, g64 = spd.astype(np.float64), g.astype(np.float64)
    l_j, _ = jchol.llt_factor(jnp.asarray(spd))
    assert_approx_eq(l.numpy(), np.asarray(l_j), scale=size_scale(n), tol_dtype=np.float32)
    assert np.linalg.norm(_lu_rebuild(lu, perm) - g64) / np.linalg.norm(g64) <= tol
    qr_j = jqr.qr_in_place(jnp.asarray(g))
    x3 = tqr.qr_solve_lstsq(packed, ts, block, _t(b)).numpy()
    x3_j = np.asarray(jqr.qr_solve_lstsq(*qr_j, jnp.asarray(b)))
    for x, mat in ((x1.numpy(), a64), (x2.numpy(), g64), (x3, g64), (x3_j, g64)):
        res = np.linalg.norm(mat @ x - b) / (np.linalg.norm(mat) * np.linalg.norm(x))
        assert res <= tol
    x2_j = np.asarray(jlu.lu_solve(*jlu.lu_in_place(jnp.asarray(g))[:2], jnp.asarray(b)))
    kappa = np.linalg.cond(g64)
    assert np.linalg.norm(x2.numpy() - x2_j) / np.linalg.norm(x2_j) <= tol * kappa


def _lu_rebuild(lu, perm):
    """A from the packed LU, in f64."""
    lu64 = lu.double().numpy()
    n = lu64.shape[0]
    a = (np.tril(lu64, -1) + np.eye(n)) @ np.triu(lu64)
    out = np.empty_like(a)
    out[perm.numpy()] = a
    return out
