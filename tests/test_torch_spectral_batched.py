"""The batched QR iteration (``ops/kernels/sweep.py``: ``tridiag_qr_batched``,
``bidiag_qr_batched`` and their plain versions) and the D&C leaf stage built
on it, against ``faer_tpu`` and f64 numpy.

On the CPU each wrapper runs its plain version: the drivers' per-problem
loops, one problem of the batch after another. Inputs are made with numpy
from a seed and handed to both packages; the JAX drivers run under
``jax.jit`` on the CPU (eagerly every loop recompiles per call).
Tolerances: faer's 8·n·eps_f32 rule (``utils/approx.py``), relative to the
largest eigen- or singular value for the values and to 1 for the
residuals and orthogonality of the vectors. The tridiagonal D&C at 1000
(``tests/test_torch_spectral_dnc_batched.py``) and the bidiagonal D&C at
300, square and wide (``tests/test_torch_bidiag_dnc_batched.py``), are
held against the JAX package in files of their own: each JAX D&C compile
takes 7–15 s on the CPU, and each file stays under 45 s on one process.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import faer_tpu.linalg.bidiag_dnc as jbd
import faer_tpu.linalg.bidiag_svd as jbs
import faer_tpu.linalg.tridiag_evd as jte
from faer_tpu_torch.core.config import KERNELS, host_reads, launch_counts, reset_launch_counts
from faer_tpu_torch.core.errors import ShapeError
from faer_tpu_torch.linalg import bidiag_dnc, tridiag_dnc
from faer_tpu_torch.linalg import bidiag_svd as tbs
from faer_tpu_torch.linalg import tridiag_evd as tte
from faer_tpu_torch.ops.kernels import sweep

torch.set_num_threads(1)

EPS32 = float(np.finfo(np.float32).eps)
SIZES = [2, 17, 40, 70]  # a ragged batch, nmax 70
SQRE = [1, 0, 1, 0]


def _t(x):
    return torch.from_numpy(np.array(x))  # a writable copy


def _close(got, want, n, scale):
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64)).max()
    assert err <= 8 * n * EPS32 * max(scale, 1e-30), err


def _tridiag(d, e):
    d, e = np.asarray(d, np.float64), np.asarray(e, np.float64)
    return np.diag(d) + np.diag(e, 1) + np.diag(e, -1)


def _bidiag(d, e, sqre=0):
    n = len(d)
    b = np.zeros((n, n + sqre))
    b[np.arange(n), np.arange(n)] = d
    k = n - 1 + sqre
    b[np.arange(k), np.arange(k) + 1] = e[:k]
    return b


def _batch(seed, nmax, e_cols):
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((len(SIZES), nmax)).astype(np.float32)
    e = rng.standard_normal((len(SIZES), e_cols)).astype(np.float32)
    return d, e


def _identity_past(x, k):
    """The vectors' matrix is the identity past its problem's k × k block."""
    eye = torch.eye(x.shape[0] - k)
    assert torch.equal(x[k:, k:], eye)
    assert not x[k:, :k].any() and not x[:k, k:].any()


# ---------------------------------------------------------------------------
# the batched plain versions, one problem at a time
# ---------------------------------------------------------------------------

def test_tridiag_qr_batched_matches_jax_and_f64():
    """A ragged batch (n 2…70) in one call: each problem's eigenvalues
    against f64 numpy and the JAX package's QR iteration, its vectors by
    residual and orthogonality; the padding untouched, Z the identity past
    each problem; no launch and no host read on the CPU."""
    nmax = max(SIZES)
    d0, e0 = _batch(1, nmax, nmax - 1)
    d, e = _t(d0), _t(e0)
    reset_launch_counts()
    z, its, conv, steps = sweep.tridiag_qr_batched(
        d, e, torch.tensor(SIZES, dtype=torch.int32))
    assert launch_counts() == dict.fromkeys(KERNELS, 0) and host_reads() == 0
    assert z.shape == (len(SIZES), nmax, nmax) and its.dtype == steps.dtype == torch.int32
    assert bool(conv.all()) and bool((steps > 0).all())
    for b, n in enumerate(SIZES):
        t = _tridiag(d0[b, :n], e0[b, :n - 1])
        w64 = np.linalg.eigvalsh(t)
        scale = max(np.abs(w64).max(), 1.0)
        wb = d[b, :n].numpy()
        _close(np.sort(wb), w64, n, scale)
        wj, _, infoj = jax.jit(jte.tridiag_evd)(jnp.asarray(d0[b, :n]),
                                                jnp.asarray(e0[b, :n - 1]))
        _close(np.sort(wb), wj, n, scale)
        assert bool(infoj.converged)
        zb = z[b, :n, :n].numpy().astype(np.float64)
        _close(t @ zb, zb * wb[None, :], n, scale)
        _close(zb.T @ zb, np.eye(n), n, 1.0)
        _identity_past(z[b], n)
        assert np.array_equal(d[b, n:].numpy(), d0[b, n:])
        assert np.array_equal(e[b, n - 1:].numpy(), e0[b, n - 1:])


def test_bidiag_qr_batched_matches_jax_and_f64():
    """A ragged batch (n 2…70) of square and wide (sqre 1) bidiagonals in one
    call: singular values against f64 numpy and the JAX package (its QR
    iteration for a square problem, its D&C leaf ``_leaf(d, e, 1)`` for a
    wide one), U diag(s) [I 0] Wᵀ = B and the vectors' orthogonality; W of a
    wide problem is (n+1) × (n+1); the identity past each problem."""
    nmax = max(SIZES)
    d0, e0 = _batch(2, nmax, nmax)
    d, e = _t(d0), _t(e0)
    reset_launch_counts()
    u, w, its, conv, steps = sweep.bidiag_qr_batched(
        d, e, torch.tensor(SIZES, dtype=torch.int32), torch.tensor(SQRE, dtype=torch.int32))
    assert launch_counts() == dict.fromkeys(KERNELS, 0) and host_reads() == 0
    assert u.shape == (len(SIZES), nmax, nmax) and w.shape == (len(SIZES), nmax + 1, nmax + 1)
    assert bool(conv.all())
    for b, (n, sq) in enumerate(zip(SIZES, SQRE)):
        bm = _bidiag(d0[b, :n], e0[b], sq)
        s64 = np.linalg.svd(bm, compute_uv=False)
        scale = max(s64[0], 1.0)
        sb = d[b, :n].numpy().astype(np.float64)  # unsigned, unsorted
        _close(np.sort(np.abs(sb))[::-1], s64, n, scale)
        dj, ej = jnp.asarray(d0[b, :n]), jnp.asarray(e0[b, :n - 1 + sq])
        sj = (jax.jit(jbd._leaf, static_argnums=2)(dj, ej, 1)[1] if sq
              else jax.jit(jbs.bidiag_svd)(dj, ej)[0])
        _close(np.sort(np.abs(sb))[::-1], sj, n, scale)
        ub = u[b, :n, :n].numpy().astype(np.float64)
        wb = w[b, :n + sq, :n + sq].numpy().astype(np.float64)
        sig = np.zeros((n, n + sq))
        sig[np.arange(n), np.arange(n)] = sb
        _close(ub @ sig @ wb.T, bm, n, scale)
        _close(ub.T @ ub, np.eye(n), n, 1.0)
        _close(wb.T @ wb, np.eye(n + sq), n, 1.0)
        _identity_past(u[b], n)
        _identity_past(w[b], n + sq)
        if sq:
            assert float(e[b, n - 1]) == 0.0  # the extra column is chased out


def test_tridiag_evd_dnc_at_300_matches_jax_and_f64():
    """The regrouped D&C (every leaf in one batched call, then the merges in
    the recursion's order) against the JAX package's D&C and f64 numpy."""
    rng = np.random.default_rng(300)
    n = 300
    d0 = rng.standard_normal(n).astype(np.float32)
    e0 = rng.standard_normal(n - 1).astype(np.float32)
    reset_launch_counts()
    w, z, info = tridiag_dnc.tridiag_evd_dnc(_t(d0), _t(e0))
    assert host_reads() == 0 and bool(info.converged) and int(info.iterations) > 0
    wj, _, _ = jax.jit(functools.partial(jte.tridiag_evd, use_dnc=True))(
        jnp.asarray(d0), jnp.asarray(e0))
    t = _tridiag(d0, e0)
    w64 = np.linalg.eigvalsh(t)
    scale = np.abs(w64).max()
    _close(w.numpy(), w64, n, scale)
    _close(w.numpy(), wj, n, scale)
    zn = z.numpy().astype(np.float64)
    _close(t @ zn, zn * w.numpy()[None, :], n, scale)
    _close(zn.T @ zn, np.eye(n), n, 1.0)


# ---------------------------------------------------------------------------
# the leaf inputs, formed up front
# ---------------------------------------------------------------------------

def _recursion_leaves(d, e, leaf=64):
    """The leaves ``tridiag_evd_dnc``'s recursion solved before this
    regrouping: halves, the tear's β taken off the two ends it joins."""
    n = d.shape[0]
    if n <= leaf:
        return [(d, e)]
    k = n // 2
    beta = e[k - 1]
    d1, d2 = d[:k].clone(), d[k:].clone()
    d1[k - 1] -= beta
    d2[0] -= beta
    return _recursion_leaves(d1, e[:k - 1], leaf) + _recursion_leaves(d2, e[k:], leaf)


@pytest.mark.parametrize("n", [130, 1000, 4000])
def test_tridiag_leaf_inputs_equal_the_recursions_to_the_bit(n):
    rng = np.random.default_rng(n)
    d = _t(rng.standard_normal(n).astype(np.float32))
    e = _t(rng.standard_normal(n - 1).astype(np.float32))
    dl, el, sizes = tridiag_dnc._leaf_inputs(d, e)
    want = _recursion_leaves(d, e)
    assert sizes.tolist() == [x.shape[0] for x, _ in want]
    for b, (wd, we) in enumerate(want):
        m = wd.shape[0]
        assert torch.equal(dl[b, :m], wd) and torch.equal(el[b, :m - 1], we)
        assert not dl[b, m:].any() and not el[b, m - 1:].any()
    assert set(sizes.tolist()) == ({62, 63} if n == 4000 else {x.shape[0] for x, _ in want})


def _recursion_bidiag_leaves(d, e, sqre, leaf=64):
    m = d.shape[0]
    if m <= leaf:
        return [(d, e, sqre)]
    k = m // 2
    return (_recursion_bidiag_leaves(d[:k], e[:k], 1, leaf)
            + _recursion_bidiag_leaves(d[k + 1:], e[k + 1:], sqre, leaf))


@pytest.mark.parametrize("m,sqre", [(300, 0), (300, 1), (4096, 0)])
def test_bidiag_leaf_inputs_equal_the_recursions_slices(m, sqre):
    rng = np.random.default_rng(m + sqre)
    d = _t(rng.standard_normal(m).astype(np.float32))
    e = _t(rng.standard_normal(m - 1 + sqre).astype(np.float32))
    dl, el, sizes, sqres = bidiag_dnc._leaf_inputs(d, e, sqre)
    want = _recursion_bidiag_leaves(d, e, sqre)
    assert sizes.tolist() == [x.shape[0] for x, _, _ in want]
    assert sqres.tolist() == [sq for _, _, sq in want]
    for b, (wd, we, sq) in enumerate(want):
        k = wd.shape[0]
        assert torch.equal(dl[b, :k], wd) and torch.equal(el[b, :k - 1 + sq], we)
        assert not dl[b, k:].any() and not el[b, k - 1 + sq:].any()


# ---------------------------------------------------------------------------
# max_iters, the chases, the wrappers
# ---------------------------------------------------------------------------

def test_max_iters_reports_not_converged():
    """At one iteration a row the QR iteration stops short: converged False
    and exactly max_iters = n iterations, through the drivers and the
    batched wrappers (max_sweeps_factor 0: no iteration at all)."""
    rng = np.random.default_rng(7)
    n = 40
    d = _t(rng.standard_normal(n).astype(np.float32))
    e = _t(rng.standard_normal(n - 1).astype(np.float32))
    _, _, info = tte.tridiag_evd(d, e, max_sweeps_factor=1)
    assert not bool(info.converged) and int(info.iterations) == n
    _, _, _, info = tbs.bidiag_svd(d, e, max_sweeps_factor=1)
    assert not bool(info.converged) and int(info.iterations) == n
    sizes = torch.tensor([n], dtype=torch.int32)
    d1, e1 = d.reshape(1, n).clone(), e.reshape(1, n - 1).clone()
    _, its, conv, steps = sweep.tridiag_qr_batched(d1, e1, sizes, max_sweeps_factor=0)
    assert int(its[0]) == int(steps[0]) == 0 and not bool(conv[0])
    assert torch.equal(d1[0], d) and torch.equal(e1[0], e)


def test_zero_diagonals_take_each_chase(monkeypatch):
    """One batch: a zero inside a block (row chase), a zero at a block's
    end (column chase), a wide problem with a zero diagonal (its extra
    column chased first); every singular value against f64 numpy."""
    calls = []
    for name in ("_row_chase", "_col_chase"):
        fn = getattr(sweep, name)
        monkeypatch.setattr(sweep, name, lambda *a, _f=fn, _n=name: (calls.append(_n), _f(*a)))
    rng = np.random.default_rng(8)
    n, sizes, sqre = 24, [24, 24, 24], [0, 0, 1]
    d0 = rng.standard_normal((3, n)).astype(np.float32)
    e0 = rng.standard_normal((3, n)).astype(np.float32)
    d0[0, 5] = d0[1, n - 1] = d0[2, 9] = 0.0
    d, e = _t(d0), _t(e0)
    u, w, _, conv, _ = sweep.bidiag_qr_batched(d, e, torch.tensor(sizes, dtype=torch.int32),
                                               torch.tensor(sqre, dtype=torch.int32))
    assert bool(conv.all())
    assert "_row_chase" in calls and "_col_chase" in calls
    for b, sq in enumerate(sqre):
        bm = _bidiag(d0[b], e0[b], sq)
        s64 = np.linalg.svd(bm, compute_uv=False)
        _close(np.sort(np.abs(d[b].numpy()))[::-1], s64, n, max(s64[0], 1.0))
        sig = np.zeros((n, n + sq))
        sig[np.arange(n), np.arange(n)] = d[b].numpy()
        ub, wb = u[b].numpy().astype(np.float64), w[b, :n + sq, :n + sq].numpy()
        _close(ub @ sig @ wb.T, bm, n, max(s64[0], 1.0))


@pytest.mark.parametrize("call", [
    lambda d, e, s, q: sweep.tridiag_qr_batched(d.double(), e[:, :-1], s),  # mixed dtypes
    lambda d, e, s, q: sweep.tridiag_qr_batched(d, e, s),  # e must be (B, nmax − 1)
    lambda d, e, s, q: sweep.tridiag_qr_batched(d, e[:, :-1], s.long()),
    lambda d, e, s, q: sweep.tridiag_qr_batched(d[0], e[0, :-1], s),
    lambda d, e, s, q: sweep.tridiag_qr_batched(d, e[:, :-1], s, max_sweeps_factor=-1),
    lambda d, e, s, q: sweep.bidiag_qr_batched(d, e[:, :-1], s, q),  # e must be (B, nmax)
    lambda d, e, s, q: sweep.bidiag_qr_batched(d, e, s, q[:1]),
    lambda d, e, s, q: sweep.bidiag_qr_batched(d[:, :0], e[:, :0], s, q),
    lambda d, e, s, q: sweep.bidiag_qr_batched(torch.zeros(2, 8193), torch.zeros(2, 8193),
                                               s, q),
    lambda d, e, s, q: sweep.bidiag_qr_batched(d.t().contiguous().t(), e, s, q),
])
def test_batched_wrappers_reject_bad_inputs(call):
    d, e = torch.ones(2, 8), torch.ones(2, 8)
    s, q = torch.tensor([8, 5], dtype=torch.int32), torch.zeros(2, dtype=torch.int32)
    with pytest.raises((TypeError, ValueError, ShapeError)):
        call(d, e, s, q)


def test_sizes_outside_the_batch_are_left_alone():
    """A size of 0 or past nmax is no problem of the batch: untouched, 0
    iterations, not converged; the others are solved as alone."""
    rng = np.random.default_rng(9)
    d0 = rng.standard_normal((3, 10)).astype(np.float32)
    e0 = rng.standard_normal((3, 9)).astype(np.float32)
    d, e = _t(d0), _t(e0)
    _, its, conv, _ = sweep.tridiag_qr_batched(d, e, torch.tensor([0, 10, 11], dtype=torch.int32))
    assert its.tolist()[0] == its.tolist()[2] == 0 and conv.tolist() == [False, True, False]
    assert np.array_equal(d[0].numpy(), d0[0]) and np.array_equal(d[2].numpy(), d0[2])
    alone = _t(d0[1:2])
    sweep.tridiag_qr_batched(alone, _t(e0[1:2]), torch.tensor([10], dtype=torch.int32))
    assert torch.equal(alone[0], d[1])
