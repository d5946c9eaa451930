"""The port's self-adjoint EVD and SVD against ``faer_tpu`` and f64 numpy.

Inputs are made with numpy from a seed and handed to both packages. The JAX
side runs as its own tests run it: on the CPU, with x64 enabled by
``tests/conftest.py``, through its XLA-scan sweeps (and, for the kernel
twins, the Pallas sweep kernels in interpret mode). The port side runs the
plain versions of its sweep kernels. Tolerances: faer's 8·n·eps_f32 rule
relative to the largest eigenvalue or singular value (``utils/approx.py``);
the kernel twins use the 2e-5 and 2e-4 of ``tests/test_pallas_kernels.py``.
Vectors are compared through the residual and the orthogonality, and
column by column up to sign where the spectrum is separated.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import faer_tpu.linalg.bidiag as jbd
import faer_tpu.linalg.bidiag_svd as jbs
import faer_tpu.linalg.evd as jevd
import faer_tpu.linalg.svd as jsvd
import faer_tpu.linalg.tridiag as jtr
import faer_tpu.linalg.tridiag_evd as jte
from faer_tpu.core import errors as jerrors
from faer_tpu.core import params as jparams
import faer_tpu_torch as ft
from faer_tpu_torch import interop
from faer_tpu_torch.core import errors as terrors
from faer_tpu_torch.core import params as tparams
from faer_tpu_torch.core.config import (
    KERNELS, host_reads, launch_counts, reset_launch_counts)
from faer_tpu_torch.linalg import bidiag as tbd
from faer_tpu_torch.linalg import bidiag_svd as tbs
from faer_tpu_torch.linalg import tridiag as ttr
from faer_tpu_torch.linalg import tridiag_evd as tte
from faer_tpu_torch.ops.kernels import sweep

torch.set_num_threads(1)

EPS32 = float(np.finfo(np.float32).eps)


def _t(x):
    return torch.from_numpy(np.array(x))  # a writable copy


def _tridiag(d, e):
    d, e = np.asarray(d, np.float64), np.asarray(e, np.float64)
    return np.diag(d) + np.diag(e, 1) + np.diag(e, -1)


def _bidiag(d, e):
    return np.diag(np.asarray(d, np.float64)) + np.diag(np.asarray(e, np.float64), 1)


def _close(got, want, n, ref_scale):
    """faer's 8·n·eps_f32 rule, relative to ``ref_scale``."""
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64)).max()
    assert err <= 8 * n * EPS32 * max(ref_scale, 1e-30), err


def _same_columns_up_to_sign(z1, z2, w, scale):
    """Columns of separated eigenvalues (gap > 1e-2·scale) agree up to sign,
    within 8·n·eps·scale/gap."""
    z1, z2 = np.asarray(z1, np.float64), np.asarray(z2, np.float64)
    n = len(w)
    for j in range(n):
        gaps = np.abs(np.delete(w, j) - w[j])
        gap = gaps.min() if n > 1 else scale
        if gap <= 1e-2 * scale:
            continue
        sgn = np.sign(z1[:, j] @ z2[:, j]) or 1.0
        assert np.abs(z1[:, j] - sgn * z2[:, j]).max() <= 8 * n * EPS32 * scale / gap


# ---------------------------------------------------------------------------
# the sweep kernels' plain versions against the Pallas kernels
# ---------------------------------------------------------------------------

@pytest.fixture
def interp(monkeypatch):
    """Route pallas_call through the interpreter (as the ``_interp`` helper
    of tests/test_pallas_kernels.py does) and drop cached traces."""
    from jax.experimental import pallas as pl

    import faer_tpu.ops.pallas.panel_kernels as pk

    orig = pl.pallas_call

    def interp_call(*args, **kwargs):
        kwargs["interpret"] = True
        kwargs.pop("compiler_params", None)
        return orig(*args, **kwargs)

    monkeypatch.setattr(pk.pl, "pallas_call", interp_call)
    fns = (pk.tridiag_sweep_pallas, pk.bidiag_sweep_pallas)
    for fn in fns:
        fn.clear_cache()
    yield pk
    for fn in fns:
        fn.clear_cache()


def _sweep_args(d, e, l, m, mu):
    lm = np.array([l, m], np.int32)
    j = (jnp.asarray(d), jnp.asarray(e), jnp.asarray(l, jnp.int32),
         jnp.asarray(m, jnp.int32), jnp.asarray(mu, jnp.float32))
    t = (_t(d), _t(e), _t(lm), _t(np.array([mu], np.float32)))
    return j, t


def test_tridiag_sweep_plain_matches_pallas(interp):
    """The inputs of tests/test_pallas_kernels.py: n = 32, (l, m) = (2, 20)."""
    rng = np.random.default_rng(3)
    n = 32
    d = rng.standard_normal(n).astype(np.float32)
    e = rng.standard_normal(n - 1).astype(np.float32)
    l, m = 2, 20
    delta = (d[m - 1] - d[m]) / 2
    sq = np.sqrt(delta * delta + e[m - 1] ** 2)
    mu = d[m] - e[m - 1] ** 2 / (delta + np.sign(delta or 1) * sq)
    j, t = _sweep_args(d, e, l, m, mu)
    want = interp.tridiag_sweep_pallas(*j)
    got = sweep.tridiag_sweep_plain(*t)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5)
    # identity rotations outside [l, m)
    c, s = got[2].numpy(), got[3].numpy()
    assert (c[:l] == 1).all() and (c[m:] == 1).all()
    assert (s[:l] == 0).all() and (s[m:] == 0).all()


def test_bidiag_sweep_plain_matches_pallas(interp):
    """The inputs of tests/test_pallas_kernels.py: n = 24, (l, m) = (1, 18)."""
    rng = np.random.default_rng(4)
    n = 24
    d = (rng.standard_normal(n) + 2).astype(np.float32)
    e = rng.standard_normal(n - 1).astype(np.float32)
    l, m = 1, 18
    em2 = e[m - 2] if m >= 2 else np.float32(0)
    t11 = d[m - 1] ** 2 + em2 ** 2
    t22 = d[m] ** 2 + e[m - 1] ** 2
    t12 = d[m - 1] * e[m - 1]
    delta = (t11 - t22) / 2
    sq = np.sqrt(delta * delta + t12 ** 2)
    mu = t22 - t12 ** 2 / (delta + np.sign(delta or 1) * sq)
    j, t = _sweep_args(d, e, l, m, mu)
    want = interp.bidiag_sweep_pallas(*j)
    got = sweep.bidiag_sweep_plain(*t)
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-4)


def test_sweep_wrappers_on_cpu_take_the_plain_version_and_count_nothing():
    rng = np.random.default_rng(5)
    d = _t(rng.standard_normal(40).astype(np.float32))
    e = _t(rng.standard_normal(39).astype(np.float32))
    lm = torch.tensor([3, 30], dtype=torch.int32)
    mu = torch.tensor([0.25])
    reset_launch_counts()
    for kern, plain in ((sweep.tridiag_sweep, sweep.tridiag_sweep_plain),
                        (sweep.bidiag_sweep, sweep.bidiag_sweep_plain)):
        for got, want in zip(kern(d, e, lm, mu), plain(d, e, lm, mu)):
            assert torch.equal(got, want)
    # an empty block (l ≥ m), or one outside [0, n−1], is the identity sweep
    for l, m in ((7, 7), (9, 4), (-1, 5), (3, 40)):
        lm_bad = torch.tensor([l, m], dtype=torch.int32)
        for kern in (sweep.tridiag_sweep, sweep.bidiag_sweep):
            got = kern(d, e, lm_bad, mu)
            assert torch.equal(got[0], d) and torch.equal(got[1], e)
            for r, ident in zip(got[2:], (1.0, 0.0) * 2):
                assert bool((r == ident).all())
    assert launch_counts() == dict.fromkeys(KERNELS, 0)
    assert host_reads() == 0


@pytest.mark.parametrize("call", [
    lambda d, e, lm, mu: sweep.tridiag_sweep(d.double(), e.double(), lm, mu),
    lambda d, e, lm, mu: sweep.tridiag_sweep(d, e, lm.long(), mu),
    lambda d, e, lm, mu: sweep.bidiag_sweep(d, e[:-1], lm, mu),
    lambda d, e, lm, mu: sweep.bidiag_sweep(d[:1], e[:0], lm, mu),
    lambda d, e, lm, mu: sweep.bidiag_sweep(d, e, lm, torch.zeros(2)),
])
def test_sweep_wrappers_reject_bad_inputs(call):
    d, e = torch.ones(8), torch.ones(7)
    lm, mu = torch.tensor([0, 7], dtype=torch.int32), torch.zeros(1)
    with pytest.raises((TypeError, ValueError)):
        call(d, e, lm, mu)


# ---------------------------------------------------------------------------
# the closed-form rotation chain
# ---------------------------------------------------------------------------

def _rotations(n, rng):
    theta = rng.uniform(-1, 1, n - 1).astype(np.float32)
    c, s = np.cos(theta), np.sin(theta)
    c[7], s[7] = 1.0, 0.0  # an identity rotation inside a chunk
    return c, s


def test_apply_rotation_chain_matches_sequential_and_jax():
    """n = 50, chunk 8, as tests/test_pallas_kernels.py checks the JAX one."""
    rng = np.random.default_rng(5)
    n = 50
    z = rng.standard_normal((n, n)).astype(np.float32)
    c, s = _rotations(n, rng)
    got = sweep._apply_rotation_chain(_t(z), _t(c), _t(s), chunk=8).numpy()
    ref = z.astype(np.float64)
    for i in range(n - 1):
        zi, zi1 = ref[:, i].copy(), ref[:, i + 1].copy()
        ref[:, i] = c[i] * zi + s[i] * zi1
        ref[:, i + 1] = -s[i] * zi + c[i] * zi1
    np.testing.assert_allclose(got, ref, atol=2e-5)
    want = np.asarray(jte._apply_rotation_chain(jnp.asarray(z), jnp.asarray(c),
                                                jnp.asarray(s), chunk=8))
    np.testing.assert_allclose(got, want, atol=2e-5)
    # a column slice with a rotation count that is not a chunk multiple
    sub = sweep._apply_rotation_chain(_t(z[:, 3:20]), _t(c[3:19]), _t(s[3:19]),
                                      chunk=8).numpy()
    assert sub.shape == (n, 17)


def test_apply_rotation_chain_rows_matches_the_descending_loop():
    """The D&C merges' ``undefl`` loop: rows (j, j+1) rotated for j
    descending, here in f64 as the merges run it."""
    rng = np.random.default_rng(6)
    n = 50
    u = rng.standard_normal((n, 9))
    c, s = _rotations(n, rng)
    got = tte._apply_rotation_chain_rows(_t(u), _t(c), _t(s), chunk=8).numpy()
    ref = u.copy()
    for j in range(n - 2, -1, -1):
        top, bot = ref[j].copy(), ref[j + 1].copy()
        ref[j] = c[j] * top - s[j] * bot
        ref[j + 1] = s[j] * top + c[j] * bot
    np.testing.assert_allclose(got, ref, atol=1e-13)


# ---------------------------------------------------------------------------
# reductions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [40, 300])  # unblocked; one 128-panel + unblocked
def test_tridiag_in_place_matches_jax(n):
    rng = np.random.default_rng(n)
    g = rng.standard_normal((n, n))
    a = ((g + g.T) / 2).astype(np.float32)
    d, e, hh, taus = ttr.tridiag_in_place(_t(a))
    out_j = jtr.tridiag_in_place(jnp.asarray(a))
    scale = np.abs(a).sum(axis=0).max()  # ‖A‖₁ bounds |d|, |e|
    _close(d.numpy(), out_j[0], n, scale)
    _close(e.numpy(), out_j[1], n, scale)
    # Q T Qᵀ = A, Q orthogonal (the reflectors themselves are not compared:
    # late ones carry the rounding of the whole reduction)
    q = ttr.tridiag_apply_q(hh, taus, torch.eye(n)).numpy().astype(np.float64)
    t = _tridiag(d.numpy(), e.numpy())
    _close(q @ t @ q.T, a, n, scale)
    _close(q.T @ q, np.eye(n), n, 1.0)
    # tridiag_apply_q on the JAX package's reflectors, carried over by interop
    dj, ej, hhj, tausj = interop.tridiag_from_numpy(*(np.asarray(x) for x in out_j),
                                                    device="cpu")
    assert dj.dtype == hhj.dtype == torch.float32
    b = rng.standard_normal((n, 3)).astype(np.float32)
    _close(ttr.tridiag_apply_q(hhj, tausj, _t(b)).numpy(),
           np.asarray(jtr.tridiag_apply_q(out_j[2], out_j[3], jnp.asarray(b))), n,
           np.abs(b).max())
    # and back: port tensors -> numpy -> port tensors unchanged
    back = interop.tridiag_from_numpy(*interop.tridiag_to_numpy(d, e, hh, taus),
                                      device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(back, (d, e, hh, taus)))


@pytest.mark.parametrize("m,n", [(40, 25), (300, 280)])
def test_bidiag_in_place_matches_jax(m, n):
    rng = np.random.default_rng(m + n)
    a = rng.standard_normal((m, n)).astype(np.float32)
    d, e, vl, taul, vr, taur = tbd.bidiag_in_place(_t(a))
    dj, ej, vlj, taulj, vrj, taurj = jbd.bidiag_in_place(jnp.asarray(a))
    scale = np.linalg.norm(a, 2)
    for got, want in ((d, dj), (e, ej)):
        _close(got.numpy(), want, m, scale)
    assert tuple(vl.shape) == vlj.shape and tuple(vr.shape) == vrj.shape
    # U B Vᵀ = A through the apply functions
    u = tbd.bidiag_apply_ql(vl, taul, torch.eye(m, n)).numpy().astype(np.float64)
    v = tbd.bidiag_apply_qr_mat(vr, taur, torch.eye(n)).numpy().astype(np.float64)
    _close(u @ _bidiag(d.numpy(), e.numpy()) @ v.T, a, m, scale)
    _close(u.T @ u, np.eye(n), m, 1.0)
    _close(v.T @ v, np.eye(n), m, 1.0)
    # the apply functions on the JAX package's reflectors
    b = rng.standard_normal((m, 2)).astype(np.float32)
    _close(tbd.bidiag_apply_ql(_t(np.asarray(vlj)), _t(np.asarray(taulj)), _t(b)).numpy(),
           np.asarray(jbd.bidiag_apply_ql(vlj, taulj, jnp.asarray(b))), m,
           np.abs(b).max())
    _close(tbd.bidiag_apply_qr_mat(_t(np.asarray(vrj)), _t(np.asarray(taurj)),
                                   _t(b[:n])).numpy(),
           np.asarray(jbd.bidiag_apply_qr_mat(vrj, taurj, jnp.asarray(b[:n]))), m,
           np.abs(b).max())


# ---------------------------------------------------------------------------
# tridiagonal EVD: QR iteration and divide & conquer
# ---------------------------------------------------------------------------

def _glued_wilkinson(blocks=6):
    """Glued Wilkinson W21 blocks (tests/test_tridiag_dnc.py), 6 of them
    (n = 126): tight clusters of equal eigenvalues."""
    w21 = np.abs(np.arange(-10, 11)).astype(np.float32)
    d = np.concatenate([w21] * blocks)
    e = np.concatenate(sum(([np.ones(20)] + ([np.array([1e-12])] if b < blocks - 1 else [])
                            for b in range(blocks)), [])).astype(np.float32)
    return d, e


def _clustered_poles(n=130):
    """d = 1, tiny off-diagonals (tests/test_tridiag_dnc.py): all poles equal."""
    rng = np.random.default_rng(2)
    return np.ones(n, np.float32), (rng.standard_normal(n - 1) * 1e-8).astype(np.float32)


def _random_tridiag(n):
    rng = np.random.default_rng(10 + n)
    return (rng.standard_normal(n).astype(np.float32),
            rng.standard_normal(max(n - 1, 0)).astype(np.float32))


@pytest.mark.parametrize("case", ["1", "2", "16", "40", "130-dnc", "glued-wilkinson",
                                  "clustered-poles"])
def test_tridiag_evd_matches_jax_and_f64(case):
    if case == "glued-wilkinson":
        d, e = _glued_wilkinson()
    elif case == "clustered-poles":
        d, e = _clustered_poles()
    else:
        d, e = _random_tridiag(int(case.split("-")[0]))
    n = d.shape[0]
    use_dnc = True if n > 64 else None  # the D&C cases take it at n < 512
    reset_launch_counts()
    w, z, info = tte.tridiag_evd(_t(d), _t(e), use_dnc=use_dnc)
    # jit: the JAX drivers compile once instead of per eager loop
    wj, zj, infoj = jax.jit(functools.partial(jte.tridiag_evd, use_dnc=use_dnc))(
        jnp.asarray(d), jnp.asarray(e))
    t = _tridiag(d, e)
    w64 = np.linalg.eigvalsh(t)
    scale = max(np.abs(w64).max(), 1.0)
    _close(w.numpy(), w64, n, scale)
    _close(w.numpy(), wj, n, scale)
    assert bool(info.converged) and bool(infoj.converged)
    zn = z.numpy().astype(np.float64)
    _close(t @ zn, zn * w.numpy()[None, :], n, scale)
    _close(zn.T @ zn, np.eye(n), n, 1.0)
    if case in ("16", "40", "130-dnc"):
        _same_columns_up_to_sign(zn, zj, w64, scale)
    if n > 1 and use_dnc is None:
        # the QR route runs its whole iteration in the batched kernel (its
        # plain version here): no host read, however many iterations
        assert int(info.iterations) > 0
    assert host_reads() == 0
    assert launch_counts() == dict.fromkeys(KERNELS, 0)


def test_tridiag_evd_eigenvalues_only():
    d, e = _random_tridiag(130)
    w, z, _ = tte.tridiag_evd(_t(d), _t(e), want_vectors=False, use_dnc=True)
    assert z is None
    _close(w.numpy(), np.linalg.eigvalsh(_tridiag(d, e)), 130,
           np.abs(w.numpy()).max())


# ---------------------------------------------------------------------------
# bidiagonal SVD: QR iteration, chases and divide & conquer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["1", "2", "16", "40", "130-dnc", "zero-inside",
                                  "zero-last"])
def test_bidiag_svd_matches_jax_and_f64(case, monkeypatch):
    n = 16 if case.startswith("zero") else int(case.split("-")[0])
    rng = np.random.default_rng(20 + n)
    d = rng.standard_normal(n).astype(np.float32)
    e = rng.standard_normal(n - 1).astype(np.float32)
    if case == "zero-inside":
        d[5] = 0.0  # row chase
    if case == "zero-last":
        d[-1] = 0.0  # column chase
    use_dnc = True if n > 64 else None
    chases = []  # the chases of the batched kernel's plain version
    for name in ("_row_chase", "_col_chase"):
        fn = getattr(sweep, name)
        monkeypatch.setattr(sweep, name, lambda *a, _f=fn, _n=name: (chases.append(_n), _f(*a)))
    s, u, v, info = tbs.bidiag_svd(_t(d), _t(e), use_dnc=use_dnc)
    # a zero inside a block splits it with a row chase (after which it ends
    # the upper block: a column chase); a zero at the end, a column chase
    assert chases[:1] == {"zero-inside": ["_row_chase"],
                          "zero-last": ["_col_chase"]}.get(case, [])
    sj, uj, vj, infoj = jax.jit(functools.partial(jbs.bidiag_svd, use_dnc=use_dnc))(
        jnp.asarray(d), jnp.asarray(e))
    b = _bidiag(d, e)
    s64 = np.linalg.svd(b, compute_uv=False)
    scale = max(s64[0], 1.0)
    _close(s.numpy(), s64, n, scale)
    _close(s.numpy(), sj, n, scale)
    assert bool(info.converged) and bool(infoj.converged)
    assert (np.diff(s.numpy()) <= 0).all() and (s.numpy() >= 0).all()
    un, vn = u.numpy().astype(np.float64), v.numpy().astype(np.float64)
    _close(un * s.numpy()[None, :] @ vn.T, b, n, scale)
    _close(un.T @ un, np.eye(n), n, 1.0)
    _close(vn.T @ vn, np.eye(n), n, 1.0)
    if case.startswith("zero"):
        assert abs(float(s[-1])) <= 8 * n * EPS32 * scale  # singular B
    if case in ("16", "40", "130-dnc"):
        _same_columns_up_to_sign(vn, vj, s64, scale)
        _same_columns_up_to_sign(un, uj, s64, scale)


# ---------------------------------------------------------------------------
# the public entry points
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [2, 16, 64])
def test_self_adjoint_evd_matches_jax_and_f64(n):
    rng = np.random.default_rng(30 + n)
    g = rng.standard_normal((n, n))
    a = ((g + g.T) / 2).astype(np.float32)
    # garbage in the upper triangle: only the lower one is read
    a_in = np.tril(a) + np.triu(rng.standard_normal((n, n)), 1).astype(np.float32)
    w, v, info = ft.self_adjoint_evd(_t(a_in))
    wj, vj, _ = jevd.self_adjoint_evd(jnp.asarray(a_in))
    w64 = np.linalg.eigvalsh(a.astype(np.float64))
    scale = np.abs(w64).max()
    _close(w.numpy(), w64, n, scale)
    _close(w.numpy(), wj, n, scale)
    vn = v.numpy().astype(np.float64)
    _close(a @ vn, vn * w.numpy()[None, :], n, scale)
    _close(vn.T @ vn, np.eye(n), n, 1.0)
    _same_columns_up_to_sign(vn, vj, w64, scale)
    assert isinstance(info, terrors.SpectralInfo) and bool(info.converged)
    _close(ft.self_adjoint_eigenvalues(_t(a_in)).numpy(), w64, n, scale)


def test_self_adjoint_eigenvalues_upper_and_pseudoinverse():
    from faer_tpu_torch.core.flags import Side

    rng = np.random.default_rng(40)
    n = 24
    g = rng.standard_normal((n, 4))
    a = (g @ g.T).astype(np.float32)  # rank 4: a real pseudoinverse
    a_up = np.triu(a) + np.tril(rng.standard_normal((n, n)), -1).astype(np.float32)
    w64 = np.linalg.eigvalsh(a.astype(np.float64))
    _close(ft.self_adjoint_eigenvalues(_t(a_up), Side.UPPER).numpy(), w64, n,
           np.abs(w64).max())
    pinv = ft.self_adjoint_pseudoinverse(_t(a)).numpy()
    want = np.asarray(jevd.self_adjoint_pseudoinverse(jnp.asarray(a)))
    ref = np.linalg.pinv(a.astype(np.float64), hermitian=True, rtol=1e-5)
    _close(pinv, ref, n, np.abs(ref).max() * 10)
    _close(pinv, want, n, np.abs(ref).max() * 10)


@pytest.mark.parametrize("m,n", [(12, 12), (40, 25), (25, 40), (100, 20)])
@pytest.mark.parametrize("thin", [True, False])
def test_svd_matches_jax_and_f64(m, n, thin):
    rng = np.random.default_rng(m * 3 + n)
    a = rng.standard_normal((m, n)).astype(np.float32)
    u, s, v, info = ft.svd(_t(a), thin=thin)
    uj, sj, vj, _ = jsvd.svd(jnp.asarray(a), thin=thin)
    k = min(m, n)
    assert tuple(u.shape) == ((m, k) if thin else (m, m))
    assert tuple(v.shape) == ((n, k) if thin else (n, n))
    s64 = np.linalg.svd(a.astype(np.float64), compute_uv=False)
    big = max(m, n)
    _close(s.numpy(), s64, big, s64[0])
    _close(s.numpy(), sj, big, s64[0])
    un, vn = u.numpy().astype(np.float64), v.numpy().astype(np.float64)
    _close(un[:, :k] * s.numpy()[None, :] @ vn[:, :k].T, a, big, s64[0])
    _close(un.T @ un, np.eye(un.shape[1]), big, 1.0)
    _close(vn.T @ vn, np.eye(vn.shape[1]), big, 1.0)
    _same_columns_up_to_sign(vn[:, :k], np.asarray(vj)[:, :k], s64, s64[0])
    assert bool(info.converged)


def test_singular_values_and_pseudoinverse():
    rng = np.random.default_rng(50)
    a = (rng.standard_normal((30, 6)) @ rng.standard_normal((6, 20))).astype(np.float32)
    s64 = np.linalg.svd(a.astype(np.float64), compute_uv=False)
    _close(ft.singular_values(_t(a)).numpy(), s64, 30, s64[0])
    ref = np.linalg.pinv(a.astype(np.float64), rtol=1e-5)
    scale = np.abs(ref).max() * 10
    _close(ft.pseudoinverse(_t(a)).numpy(), ref, 30, scale)
    _close(ft.pseudoinverse(_t(a)).numpy(),
           np.asarray(jsvd.pseudoinverse(jnp.asarray(a))), 30, scale)
    u, s, v, _ = ft.svd(_t(a))
    _close(ft.pseudoinverse_from_svd(u, s, v).numpy(), ref, 30, scale)


@pytest.mark.parametrize("call", [
    lambda x: ft.self_adjoint_evd(x),
    lambda x: ft.self_adjoint_eigenvalues(x),
    lambda x: ft.svd(x),
    lambda x: ft.singular_values(x),
])
@pytest.mark.parametrize("dtype", [torch.complex128, torch.complex64])
def test_spectral_entry_points_are_f32_only(call, dtype):
    """Every field: float32, float64 (item 5c) and, since item 10a, complex
    Hermitian (or any complex) input, whose eigen- and singular values are
    real; diag(1..8) gives back 1..8."""
    d = torch.arange(1, 9, dtype=dtype.to_real())
    out = call(torch.diag(d).to(dtype))
    w = out if isinstance(out, torch.Tensor) else out[0] if out[0].dim() == 1 else out[1]
    assert w.dtype == dtype.to_real()
    assert torch.allclose(torch.sort(w).values, d)


def test_spectral_shape_errors():
    with pytest.raises(ft.ShapeError):
        ft.self_adjoint_evd(torch.zeros(4, 5))
    with pytest.raises(ft.ShapeError):
        ft.svd(torch.zeros(4))


def test_spectral_params_info_and_flops_match_jax():
    for name in ("SvdParams", "EvdParams"):
        tp, jp = getattr(tparams, name)(), getattr(jparams, name)()
        assert {f: getattr(tp, f) for f in tp.__dataclass_fields__} == \
            {f: getattr(jp, f) for f in jp.__dataclass_fields__}
    assert set(terrors.SpectralInfo.__dataclass_fields__) == \
        set(jerrors.SpectralInfo.__dataclass_fields__)
    assert ft.SvdParams is tparams.SvdParams and ft.EvdParams is tparams.EvdParams
    # the D&C SVD reports converged=True, iterations=0, as the reference does
    d, e = _random_tridiag(70)
    _, _, _, info = tbs.bidiag_svd(_t(d), _t(e), use_dnc=True)
    assert bool(info.converged) and int(info.iterations) == 0
