"""The port's float64 spectral entry points against ``faer_tpu`` and f64
numpy.

Inputs are made with numpy from a seed and handed to both packages. The
JAX side runs as its own tests run it: on the CPU with x64 on
(``tests/conftest.py``), through its XLA sweeps. The port side runs the
plain versions of its batched QR kernels, which take float64 as the CUDA
kernels do (one instantiation each): the direct QR route at 64 (and 90 ×
64). Divide & conquer at 512 is in ``tests/test_torch_spectral_f64_dnc.py``,
split from this file to keep each file's time short. Tolerances: faer's 8·n·eps
rule in float64, relative to the largest eigenvalue or singular value, for
the values, the residuals and the orthogonality. The direct route at 384
takes about a minute a call on the CPU (the plain QR iteration steps on
0-d tensors), so ``chip_smoke.py`` holds it on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import faer_tpu.linalg.evd as jevd
import faer_tpu.linalg.svd as jsvd
import faer_tpu_torch as ft
from faer_tpu_torch.ops.kernels import sweep

torch.set_num_threads(1)

EPS64 = float(np.finfo(np.float64).eps)


def _tol(n):
    return 8 * n * EPS64


def _sym(n, seed):
    g = np.random.default_rng(seed).standard_normal((n, n))
    return (g + g.T) / 2


@pytest.mark.parametrize("n", [64])
def test_self_adjoint_evd_f64(n):
    a = _sym(n, n)
    w, v, info = ft.self_adjoint_evd(torch.tensor(a))
    assert w.dtype == v.dtype == torch.float64 and bool(info.converged)
    wn, vn = w.numpy(), v.numpy()
    scale = np.abs(wn).max()
    ref = np.linalg.eigvalsh(a)
    assert np.abs(wn - ref).max() <= _tol(n) * scale
    assert np.linalg.norm(a @ vn - vn * wn) <= _tol(n) * scale * np.sqrt(n)
    assert np.abs(vn.T @ vn - np.eye(n)).max() <= _tol(n)
    wj, _, _ = jevd.self_adjoint_evd(jnp.asarray(a))
    assert np.abs(wn - np.asarray(wj)).max() <= _tol(n) * scale
    assert np.abs(ft.self_adjoint_eigenvalues(torch.tensor(a)).numpy() - wn).max() \
        <= _tol(n) * scale


@pytest.mark.parametrize("m,n", [(64, 64), (90, 64)])
def test_svd_f64(m, n):
    g = np.random.default_rng(m + n).standard_normal((m, n))
    u, s, v, info = ft.svd(torch.tensor(g))
    assert s.dtype == torch.float64 and bool(info.converged)
    un, sn, vn = u.numpy(), s.numpy(), v.numpy()
    k = min(m, n)
    ref = np.linalg.svd(g, compute_uv=False)
    assert np.abs(sn - ref).max() <= _tol(max(m, n)) * ref[0]
    assert np.linalg.norm((un * sn) @ vn.T - g) <= _tol(max(m, n)) * ref[0] * np.sqrt(k)
    assert np.abs(un.T @ un - np.eye(k)).max() <= _tol(max(m, n))
    assert np.abs(vn.T @ vn - np.eye(k)).max() <= _tol(max(m, n))
    _, sj, _, _ = jsvd.svd(jnp.asarray(g))
    assert np.abs(sn - np.asarray(sj)).max() <= _tol(max(m, n)) * ref[0]
    assert np.abs(ft.singular_values(torch.tensor(g)).numpy() - sn).max() \
        <= _tol(max(m, n)) * ref[0]


def test_pseudoinverses_f64():
    g = np.random.default_rng(5).standard_normal((40, 24))
    a = _sym(24, 6)
    ref = np.linalg.pinv(g)
    got = ft.pseudoinverse(torch.tensor(g)).numpy()
    assert np.abs(got - ref).max() <= _tol(40) * np.abs(ref).max() * 10
    ref = np.linalg.pinv(a)
    got = ft.self_adjoint_pseudoinverse(torch.tensor(a)).numpy()
    assert np.abs(got - ref).max() <= _tol(24) * np.abs(ref).max() * 10


@pytest.mark.parametrize("kind", ["tridiag", "bidiag"])
def test_batched_qr_plain_f64_on_ragged_batches(kind):
    """The batched kernels' plain versions in float64 on a ragged batch
    (square and wide problems), each problem's values against f64 numpy
    within 8·n·eps, its vectors orthogonal and reconstructing it."""
    sizes, sqre = [40, 17, 2, 1, 33], [0, 1, 0, 0, 1]
    rng = np.random.default_rng(11)
    nmax = max(sizes)
    d0 = rng.standard_normal((len(sizes), nmax))
    e0 = rng.standard_normal((len(sizes), nmax))
    d = torch.tensor(d0)
    sz = torch.tensor(sizes, dtype=torch.int32)
    if kind == "tridiag":
        e = torch.tensor(e0[:, :nmax - 1]).contiguous()
        z, its, conv, _ = sweep.tridiag_qr_batched(d, e, sz)
    else:
        e = torch.tensor(e0)
        u, w, its, conv, _ = sweep.bidiag_qr_batched(d, e, sz, torch.tensor(sqre, dtype=torch.int32))
    assert bool(conv.all())
    for b, n in enumerate(sizes):
        if kind == "tridiag":
            t = np.diag(d0[b, :n]) + np.diag(e0[b, :n - 1], 1) + np.diag(e0[b, :n - 1], -1)
            ref = np.linalg.eigvalsh(t)
            got = np.sort(d[b, :n].numpy())
            zb = z[b, :n, :n].numpy()
            scale = max(np.abs(ref).max(), 1.0)
            assert np.abs(got - ref).max() <= _tol(n) * scale
            assert np.abs(zb @ np.diag(d[b, :n].numpy()) @ zb.T - t).max() <= _tol(n) * scale
        else:
            sq = sqre[b]
            bm = np.zeros((n, n + sq))
            bm[np.arange(n), np.arange(n)] = d0[b, :n]
            bm[np.arange(n - 1 + sq), np.arange(1, n + sq)] = e0[b, :n - 1 + sq]
            ref = np.linalg.svd(bm, compute_uv=False)
            got = np.sort(np.abs(d[b, :n].numpy()))[::-1]
            scale = max(ref[0], 1.0)
            assert np.abs(got - ref).max() <= _tol(n) * scale
            sig = np.zeros((n, n + sq))
            sig[np.arange(n), np.arange(n)] = d[b, :n].numpy()
            ub, wb = u[b, :n, :n].numpy(), w[b, :n + sq, :n + sq].numpy()
            assert np.abs(ub @ sig @ wb.T - bm).max() <= _tol(n) * scale


def test_batched_wrappers_take_f64_and_refuse_mixed_dtypes():
    d = torch.ones(2, 8, dtype=torch.float64)
    s = torch.tensor([8, 5], dtype=torch.int32)
    z, its, conv, _ = sweep.tridiag_qr_batched(d.clone(), torch.zeros(2, 7, dtype=torch.float64), s)
    assert z.dtype == torch.float64 and bool(conv.all())
    with pytest.raises(TypeError):
        sweep.tridiag_qr_batched(d, torch.zeros(2, 7), s)
    with pytest.raises(TypeError):
        sweep.bidiag_qr_batched(d.float(), torch.zeros(2, 8, dtype=torch.float64), s,
                                torch.zeros(2, dtype=torch.int32))


@pytest.mark.parametrize("call", [
    lambda x: ft.self_adjoint_evd(x), lambda x: ft.svd(x), lambda x: ft.evd(x),
    lambda x: ft.eigenvalues(x),
])
def test_spectral_entry_points_refuse_complex(call):
    """The general EVD takes complex input since item 10b-i (complex
    eigenvalues); the self-adjoint EVD and the SVD take it since item 10a
    (real values)."""
    if call.__code__.co_names[-1] in ("evd", "eigenvalues"):
        out = call(torch.eye(4, dtype=torch.complex128))
        w = out[0] if isinstance(out, tuple) else out
        assert torch.equal(w, torch.ones(4, dtype=torch.complex128))
    else:
        out = call(torch.eye(4, dtype=torch.complex128))
        w = out[0] if out[0].dim() == 1 else out[1]
        assert w.dtype == torch.float64 and torch.allclose(w, torch.ones(4, dtype=torch.float64))


def test_dtype_helpers_match_jax():
    """The port's copies of the JAX package's dtype helpers that the Schur
    iterations read: the complex dtype of a precision, the smallest normal
    number and the cap of the loosened deflation floor (11 in float32, 24
    in float64)."""
    from faer_tpu.core import dtypes as jdt
    from faer_tpu_torch.core import dtypes as tdt

    pairs = {torch.float32: jnp.float32, torch.float64: jnp.float64,
             torch.complex64: jnp.complex64, torch.complex128: jnp.complex128}
    for t, j in pairs.items():
        assert str(tdt.complex_dtype_of(t)).split(".")[-1] == str(jdt.complex_dtype_of(j))
        assert tdt.min_positive(t) == jdt.min_positive(j)
        assert tdt.deflation_stall_cap(t) == jdt.deflation_stall_cap(j)
    assert tdt.deflation_stall_cap(torch.float32) == 11
    assert tdt.deflation_stall_cap(torch.float64) == 24
