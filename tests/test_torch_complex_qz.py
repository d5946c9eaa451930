"""The port's complex QZ (``linalg/complex_qz.py``: the complex
Hessenberg–triangular chain and the single-shift QZ iteration, whose
plain versions the ``complex_hess_tri`` and ``complex_qz`` CUDA kernels
equal to the bit, and the batched wrappers' CPU routes) against
``faer_tpu``'s ``hessenberg_triangular`` and ``qz_iteration``
(``faer_tpu/linalg/qz.py:45,111``) and f64 scipy.

Inputs are complex Gaussian pencils made with numpy from a seed and
handed to both packages; the JAX side runs on the CPU with x64 on
(``tests/conftest.py``), jitted once a module and shape. Tolerances:
faer's 8·n·eps of the dtype for the backward errors ‖A − QSZᴴ‖/‖A‖,
‖B − QTZᴴ‖/‖B‖ and for max|QᴴQ − I|, max|ZᴴZ − I|; the (α, β) pairs
within 2·κ_i·η of f64 ``scipy.linalg.eig`` in the chordal metric, matched
to the nearest (a QZ can order its diagonal differently under a different
rounding; κ_i the pencil's chordal condition number from scipy's left and
right vectors, η the measured backward error).
"""
import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import faer_tpu.linalg.qz as jqz
from complex_cases import DTYPES, chordal_ratio, eps, pencil_input, qz_backward
from faer_tpu_torch.core.errors import ShapeError
from faer_tpu_torch.linalg import complex_qz as tcq
from faer_tpu_torch.linalg import qz as tqz
from faer_tpu_torch.ops.kernels import complex_qz as kcq

torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def _jax(name):
    """The JAX package's ``hessenberg_triangular`` or ``qz_iteration``,
    jitted once a module."""
    return jax.jit(getattr(jqz, name))


def _check_reduction(a, b, h, r, q, z, npdt, label=""):
    """H exactly Hessenberg, R exactly triangular, the backward errors and
    the unitarity of Q and Z within 8·n·eps."""
    n = a.shape[0]
    tol = 8 * n * eps(npdt)
    h, r = np.asarray(h), np.asarray(r)
    assert np.all(np.tril(h, -2) == 0) and np.all(np.tril(r, -1) == 0), label
    rec_a, rec_b, orth_q, orth_z, _ = qz_backward(a, b, h, r, q, z)
    assert max(rec_a, rec_b, orth_q, orth_z) <= tol, (label, rec_a, rec_b, orth_q, orth_z, tol)


def _check_qz(a, b, s, t, q, z, npdt, label=""):
    """S and T upper triangular, the backward errors and unitarity within
    8·n·eps, (α, β) within 2·κ_i·η of scipy's; returns η."""
    n = a.shape[0]
    tol = 8 * n * eps(npdt)
    s, t = np.asarray(s), np.asarray(t)
    assert np.all(np.tril(s, -1) == 0) and np.all(np.tril(t, -1) == 0), label
    rec_a, rec_b, orth_q, orth_z, eta = qz_backward(a, b, s, t, q, z)
    assert max(rec_a, rec_b, orth_q, orth_z) <= tol, (label, rec_a, rec_b, orth_q, orth_z, tol)
    assert chordal_ratio(np.diag(s), np.diag(t), a, b, eta) <= 1, label
    return eta


@pytest.mark.parametrize("n", [1, 2, 3, 16, 40])
@pytest.mark.parametrize("name", ["c64", "c128"])
def test_complex_hessenberg_triangular_against_jax(name, n):
    """``hessenberg_triangular`` of a complex pencil (the QR of B, then the
    CPU route of the complex Givens chain, the ``complex_hess_tri`` kernel's
    twin): H Hessenberg and R triangular, both exactly, A = QHZᴴ and
    B = QRZᴴ and Q, Z unitary within 8·n·eps; the JAX package's reduction
    of the same pencil passes the same checks."""
    tdt, npdt = DTYPES[name]
    a, b = pencil_input(n, npdt)
    h, r, q, z = tqz.hessenberg_triangular(torch.from_numpy(a), torch.from_numpy(b))
    assert all(x.dtype == tdt for x in (h, r, q, z))
    _check_reduction(a, b, h.numpy(), r.numpy(), q.numpy(), z.numpy(), npdt, "port")
    jh, jr, jq, jz = _jax("hessenberg_triangular")(jnp.asarray(a), jnp.asarray(b))
    _check_reduction(a, b, jh, jr, jq, jz, npdt, "jax")


@pytest.mark.parametrize("name", ["c64", "c128"])
def test_complex_hess_tri_plain_equals_the_batched_ragged_route(name):
    """``complex_hess_tri_batched`` on CPU tensors (its plain version) on a
    ragged batch: each problem equal to ``hessenberg_triangular_plain`` on
    its own to the bit, entries past each problem as given, a size outside
    [1, nmax] left as it is."""
    tdt, npdt = DTYPES[name]
    nmax, sizes = 20, (20, 7, 1, 0, 13)
    mats = [np.zeros((len(sizes), nmax, nmax), npdt) for _ in range(4)]
    for k, n in enumerate(sizes):
        if n:
            a, b = pencil_input(n, npdt, seed=k)
            qq, rr = np.linalg.qr(b.astype(np.complex128))
            mats[0][k, :n, :n] = qq.conj().T @ a
            mats[1][k, :n, :n] = np.triu(rr)
            mats[2][k, :n, :n] = qq
            mats[3][k, :n, :n] = np.eye(n)
    mats[0][1:, -1, 0] = 5.0  # past the problems of smaller n: left as given
    mats = [torch.from_numpy(m) for m in mats]
    out = kcq.complex_hess_tri_batched(*mats, torch.tensor(sizes, dtype=torch.int32))
    for k, n in enumerate(sizes):
        if not n:
            assert all(torch.equal(o[k], m[k]) for o, m in zip(out, mats))
            continue
        want = tcq.hessenberg_triangular_plain(*(m[k, :n, :n] for m in mats))
        assert all(torch.equal(o[k, :n, :n], w) for o, w in zip(out, want))
        assert torch.equal(out[0][k, n:], mats[0][k, n:])
        assert torch.equal(out[0][k, :, n:], mats[0][k, :, n:])


@pytest.mark.parametrize("n", [1, 2, 5, 16, 48])
@pytest.mark.parametrize("name", ["c64", "c128"])
def test_qz_iteration_against_jax_and_scipy(name, n):
    """``qz_iteration`` (the CPU route, the ``complex_qz`` kernel's twin) on
    the port's Hessenberg–triangular pencil converges to S, T upper
    triangular with A = QSZᴴ, B = QTZᴴ; the JAX package's ``qz_iteration``
    of the same (H, R, Q, Z) passes the same checks, and the two (α, β)
    sets match each other by nearest matching within the sum of their
    bounds. ``qz_iteration_plain`` returns the same bits and counts."""
    tdt, npdt = DTYPES[name]
    a, b = pencil_input(n, npdt, seed=1)
    red = tqz.hessenberg_triangular(torch.from_numpy(a), torch.from_numpy(b))
    s, t, q, z, info = tqz.qz_iteration(*red)
    assert all(x.dtype == tdt for x in (s, t, q, z)) and bool(info.converged)
    assert 0 <= int(info.iterations) <= 30 * n
    plain = tcq.qz_iteration_plain(*red)
    assert all(torch.equal(x, y) for x, y in zip((s, t, q, z), plain[:4]))
    assert plain[4] == int(info.iterations) and plain[5]
    eta = _check_qz(a, b, s.numpy(), t.numpy(), q.numpy(), z.numpy(), npdt, "port")
    js, jt, jq, jz, jinfo = _jax("qz_iteration")(*(jnp.asarray(x.numpy()) for x in red))
    assert bool(jinfo.converged)
    jeta = _check_qz(a, b, js, jt, jq, jz, npdt, "jax")
    other = (np.diag(np.asarray(js)), np.diag(np.asarray(jt)))
    assert chordal_ratio(np.diag(s.numpy()), np.diag(t.numpy()), a, b, eta + jeta,
                         other=other) <= 1


@pytest.mark.parametrize("name", ["c64", "c128"])
def test_qz_iteration_budget(name):
    """``max_sweeps_factor=0`` runs no iteration: S = H, T = R, Q and Z as
    given, not converged; the wrapper's plain route says so too."""
    tdt, npdt = DTYPES[name]
    a, b = pencil_input(16, npdt, seed=2)
    red = tqz.hessenberg_triangular(torch.from_numpy(a), torch.from_numpy(b))
    *mats, it, ok, steps = tcq.qz_iteration_plain(*red, max_sweeps_factor=0)
    assert (it, ok, steps) == (0, False, 0)
    assert all(torch.equal(x, y) for x, y in zip(mats, red))
    _, _, _, _, info = tqz.qz_iteration(*red, max_sweeps_factor=0)
    assert not bool(info.converged) and int(info.iterations) == 0


@pytest.mark.parametrize("name", ["c64", "c128"])
def test_qz_small_scale(name):
    """A pencil × 1e-20: in complex64 its entries' squares are subnormal,
    where the JAX package's unscaled |x|, rotation norms and discriminant
    lose their bits (its QZ of this pencil returns non-finite values). The
    scaled forms converge to S, T within 8·n·eps, with (α, β) within
    2·κ_i·η of scipy's."""
    tdt, npdt = DTYPES[name]
    n = 24
    a, b = pencil_input(n, npdt, scale=1e-20)
    assert np.abs(a).max() ** 2 < np.finfo(npdt).tiny or npdt is np.complex128
    s, t, q, z, info = tqz.qz(torch.from_numpy(a), torch.from_numpy(b))
    assert bool(info.converged) and 0 < int(info.iterations) <= 30 * n
    _check_qz(a, b, s.numpy(), t.numpy(), q.numpy(), z.numpy(), npdt, "small scale")


@pytest.mark.parametrize("name", ["c64", "c128"])
def test_qz_low_rank_b_against_jax(name):
    """B of rank 12 at n = 16: the complex QZ has no infinite-eigenvalue
    deflation (as in the JAX package; the guarded shift carries them). The
    port and the JAX package both converge on the same pencil, each with as
    many β within n·eps·‖B‖₂ of 0 as B's nullity (4); the port's backward
    errors and unitarity are within 8·n·eps and no larger than the JAX
    package's (whose ‖A − QSZᴴ‖/‖A‖ in complex128 is 3.5e-13 here, 12
    times that bound: ROADMAP §3)."""
    tdt, npdt = DTYPES[name]
    n, rank = 16, 12
    a, b = pencil_input(n, npdt, rank=rank)
    floor = n * eps(npdt) * np.linalg.norm(b.astype(np.complex128), 2)
    s, t, q, z, info = tqz.qz(torch.from_numpy(a), torch.from_numpy(b))
    js, jt, jq, jz, jinfo = jax.jit(jqz.qz)(jnp.asarray(a), jnp.asarray(b))
    errs = {}
    for label, conv, mats in (("port", info.converged, (s, t, q, z)),
                              ("jax", jinfo.converged, (js, jt, jq, jz))):
        mats = [np.asarray(x) for x in mats]
        assert bool(conv), label
        assert int((np.abs(np.diag(mats[1])) <= floor).sum()) == n - rank, label
        errs[label] = max(qz_backward(a, b, *mats)[:4])
    assert errs["port"] <= min(8 * n * eps(npdt), max(errs["jax"], 8 * n * eps(npdt)))


def test_complex_qz_wrapper_refusals():
    """The batched wrappers' checks: complex dtypes only (one dtype),
    square (B, nmax, nmax) matrices of one shape, int32 sizes (B,), a
    factor ≥ 0; a real pencil through ``qz`` still takes the real QZ, and
    ``real_qz`` and ``qz_eigenvalues_pair`` still refuse complex input."""
    import faer_tpu_torch as ft

    h = torch.eye(4, dtype=torch.complex64)[None]
    sizes = torch.tensor([4], dtype=torch.int32)
    for fn in (kcq.complex_hess_tri_batched, kcq.complex_qz_batched):
        with pytest.raises(TypeError):
            fn(*(h.real.contiguous(),) * 4, sizes)
        with pytest.raises(TypeError):
            fn(h, h, h, h.to(torch.complex128), sizes)
        with pytest.raises(ShapeError):
            fn(h, h, h, h[:, :3, :3].contiguous(), sizes)
        with pytest.raises(TypeError):
            fn(h, h, h, h, sizes.long())
    with pytest.raises(ValueError):
        kcq.complex_qz_batched(h, h, h, h, sizes, max_sweeps_factor=-1)
    s, t, q, z, its, conv, steps = kcq.complex_qz_batched(h, h, h, h, sizes)
    assert torch.equal(s, h) and bool(conv[0]) and int(steps[0]) == 0
    c = torch.eye(3, dtype=torch.complex64)
    with pytest.raises(NotImplementedError, match="qz"):
        ft.real_qz(c, c)
    with pytest.raises(NotImplementedError, match="qz"):
        ft.qz_eigenvalues_pair(c, c)
    with pytest.raises(TypeError):
        ft.qz(c, torch.eye(3, dtype=torch.float64))  # a real B of another precision
    assert not ft.qz(torch.eye(3), 2 * torch.eye(3))[0].is_complex()


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("mode,macro,labels", [("complex_hess_tri", "FAER_CHT_PROFILE", 4),
                                               ("complex_qz", "FAER_CQZ_PROFILE", 6)])
def test_profile_modes_exit_without_a_card_and_import_no_jax(mode, macro, labels):
    """``tools/torch_profile.py complex_hess_tri`` and ``complex_qz`` exist,
    refuse to run without a card, printing no result, and loading the tool
    and the kernel module loads neither JAX nor the JAX package."""
    path = os.path.join(REPO, "tools", "torch_profile.py")
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, path, mode], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and "cycles" not in proc.stdout
    assert "CUDA card" in proc.stderr
    code = ("import sys, runpy, faer_tpu_torch.ops.kernels.complex_qz; "
            f"tool = runpy.run_path({path!r}); "
            f"spec = tool['KERNELS'][{mode!r}]; "
            f"assert spec['macro'] == {macro!r} and len(spec['labels']) == {labels}; "
            "bad = sorted(m for m in sys.modules if m in ('jax', 'faer_tpu') "
            "or m.startswith(('jax.', 'faer_tpu.'))); assert not bad, bad")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
