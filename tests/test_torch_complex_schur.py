"""The port's complex Schur form (``linalg/complex_schur.py``: the
single-shift iteration's plain version, which the ``complex_schur`` CUDA
kernel equals to the bit, and the batched wrapper's CPU route) against
``faer_tpu``'s ``complex_schur`` (``faer_tpu/linalg/evd.py:277``) and
f64 scipy.

Inputs are complex Gaussian Hessenberg matrices made with numpy from a
seed and handed to both packages; the JAX side runs on the CPU with x64
on (``tests/conftest.py``), jitted once a module. A Schur form can order
its diagonal differently under a different rounding, so the eigenvalues
are compared by nearest matching, each within 2·κ_i·η of f64
``scipy.linalg.eig`` (κ_i its condition number from the left and right
vectors, η the measured backward error ‖A − QTQᴴ‖₂ + ‖A‖₂‖QᴴQ − I‖₂);
‖A − QTQᴴ‖/‖A‖ and max|QᴴQ − I| within 8·n·eps of the dtype (faer's
rule).
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

import faer_tpu.linalg.evd as jevd
from complex_cases import DTYPES, eig_ratio, eps, hess_input, schur_backward
from faer_tpu_torch.core.errors import ShapeError
from faer_tpu_torch.linalg import complex_schur as tcs
from faer_tpu_torch.ops.kernels import complex_schur as kcs

torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def _jax_schur():
    """The JAX package's ``complex_schur``, jitted once a module."""
    return jax.jit(jevd.complex_schur)


def _check(h, t, q, npdt, label=""):
    """Triangular T, the backward error and orthogonality within 8·n·eps,
    the eigenvalues within 2·κ_i·η of f64 scipy; returns η."""
    n = h.shape[0]
    tol = 8 * n * eps(npdt)
    t = np.asarray(t)
    assert np.all(np.tril(t, -1) == 0), label
    rec, orth, eta = schur_backward(h, t, q)
    assert rec <= tol and orth <= tol, (label, rec, orth, tol)
    assert eig_ratio(np.diag(t), h, eta) <= 1, label
    return eta


@pytest.mark.parametrize("n", [1, 2, 5, 16, 48])
@pytest.mark.parametrize("name", ["c64", "c128"])
def test_complex_schur_against_jax_and_scipy(name, n):
    """``complex_schur`` (the CPU route, the plain twin) converges to an
    upper-triangular T with A = QTQᴴ; the JAX package's T of the same H
    passes the same checks, and the two diagonals match each other by
    nearest matching within the sum of their bounds."""
    tdt, npdt = DTYPES[name]
    h = hess_input(n, npdt)
    t, q, info = tcs.complex_schur(torch.from_numpy(h), torch.eye(n, dtype=tdt))
    assert t.dtype == tdt and q.dtype == tdt and bool(info.converged)
    assert 0 <= int(info.iterations) <= 30 * n
    eta = _check(h, t.numpy(), q.numpy(), npdt, "port")
    tj, qj, infoj = _jax_schur()(jnp.asarray(h), jnp.eye(n, dtype=h.dtype))
    assert bool(infoj.converged)
    etaj = _check(h, np.asarray(tj), np.asarray(qj), npdt, "jax")
    # the port's eigenvalues against the JAX package's, each matched to the
    # nearest, within 2·κ_i·(η + η_jax)
    assert eig_ratio(np.diag(t.numpy()), h, eta + etaj, other=np.diag(np.asarray(tj))) <= 1


@pytest.mark.parametrize("name", ["c64", "c128"])
def test_complex_schur_plain_equals_the_batched_ragged_route(name):
    """``complex_schur_batched`` on a CPU tensor (its plain version) on a
    ragged batch: each problem equal to ``complex_schur_plain`` on its own
    to the bit, entries past each problem as given, a size outside [1,
    nmax] left as it is (0 iterations, not converged)."""
    tdt, npdt = DTYPES[name]
    nmax, sizes = 20, (20, 7, 1, 0, 13)
    h = np.zeros((len(sizes), nmax, nmax), npdt)
    for b, n in enumerate(sizes):
        if n:
            h[b, :n, :n] = hess_input(n, npdt, seed=b)
    h[1:, -1, 0] = 5.0  # past the problems of smaller n: left as given
    q = torch.eye(nmax, dtype=tdt).repeat(len(sizes), 1, 1)
    ht = torch.from_numpy(h)
    t, qo, its, conv, steps = kcs.complex_schur_batched(
        ht, q, torch.tensor(sizes, dtype=torch.int32))
    assert its.dtype == torch.int32 and conv.dtype == torch.bool and steps.dtype == torch.int32
    for b, n in enumerate(sizes):
        if not n:
            assert not bool(conv[b]) and int(its[b]) == 0 and int(steps[b]) == 0
            assert torch.equal(t[b], ht[b])
            continue
        tb, qb, it, ok, st = tcs.complex_schur_plain(ht[b, :n, :n], q[b, :n, :n])
        assert torch.equal(t[b, :n, :n], tb) and torch.equal(qo[b, :n, :n], qb)
        assert (int(its[b]), bool(conv[b]), int(steps[b])) == (it, ok, st) and ok
        assert torch.equal(t[b, n:], ht[b, n:]) and torch.equal(t[b, :, n:], ht[b, :, n:])
        _check(h[b, :n, :n], tb.numpy(), qb.numpy(), npdt, f"ragged {n}")


@pytest.mark.parametrize("name", ["c64", "c128"])
def test_complex_schur_iteration_budget(name):
    """``max_sweeps_factor=0`` runs no iteration: T = H, Q = I, not
    converged; 1 leaves the iteration unconverged at n = 16."""
    tdt, npdt = DTYPES[name]
    n = 16
    h = torch.from_numpy(hess_input(n, npdt))
    t, q, it, ok, steps = tcs.complex_schur_plain(h, torch.eye(n, dtype=tdt),
                                                  max_sweeps_factor=0)
    assert (it, ok, steps) == (0, False, 0)
    assert torch.equal(t, h) and torch.equal(q, torch.eye(n, dtype=tdt))
    _, _, info = tcs.complex_schur(h, torch.eye(n, dtype=tdt), max_sweeps_factor=1)
    assert not bool(info.converged) and int(info.iterations) == n


@pytest.mark.parametrize("name", ["c64", "c128"])
def test_complex_schur_small_scale(name):
    """A Hessenberg matrix × 1e-20: in complex64 its entries' squares are
    subnormal, where the reference's unscaled |x| and discriminant lose
    their bits. The scaled forms converge to a T within 8·n·eps, with
    eigenvalues within 2·κ_i·η, and the rotation count of the unscaled
    matrix's iteration."""
    tdt, npdt = DTYPES[name]
    n = 24
    h1 = hess_input(n, npdt, seed=3)
    h = (h1 * npdt(1e-20)).astype(npdt)
    assert np.abs(h).max() ** 2 < np.finfo(npdt).tiny or npdt is np.complex128
    t, q, it, ok, steps = tcs.complex_schur_plain(torch.from_numpy(h), torch.eye(n, dtype=tdt))
    assert ok and 0 < it <= 30 * n
    _check(h, t.numpy(), q.numpy(), npdt, "small scale")


def test_complex_schur_wrapper_refusals():
    """The batched wrapper's checks: complex dtypes only (one dtype), square
    (B, nmax, nmax) with q of h's shape, int32 sizes (B,), a factor ≥ 0."""
    h = torch.eye(4, dtype=torch.complex64)[None]
    sizes = torch.tensor([4], dtype=torch.int32)
    with pytest.raises(TypeError):
        kcs.complex_schur_batched(h.real.contiguous(), h.real.contiguous(), sizes)
    with pytest.raises(TypeError):
        kcs.complex_schur_batched(h, h.to(torch.complex128), sizes)
    with pytest.raises(ShapeError):
        kcs.complex_schur_batched(h[:, :, :3].contiguous(), h[:, :, :3].contiguous(), sizes)
    with pytest.raises(ShapeError):
        kcs.complex_schur_batched(h, h[:, :3, :3].contiguous(), sizes)
    with pytest.raises(TypeError):
        kcs.complex_schur_batched(h, h, sizes.long())
    with pytest.raises(ValueError):
        kcs.complex_schur_batched(h, h, sizes, max_sweeps_factor=-1)
    t, q, its, conv, steps = kcs.complex_schur_batched(h, h.clone(), sizes)
    assert torch.equal(t, h) and bool(conv[0]) and int(steps[0]) == 0


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("mode", ["complex_schur", "real_schur"])
def test_profile_modes_exit_without_a_card_and_import_no_jax(mode):
    """``tools/torch_profile.py complex_schur`` and ``real_schur`` exist,
    refuse to run without a card, printing no result, and loading the tool
    and the kernel modules loads neither JAX nor the JAX package."""
    path = os.path.join(REPO, "tools", "torch_profile.py")
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, path, mode], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and "cycles" not in proc.stdout
    assert "CUDA card" in proc.stderr
    code = ("import sys, runpy, faer_tpu_torch.ops.kernels.complex_schur, "
            "faer_tpu_torch.ops.kernels.real_schur; "
            f"tool = runpy.run_path({path!r}); "
            f"spec = tool['KERNELS'][{mode!r}]; "
            "assert spec['macro'] == 'FAER_SCHUR_PROFILE' and len(spec['labels']) == 6; "
            "bad = sorted(m for m in sys.modules if m in ('jax', 'faer_tpu') "
            "or m.startswith(('jax.', 'faer_tpu.'))); assert not bad, bad")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
