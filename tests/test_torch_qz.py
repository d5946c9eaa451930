"""The port's Hessenberg–triangular reduction and real QZ iteration against
``faer_tpu`` and scipy.

Inputs are made with numpy from a seed and handed to both packages. The
JAX side runs on the CPU with x64 on (``tests/conftest.py``), jitted once
a shape. The port side runs on the CPU: ``hess_tri``'s and ``real_qz``'s
plain versions, which the card's kernels equal to the bit
(``tests/test_torch_gpu.py``, ``chip_smoke.py``).

Tolerances: the reduction's H, R, Q and Z within 8·n·eps of the JAX
package's, norm-wise (‖X − X_jax‖_F ≤ 8·n·eps·‖X_jax‖_F, faer's test scale;
entry-wise the two differ by more where R's diagonal is small, since each
column rotation's angle comes from R's diagonal 2×2); the QZ at the JAX
package's own tolerances (``tests/test_qz_real.py:46-62``: 5e-5 in
float32, 1e-12 in float64, times n): both backward errors, orthogonality,
the quasi-triangular S and triangular T, the eigenvalues against JAX's and
scipy's. The larger QZ cases and the singular pencils are in
``tests/test_torch_qz_real.py``, to keep each file's time short.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg as sla
import torch

from faer_tpu.linalg import qz as jqz
from faer_tpu.linalg import qz_real as jqr
import faer_tpu_torch as ft
from faer_tpu_torch.core.errors import ShapeError
from faer_tpu_torch.linalg import qz as tqz
from faer_tpu_torch.linalg import qz_real as tqr
from faer_tpu_torch.ops.kernels import hess_tri as kh
from faer_tpu_torch.ops.kernels import real_qz as kq

torch.set_num_threads(1)

DT = {"f32": (torch.float32, jnp.float32, np.float32),
      "f64": (torch.float64, jnp.float64, np.float64)}
QZ_TOL = {"f32": 5e-5, "f64": 1e-12}


@functools.lru_cache(maxsize=None)
def _jax(fn_name):
    fns = {"hess": jqz.hessenberg_triangular, "qz": jqr.real_qz,
           "pair": jqr.qz_eigenvalues_pair}
    return jax.jit(fns[fn_name])


def _pencil(n, seed, name):
    rng = np.random.default_rng(seed)
    npdt = DT[name][2]
    return rng.standard_normal((n, n)).astype(npdt), rng.standard_normal((n, n)).astype(npdt)


def match_eigs(got, ref):
    """The largest distance of a greedy nearest matching (a sort can pair
    conjugates whose real parts differ in the last bit)."""
    got = list(got)
    worst = 0.0
    for r in ref:
        i = int(np.argmin([abs(g - r) for g in got]))
        worst = max(worst, abs(got.pop(i) - r))
    return worst


def check_qz(a, b, out, tol):
    """The QZ form ``out`` = (s, t, q, z, info) of (a, b): converged, both
    backward errors and orthogonality within ``tol``·max(‖A‖, ‖B‖, 1),
    T exactly triangular, S quasi-triangular (no two adjacent subdiagonal
    entries). Returns S and T in float64."""
    s, t, q, z, info = out
    assert bool(info.converged)
    s, t, q, z = (x.double().numpy() for x in (s, t, q, z))
    n = len(a)
    scale = max(np.abs(a).max(), np.abs(b).max(), 1.0)
    assert np.abs(a - q @ s @ z.T).max() < tol * scale
    assert np.abs(b - q @ t @ z.T).max() < tol * scale
    assert np.abs(q.T @ q - np.eye(n)).max() < tol
    assert np.abs(z.T @ z - np.eye(n)).max() < tol
    assert np.abs(np.tril(t, -1)).max() == 0
    assert np.abs(np.tril(s, -2)).max() == 0
    sd = np.diag(s, -1) != 0
    assert not np.any(sd[:-1] & sd[1:])
    return s, t


def qz_eigs(s, t):
    ar, ai, be = (x.double().numpy() for x in tqr.qz_eigenvalues_pair(s, t))
    return (ar + 1j * ai) / be


@pytest.mark.parametrize("name", ["f32", "f64"])
@pytest.mark.parametrize("n", [4, 16, 48])
def test_hessenberg_triangular_matches_jax(name, n):
    """H, R, Q and Z within 8·n·eps of the JAX package's (norm-wise), H
    exactly Hessenberg and R exactly triangular, A = Q H Zᵀ and B = Q R Zᵀ."""
    tdt, jdt, npdt = DT[name]
    a, b = _pencil(n, n, name)
    got = tqz.hessenberg_triangular(torch.tensor(a), torch.tensor(b))
    ref = [np.asarray(x) for x in _jax("hess")(jnp.asarray(a), jnp.asarray(b))]
    eps = float(np.finfo(npdt).eps)
    for x, r in zip(got, ref):
        assert x.dtype == tdt and x.shape == (n, n)
        assert np.linalg.norm(x.numpy() - r) <= 8 * n * eps * np.linalg.norm(r)
    h, r, q, z = (x.double().numpy() for x in got)
    assert np.abs(np.tril(h, -2)).max() == 0 and np.abs(np.tril(r, -1)).max() == 0
    scale = 8 * n * eps * max(np.abs(a).max(), np.abs(b).max())
    assert np.abs(q @ h @ z.T - a).max() <= scale
    assert np.abs(q @ r @ z.T - b).max() <= scale


@pytest.mark.parametrize("x,z", [(1e-20, 3e-20), (-2e-20, 1e-20), (0.0, 1e-38),
                                 (5e-39, -7e-39), (1.0, 1e-20)])
def test_rotation_from_tiny_entries(x, z):
    """The rotations come from scaled entries: at magnitudes whose float32
    squares are subnormal or zero, c² + s² = 1 within 4·eps, and the
    rotation zeroes z against x."""
    eps = float(np.finfo(np.float32).eps)
    c, s = tqz._rotation(np.float32(x), np.float32(z))
    assert isinstance(c, np.float32) and isinstance(s, np.float32)
    assert abs(float(c) ** 2 + float(s) ** 2 - 1) <= 4 * eps
    assert abs(-float(s) * x + float(c) * z) <= 4 * eps * max(abs(x), abs(z))
    c, s = tqr._unit_pair(np.float32(x), np.float32(z))
    assert abs(float(c) ** 2 + float(s) ** 2 - 1) <= 4 * eps


def test_hessenberg_triangular_tiny_pencil():
    """A float32 pencil scaled to 1e-20 (entries whose squares are
    subnormal): Q and Z orthogonal within 8·n·eps, the factorization's
    relative backward errors too."""
    n = 16
    a, b = (x * np.float32(1e-20) for x in _pencil(n, 3, "f32"))
    h, r, q, z = (x.double().numpy() for x in
                  tqz.hessenberg_triangular(torch.tensor(a), torch.tensor(b)))
    tol = 8 * n * float(np.finfo(np.float32).eps)
    assert np.abs(q.T @ q - np.eye(n)).max() <= tol
    assert np.abs(z.T @ z - np.eye(n)).max() <= tol
    assert np.abs(q @ h @ z.T - a).max() <= tol * np.abs(a).max()
    assert np.abs(q @ r @ z.T - b).max() <= tol * np.abs(b).max()


@pytest.mark.parametrize("name", ["f32", "f64"])
@pytest.mark.parametrize("n", [4, 16])
def test_real_qz_matches_jax_and_scipy(name, n):
    tdt, jdt, npdt = DT[name]
    tol = QZ_TOL[name] * n
    a, b = _pencil(n, 70 + n, name)
    s, t = check_qz(a, b, tqr.real_qz(torch.tensor(a), torch.tensor(b)), tol)
    lam = qz_eigs(torch.tensor(s, dtype=tdt), torch.tensor(t, dtype=tdt))
    js, jt, *_ = _jax("qz")(jnp.asarray(a), jnp.asarray(b))
    jar, jai, jbe = (np.asarray(x, np.float64) for x in _jax("pair")(js, jt))
    lref = sla.eigvals(a.astype(np.float64), b.astype(np.float64))
    bound = tol * max(1.0, np.abs(lref).max())
    assert match_eigs(lam, lref) < bound
    assert match_eigs(lam, (jar + 1j * jai) / jbe) < bound


@pytest.mark.parametrize("name", ["f32", "f64"])
def test_qz_front_door_and_gevd_qz(name):
    """``qz`` takes a real pencil to the real QZ and keeps its dtype;
    ``gevd_qz``'s outputs are complex of the matching precision."""
    tdt = DT[name][0]
    a, b = _pencil(10, 81, name)
    s, t, q, z, info = ft.qz(torch.tensor(a), torch.tensor(b))
    assert s.dtype == tdt and bool(info.converged)
    rec = q.double() @ s.double() @ z.double().T
    assert (rec - torch.tensor(a, dtype=torch.float64)).abs().max() < 1e-4
    alpha, beta, v, _ = ft.gevd_qz(torch.tensor(a), torch.tensor(b))
    cdt = torch.complex64 if tdt == torch.float32 else torch.complex128
    assert alpha.dtype == beta.dtype == v.dtype == cdt


def test_hess_tri_batched_plain_ragged():
    """A ragged batch equals its problems run one at a time, to the bit;
    sizes outside [1, nmax] and entries past each problem are left as
    given."""
    rng = np.random.default_rng(9)
    nmax, sizes = 12, [12, 5, 1, 0, 13]
    h = torch.tensor(rng.standard_normal((5, nmax, nmax)))
    r = torch.triu(torch.tensor(rng.standard_normal((5, nmax, nmax))))
    q = torch.eye(nmax, dtype=torch.float64).repeat(5, 1, 1)
    z = q.clone()
    out = kh.hess_tri_batched(h, r, q, z, torch.tensor(sizes, dtype=torch.int32))
    for bi, n in enumerate(sizes):
        if 1 <= n <= nmax:
            one = tqz.hessenberg_triangular_plain(h[bi, :n, :n], r[bi, :n, :n],
                                                  q[bi, :n, :n], z[bi, :n, :n])
            assert all(torch.equal(o[bi, :n, :n], x) for o, x in zip(out, one))
            assert all(torch.equal(o[bi, n:], x[bi, n:]) for o, x in zip(out, (h, r, q, z)))
        else:
            assert all(torch.equal(o[bi], x[bi]) for o, x in zip(out, (h, r, q, z)))


def test_kernel_wrappers_refuse():
    x = torch.zeros(1, 4, 4)
    sizes = torch.tensor([4], dtype=torch.int32)
    with pytest.raises(TypeError):
        kh.hess_tri_batched(x, x, x, x.double(), sizes)
    with pytest.raises(ShapeError):
        kh.hess_tri_batched(x, x, x, torch.zeros(1, 5, 5), sizes)
    with pytest.raises(TypeError):
        kh.hess_tri_batched(x, x, x, x, sizes.long())
    with pytest.raises(ValueError):
        kq.real_qz_batched(x, x, x, x, sizes, max_sweeps_factor=-1)
    with pytest.raises(ValueError):
        kq.real_qz_batched(x, x, x, x.transpose(1, 2), sizes)
    with pytest.raises(ShapeError):
        ft.real_qz(torch.zeros(3, 3), torch.zeros(3, 4))
    with pytest.raises(TypeError):
        ft.real_qz(torch.zeros(3, 3), torch.zeros(3, 3, dtype=torch.float64))
    with pytest.raises(NotImplementedError, match="qz"):
        ft.real_qz(torch.eye(3, dtype=torch.complex64), torch.eye(3, dtype=torch.complex64))
