"""The port's bidiagonal divide & conquer (``linalg/bidiag_dnc.py``) on wide
bidiagonals: the golden fixtures of the reference's own tests
(``tests/test_bidiag_dnc.py``) and a small one whose sub-block has an exact
zero singular value.

A wide (n, n+1) upper bidiagonal goes through ``_dnc(d, e, 1)``, which
returns U (n, n), s (n + 1, the last the null root) and W (n+1, n+1). The
bounds are the reference's: ‖U diag(s) Wᵀ − B‖ ≤ c·‖B‖, ‖UᵀU − I‖_F ≤ c·n,
‖WᵀW − I‖_F ≤ c·(n+1), with c = 1e-4 for the tier-1 fixtures and 2e-4 for
the large ones (``slow``). The singular values are held against the JAX
package's ``_dnc`` and f64 numpy within 8·n·eps_f32 of the largest.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faer_tpu.linalg.bidiag_dnc import _dnc as jax_dnc
from faer_tpu_torch.linalg.bidiag_dnc import _dnc

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "data", "svd")
EPS32 = float(np.finfo(np.float32).eps)


def parse_bidiag(path):
    """The fixture format of ``tests/test_bidiag_dnc.py``: an (n+1)×n lower
    bidiagonal, whose transpose is our (n, n+1) wide upper bidiagonal."""
    diag, sub, cur = [], [], None
    for line in open(path):
        line = line.strip().rstrip(",")
        if line == "diag":
            cur = diag
            continue
        if line == "subdiag":
            cur = sub
            continue
        if line:
            cur.append(float(line))
    return np.array(diag), np.array(sub)


def _wide(d, e):
    n = d.shape[0]
    b = np.zeros((n, n + 1))
    b[np.arange(n), np.arange(n)] = d
    b[np.arange(n), np.arange(n) + 1] = e
    return b


def _check_wide(d, e, c):
    """The port's ``_dnc(d, e, 1)`` in f32 under the reference's bounds;
    returns its singular values (n,) in f64."""
    n = d.shape[0]
    u, s, w = _dnc(torch.tensor(d, dtype=torch.float32),
                   torch.tensor(e, dtype=torch.float32), 1)
    assert tuple(u.shape) == (n, n) and tuple(s.shape) == (n + 1,)
    assert tuple(w.shape) == (n + 1, n + 1)
    un, wn, sn = u.double().numpy(), w.double().numpy(), s.double().numpy()
    b = _wide(d, e)
    sig = np.zeros((n, n + 1))
    sig[np.arange(n), np.arange(n)] = sn[:n]
    nb = max(1.0, np.linalg.norm(b))
    assert np.linalg.norm(un @ sig @ wn.T - b) <= c * nb
    # no left vector may vanish: the fault this file guards against
    assert np.linalg.norm(un, axis=0).min() >= 0.5
    assert np.linalg.norm(un.T @ un - np.eye(n)) <= c * n
    assert np.linalg.norm(wn.T @ wn - np.eye(n + 1)) <= c * (n + 1)
    assert np.all(sn[:-1] >= sn[1:]) and np.all(sn >= 0)
    sref = np.linalg.svd(b, compute_uv=False)
    assert np.abs(sn[:n] - sref).max() <= 8 * n * EPS32 * max(1.0, sref[0])
    return sn[:n]


def test_zero_singular_value_of_a_sub_block_keeps_u_orthonormal():
    """A (129, 130) wide bidiagonal with a zero row (d₁₀ = e₁₀ = 0) in its
    left (64, 65) leaf: that leaf has an exact zero singular value, so the top
    merge has three zero poles, the z row's, the leaf's and the extra
    column's. Sorted as they came, the leaf's (which owns a row of U) sat
    between the two row-less ones, they did not pair-deflate, the extra
    pole kept a tiny z, and the root beside it took a left vector made of
    its row-less component alone: a zero column of U, ‖UᵀU − I‖_F = 1."""
    rng = np.random.default_rng(0)
    d = rng.uniform(0.1, 1.0, 129)
    e = rng.uniform(0.1, 1.0, 129)
    d[10] = e[10] = 0.0
    s = _check_wide(d, e, 1e-4)
    assert s[-1] <= 8 * 129 * EPS32  # the zero row's singular value


@pytest.mark.parametrize("name", ["svd64.txt", "svd128.txt"])
def test_golden_fixture_small(name):
    diag, sub = parse_bidiag(os.path.join(DATA, name))
    n = diag.shape[0]
    s = _check_wide(diag, sub, 1e-4)
    # under jit, as tests/test_torch_spectral.py calls the JAX drivers:
    # eagerly every loop recompiles per call
    _, sj, _ = jax.jit(jax_dnc, static_argnums=2)(
        jnp.asarray(diag, jnp.float32), jnp.asarray(sub, jnp.float32), 1)
    sj = np.asarray(sj, np.float64)[:n]
    assert np.abs(s - sj).max() <= 8 * n * EPS32 * max(1.0, sj[0])


@pytest.mark.slow
@pytest.mark.parametrize("name", ["svd512.txt", "svd1024_0.txt", "svd1024_1.txt",
                                  "svd1024_2.txt"])
def test_golden_fixture_large(name):
    diag, sub = parse_bidiag(os.path.join(DATA, name))
    _check_wide(diag, sub, 2e-4)
