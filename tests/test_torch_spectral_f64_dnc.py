"""The port's float64 spectral entry points on their divide & conquer
route (n = 512: the tridiagonal or bidiagonal problem split into leaves,
every leaf solved in one batched QR call, then the merges) against f64
numpy: a companion of ``tests/test_torch_spectral_f64.py``, split from it
to keep each file's time short.

Inputs are made with numpy from a seed. The port side runs the plain
versions of its batched QR kernels, which take float64 as the CUDA kernels
do. Held against numpy only: the JAX package's D&C takes some 20 s a call
to compile on the CPU. Tolerances: faer's 8·n·eps rule in float64,
relative to the largest eigenvalue or singular value, for the values, the
residuals and the orthogonality.
"""
import numpy as np
import torch

import faer_tpu_torch as ft

torch.set_num_threads(1)

EPS64 = float(np.finfo(np.float64).eps)
N = 512


def _tol(n):
    return 8 * n * EPS64


def test_self_adjoint_evd_f64_dnc():
    g = np.random.default_rng(N).standard_normal((N, N))
    a = (g + g.T) / 2
    w, v, info = ft.self_adjoint_evd(torch.tensor(a))
    assert w.dtype == v.dtype == torch.float64 and bool(info.converged)
    wn, vn = w.numpy(), v.numpy()
    scale = np.abs(wn).max()
    assert np.abs(wn - np.linalg.eigvalsh(a)).max() <= _tol(N) * scale
    assert np.linalg.norm(a @ vn - vn * wn) <= _tol(N) * scale * np.sqrt(N)
    assert np.abs(vn.T @ vn - np.eye(N)).max() <= _tol(N)
    assert np.abs(ft.self_adjoint_eigenvalues(torch.tensor(a)).numpy() - wn).max() \
        <= _tol(N) * scale


def test_svd_f64_dnc():
    g = np.random.default_rng(2 * N).standard_normal((N, N))
    u, s, v, info = ft.svd(torch.tensor(g))
    assert s.dtype == torch.float64 and bool(info.converged)
    un, sn, vn = u.numpy(), s.numpy(), v.numpy()
    ref = np.linalg.svd(g, compute_uv=False)
    assert np.abs(sn - ref).max() <= _tol(N) * ref[0]
    assert np.linalg.norm((un * sn) @ vn.T - g) <= _tol(N) * ref[0] * np.sqrt(N)
    assert np.abs(un.T @ un - np.eye(N)).max() <= _tol(N)
    assert np.abs(vn.T @ vn - np.eye(N)).max() <= _tol(N)
    assert np.abs(ft.singular_values(torch.tensor(g)).numpy() - sn).max() \
        <= _tol(N) * ref[0]
