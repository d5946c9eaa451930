"""The regrouped bidiagonal divide & conquer (every leaf, wide and square,
formed up front and solved in one batched QR call, then the merges in the
recursion's order) at 300 against ``faer_tpu``'s D&C and f64 numpy: the
square ``bidiag_svd_dnc`` and the wide (300, 301) ``_dnc(d, e, 1)``.

A companion of ``tests/test_torch_spectral_batched.py``, split from it
because each JAX D&C compile takes some 15 s on the CPU. Inputs are made
with numpy from a seed; the JAX drivers run under ``jax.jit``
(their costliest LLVM passes off, ``_jax``). Tolerances:
faer's 8·n·eps_f32 rule (``utils/approx.py``), relative to the largest
singular value, and to 1 for the orthogonality.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

import faer_tpu.linalg.bidiag_dnc as jbd
import faer_tpu.linalg.bidiag_svd as jbs
from faer_tpu_torch.core.config import host_reads, reset_launch_counts
from faer_tpu_torch.linalg import bidiag_dnc
from faer_tpu_torch.linalg import bidiag_svd as tbs

torch.set_num_threads(1)

EPS32 = float(np.finfo(np.float32).eps)


def _t(x):
    return torch.from_numpy(np.array(x))  # a writable copy


def _jax(fn, *args, static=()):
    """``fn(*args)`` under ``jax.jit``, compiled with XLA's costliest LLVM
    passes off: the JAX D&C compile is most of this file's time, and its
    values are held to 8·n·eps either way."""
    exe = jax.jit(fn, static_argnums=static).lower(*args).compile(
        {"xla_llvm_disable_expensive_passes": True, "xla_backend_optimization_level": 0})
    return exe(*(a for i, a in enumerate(args) if i not in static))


def _close(got, want, n, scale):
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64)).max()
    assert err <= 8 * n * EPS32 * max(scale, 1e-30), err


def _bidiag(d, e):
    n = len(d)
    return np.diag(np.asarray(d, np.float64)) + np.diag(np.asarray(e[:n - 1], np.float64), 1)


def test_bidiag_svd_dnc_at_300_matches_jax_and_f64():
    """The regrouped bidiagonal D&C (every leaf, wide and square, in one
    batched call) against the JAX package's D&C and f64 numpy."""
    rng = np.random.default_rng(301)
    n = 300
    d0 = rng.standard_normal(n).astype(np.float32)
    e0 = rng.standard_normal(n - 1).astype(np.float32)
    reset_launch_counts()
    s, u, v, info = tbs.bidiag_svd(_t(d0), _t(e0), use_dnc=True)
    assert host_reads() == 0 and bool(info.converged)
    sj = _jax(functools.partial(jbs.bidiag_svd, use_dnc=True),
              jnp.asarray(d0), jnp.asarray(e0))[0]
    bm = _bidiag(d0, e0)
    s64 = np.linalg.svd(bm, compute_uv=False)
    _close(s.numpy(), s64, n, s64[0])
    _close(s.numpy(), sj, n, s64[0])
    un, vn = u.numpy().astype(np.float64), v.numpy().astype(np.float64)
    _close(un * s.numpy()[None, :] @ vn.T, bm, n, s64[0])
    _close(un.T @ un, np.eye(n), n, 1.0)
    _close(vn.T @ vn, np.eye(n), n, 1.0)


def test_wide_bidiag_dnc_at_300_matches_jax_and_f64():
    """``_dnc(d, e, 1)`` of a (300, 301) upper bidiagonal: its leaves are
    wide (the upper halves) and one square; U (300, 300), s (301, the last
    the null root), W (301, 301)."""
    rng = np.random.default_rng(302)
    m = 300
    d0 = rng.standard_normal(m).astype(np.float32)
    e0 = rng.standard_normal(m).astype(np.float32)
    reset_launch_counts()
    u, s, w = bidiag_dnc._dnc(_t(d0), _t(e0), 1)
    assert host_reads() == 0
    assert tuple(u.shape) == (m, m) and tuple(s.shape) == (m + 1,) and tuple(w.shape) == (m + 1, m + 1)
    _, sj, _ = _jax(jbd._dnc, jnp.asarray(d0), jnp.asarray(e0), 1, static=(2,))
    b = np.zeros((m, m + 1))
    b[np.arange(m), np.arange(m)] = d0
    b[np.arange(m), np.arange(m) + 1] = e0
    s64 = np.linalg.svd(b, compute_uv=False)
    sn = s.numpy().astype(np.float64)
    _close(sn[:m], s64, m, s64[0])
    _close(sn[:m], np.asarray(sj)[:m], m, s64[0])
    assert abs(sn[m]) <= 8 * m * EPS32 * s64[0]
    sig = np.zeros((m, m + 1))
    sig[np.arange(m), np.arange(m)] = sn[:m]
    un, wn = u.numpy().astype(np.float64), w.numpy().astype(np.float64)
    _close(un @ sig @ wn.T, b, m, s64[0])
    _close(un.T @ un, np.eye(m), m, 1.0)
    _close(wn.T @ wn, np.eye(m + 1), m, 1.0)
