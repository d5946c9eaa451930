"""The regrouped tridiagonal divide & conquer (every leaf formed up front
and solved in one batched QR call, then the merges in the recursion's
order) at n = 1000 (16 leaves of 62 and 63) against ``faer_tpu``'s D&C and
f64 numpy.

A companion of ``tests/test_torch_spectral_batched.py``, split from it
because the JAX D&C compile takes some 15 s on the CPU. Inputs are made
with numpy from a seed; the JAX driver runs under ``jax.jit``
(its costliest LLVM passes off, ``_jax``). Tolerances:
faer's 8·n·eps_f32 rule (``utils/approx.py``), relative to the largest
eigenvalue, and to 1 for the orthogonality.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

import faer_tpu.linalg.tridiag_evd as jte
from faer_tpu_torch.core.config import host_reads, reset_launch_counts
from faer_tpu_torch.linalg import tridiag_dnc

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


def test_tridiag_evd_dnc_at_1000_matches_jax_and_f64():
    rng = np.random.default_rng(1000)
    n = 1000
    d0 = rng.standard_normal(n).astype(np.float32)
    e0 = rng.standard_normal(n - 1).astype(np.float32)
    reset_launch_counts()
    w, z, info = tridiag_dnc.tridiag_evd_dnc(_t(d0), _t(e0))
    assert host_reads() == 0 and bool(info.converged) and int(info.iterations) > 0
    wj, _, _ = _jax(functools.partial(jte.tridiag_evd, use_dnc=True),
                    jnp.asarray(d0), jnp.asarray(e0))
    t = np.diag(d0.astype(np.float64)) + np.diag(e0, 1) + np.diag(e0, -1)
    w64 = np.linalg.eigvalsh(t)
    scale = np.abs(w64).max()
    _close(w.numpy(), w64, n, scale)
    _close(w.numpy(), wj, n, scale)
    zn = z.numpy().astype(np.float64)
    _close(t @ zn, zn * w.numpy()[None, :], n, scale)
    _close(zn.T @ zn, np.eye(n), n, 1.0)
