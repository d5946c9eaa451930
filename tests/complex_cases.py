"""Inputs and comparisons shared by the complex test files of the port
(``test_torch_complex_*.py``): complex64 and complex128 at n ∈ {1, 2, 7,
33, 130}, made from a numpy seed; faer's 8·n·eps rule of the dtype
(``faer_tpu_torch/utils/approx.py``)."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import torch

from faer_tpu_torch.utils.approx import assert_approx_eq

DTYPES = {"c64": (torch.complex64, np.complex64), "c128": (torch.complex128, np.complex128)}
SIZES = (1, 2, 7, 33, 130)


def eps(npdt) -> float:
    return float(np.finfo(npdt).eps)


def inputs(n, npdt, seed=0, m=None):
    """(g gᴴ/n + I, (g + gᴴ)/2, an (m or n, 3) right-hand side, g) with g
    an (m or n, n) complex Gaussian."""
    rng = np.random.default_rng(1000 * n + seed)
    m = m or n
    g = rng.standard_normal((m, n)) + 1j * rng.standard_normal((m, n))
    b = rng.standard_normal((m, 3)) + 1j * rng.standard_normal((m, 3))
    k = min(m, n)
    sq = g[:k, :k]
    return ((sq @ sq.conj().T / k + np.eye(k)).astype(npdt),
            ((sq + sq.conj().T) / 2).astype(npdt), b.astype(npdt), g.astype(npdt))


def close(got, want, n, npdt, msg=""):
    """Entrywise within 8·n·eps, absolutely against the largest entry."""
    got, want = np.asarray(got), np.asarray(want)
    tol = 8 * n * eps(npdt) * max(np.abs(want).max(initial=0.0), 1e-30)
    assert_approx_eq(got, want, abs_tol=tol, scale=8 * n, msg=msg)


def backward(a, x, b, n, npdt):
    """‖A x − b‖ / (‖A‖ ‖x‖) in complex128 within 8·n·eps."""
    a, x = np.asarray(a, np.complex128), np.asarray(x, np.complex128)
    r = np.linalg.norm(a @ x - b) / (np.linalg.norm(a) * max(np.linalg.norm(x), 1e-300))
    assert r <= 8 * n * eps(npdt), r


def lstsq_backward(a, x, b, n, npdt):
    """The least-squares optimality ‖Aᴴ r‖ / (‖A‖ ‖r‖) within 8·n·eps."""
    a, x = np.asarray(a, np.complex128), np.asarray(x, np.complex128)
    r = b - a @ x
    q = np.linalg.norm(a.conj().T @ r) / (np.linalg.norm(a) * max(np.linalg.norm(r), 1e-300))
    assert q <= 8 * n * eps(npdt), q


def pair(x):
    """A complex array as the JAX package's (re, im) pair."""
    return jnp.asarray(x.real), jnp.asarray(x.imag)


def from_pair(re, im):
    return np.asarray(re) + 1j * np.asarray(im)


def phase_aligned(v, ref):
    """``v``'s columns each times the unit phase that best aligns it with
    ``ref``'s (eigen- and singular vectors are unique up to one)."""
    v, ref = np.asarray(v, np.complex128), np.asarray(ref, np.complex128)
    dots = np.sum(v.conj() * ref, axis=0)
    ph = np.where(np.abs(dots) == 0, 1.0, dots / np.where(np.abs(dots) == 0, 1.0, np.abs(dots)))
    return v * ph[None, :]


def vectors_close(v, ref, values, n, npdt, phases=None):
    """Each column of ``v`` times a unit phase (``phases``, else the one
    that best aligns it) equals ``ref``'s within 8·n·eps·max(1, spread/gap)
    of the column's largest entry: the first-order bound of a vector
    whose value (of ``values``, the oracle's) is ``gap`` from the nearest
    other one (Davis–Kahan)."""
    v, ref = np.asarray(v, np.complex128), np.asarray(ref, np.complex128)
    w = np.asarray(values, np.float64)
    spread = max(np.abs(w).max(), 1e-300)
    gap = np.array([np.min(np.abs(np.delete(w, i) - w[i]), initial=np.inf)
                    for i in range(len(w))])
    cond = np.maximum(1.0, spread / np.maximum(gap, 1e-300))
    va = v * phases[None, :] if phases is not None else phase_aligned(v, ref)
    err = np.abs(va - ref).max(axis=0, initial=0.0)
    bound = 8 * n * eps(npdt) * cond * np.abs(ref).max(axis=0, initial=0.0)
    assert np.all(err <= bound), (err / bound).max()
