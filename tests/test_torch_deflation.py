"""The D&C merges' pair deflation (``_pair_deflation``) on tiny tear components.

Both merges, the tridiagonal ``_merge`` and the bidiagonal ``_svd_merge``,
rotate each close pair of poles with the (c, s) of ``_pair_deflation``. The
JAX package forms r = sqrt(zc² + z²) (``faer_tpu/linalg/tridiag_dnc.py``
``defl_step``); XLA flushes f32 subnormals to zero, PyTorch keeps them, so
the port forms r = hypot(zc, z). Below about 1e-19 the f32 squares are
subnormal and the reference's formula would give (c, s) that are no
rotation, and eigenvectors far from orthogonal when eigenvalues repeat.

Tolerances: c² + s² = 1 within 4·eps_f32 (two roundings of each square and
one of the sum); faer's 8·n·eps_f32 rule (``utils/approx.py``) for the EVD's
orthogonality and residual, against an f64 oracle.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faer_tpu_torch.linalg.evd import self_adjoint_evd
from faer_tpu_torch.linalg.tridiag_dnc import _pair_deflation

torch.set_num_threads(1)

EPS32 = float(np.finfo(np.float32).eps)


def _jax_defl(z_s, close):
    """The JAX package's deflation scan (``tridiag_dnc.py`` ``defl_step``,
    the same formula in ``bidiag_dnc.py``), as (z', c, s)."""
    def defl_step(zc, xs):
        z_next, close_j = xs
        r = jnp.sqrt(zc * zc + z_next * z_next)
        safe_r = jnp.where(r == 0, 1.0, r)
        c = jnp.where(close_j, jnp.where(r == 0, 1.0, zc / safe_r), 1.0)
        s = jnp.where(close_j, jnp.where(r == 0, 0.0, z_next / safe_r), 0.0)
        z_out = jnp.where(close_j, r, zc)
        carry = jnp.where(close_j, 0.0, z_next)
        return carry, (z_out, c, s)

    z = jnp.asarray(z_s, jnp.float32)
    z_last, (z_head, c, s) = jax.lax.scan(
        defl_step, z[0], (z[1:], jnp.asarray(close[:-1])))
    out = jnp.concatenate([z_head, z_last[None]])
    return (np.asarray(out, np.float32), np.asarray(c, np.float32),
            np.asarray(s, np.float32))


# (z, close): pairs 0 and 1 close, tails in the subnormal range of squares;
# a mixed case with a far pole between close pairs
SUBNORMAL = [((3e-20, 1e-20, 2e-21, 0.5), (True, True, False, False)),
             ((1e-22, -4e-23, 7e-21, 2e-20, 0.25), (True, False, True, False, False))]


@pytest.mark.parametrize("z,close", SUBNORMAL)
def test_pair_deflation_keeps_rotations_in_the_subnormal_range(z, close):
    z_s = torch.tensor(z, dtype=torch.float32)
    cl = torch.tensor(close)
    z2, c, s = _pair_deflation(z_s, cl)
    c64, s64 = c.double(), s.double()
    assert ((c64 * c64 + s64 * s64 - 1).abs() <= 4 * EPS32).all()
    # the rotation moves z_{j+1} onto z_j: r carries the pair's norm
    for j in np.flatnonzero(np.asarray(close[:-1])):
        zc = 0.0 if j > 0 and close[j - 1] else z[j]
        want = float(np.hypot(np.float64(zc), np.float64(z[j + 1])))
        assert abs(z2[j].item() - want) <= 4 * EPS32 * want
        assert z2[j + 1].item() == 0.0 or close[j + 1]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pair_deflation_matches_the_reference_formula_on_normal_z(seed):
    """Where the squares stay normal, hypot and sqrt(zc² + z²) agree to a few
    roundings: the port's (z', c, s) equal the JAX scan's within 4·eps."""
    rng = np.random.default_rng(seed)
    n = 33
    z = (rng.standard_normal(n) * 10.0 ** rng.uniform(-8, 2, n)).astype(np.float32)
    close = rng.random(n) < 0.5
    close[-1] = False
    got = _pair_deflation(torch.from_numpy(z.copy()), torch.from_numpy(close.copy()))
    want = _jax_defl(z, close)
    for g, w in zip(got, want):
        g = g.double().numpy()
        w = w.astype(np.float64)
        assert np.all(np.abs(g - w) <= 4 * EPS32 * np.maximum(np.abs(w), np.abs(g)))


@pytest.mark.parametrize("seed", [0, 7])
def test_self_adjoint_evd_repeated_eigenvalues_stay_orthogonal(seed):
    """A = Q·diag(+1 ×256, −1 ×256)·Qᵀ at n = 512 (the D&C route): two
    eigenvalues of multiplicity 256, so the merges deflate many close pairs
    with tear components near 1e-20. Before the repair max|VᵀV − I| was
    0.36 (seed 0) and 0.48 (seed 7)."""
    n = 512
    torch.manual_seed(seed)
    q, _ = torch.linalg.qr(torch.randn(n, n, dtype=torch.float64))
    sign = torch.cat([torch.ones(n // 2, dtype=torch.float64),
                      -torch.ones(n // 2, dtype=torch.float64)])
    a = ((q * sign) @ q.T).float()
    w, v, info = self_adjoint_evd(a)
    tol = 8 * n * EPS32
    v64, w64, a64 = v.double(), w.double(), a.double()
    orth = (v64.T @ v64 - torch.eye(n, dtype=torch.float64)).abs().max().item()
    res = (torch.linalg.matrix_norm(a64 @ v64 - v64 * w64)
           / torch.linalg.matrix_norm(a64)).item()
    oracle = torch.linalg.eigvalsh(a64)
    assert orth <= tol
    assert res <= tol
    assert (w64 - oracle).abs().max().item() <= tol * oracle.abs().max().item()
