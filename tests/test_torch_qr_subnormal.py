"""F2: the float32 Householder QR at a scale whose squares are subnormal.

A Gaussian scaled by 1e-20 has float32 squares near 1e-40, below the
smallest normal number: unscaled, the column norms lost bits and the QR
reconstructed to 56–63·n·eps. The reflectors now form the norm on the
column scaled by an exact power of two where ‖x‖² is below tiny/eps
(``ops/householder.py:rescale_of``; the same formula in the plain twins
and in ``csrc/qr_panel.cu``; ``make_householder`` tests max|x|² against
the same threshold, one reduction), and above that threshold every bit is as
before (held here against copies of the unscaled formulas). The kernel's
own cases run on the card (``tests/test_torch_gpu.py``).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from faer_tpu_torch.linalg import qr as tqr
from faer_tpu_torch.linalg import qz as tqz
from faer_tpu_torch.ops import householder as hh
from faer_tpu_torch.ops.kernels import qr_panel as kq
from faer_tpu_torch.ops.kernels import qr_panel_v1 as kq1

torch.set_num_threads(1)
EPS32 = float(np.finfo(np.float32).eps)
SEEDS = range(20)


def _gaussian(n, seed, scale=1e-20, m=None):
    g = np.random.default_rng(seed).standard_normal((m or n, n)).astype(np.float32)
    return torch.from_numpy(g * np.float32(scale))


@pytest.mark.parametrize("n", [4, 5, 16, 64])
def test_qr_in_place_at_a_subnormal_scale(n):
    """max|QR − B|/max|B| and max|QᵀQ − I| within 8·n·eps over 20 seeds."""
    tol = 8 * n * EPS32
    for seed in SEEDS:
        b = _gaussian(n, seed)
        packed, ts, block = tqr.qr_in_place(b)
        q = tqr.qr_compute_q(packed, ts, block).double()
        rec = tqr.qr_reconstruct(packed, ts, block)
        assert ((rec - b).abs().max() / b.abs().max()).item() <= tol
        assert (q.T @ q - torch.eye(n, dtype=torch.float64)).abs().max().item() <= tol


@pytest.mark.parametrize("n", [4, 5, 16])
def test_hessenberg_triangular_at_a_subnormal_scale(n):
    """The QR of B carries the repair into the pencil's reduction: Q, Z
    orthogonal and both backward errors within 8·n·eps."""
    tol = 8 * n * EPS32
    for seed in range(5):
        a, b = _gaussian(n, 2 * seed), _gaussian(n, 2 * seed + 1)
        h, r, q, z = (x.double() for x in tqz.hessenberg_triangular(a, b))
        eye = torch.eye(n, dtype=torch.float64)
        assert (q.T @ q - eye).abs().max().item() <= tol
        assert (z.T @ z - eye).abs().max().item() <= tol
        assert ((q @ h @ z.T - a.double()).abs().max() / a.abs().max()).item() <= tol
        assert ((q @ r @ z.T - b.double()).abs().max() / b.abs().max()).item() <= tol


@pytest.mark.parametrize("name", ["qr_panel_plain", "qr_panel_onepass_plain",
                                  "qr_panel_v1_plain"])
@pytest.mark.parametrize("m,b", [(40, 16), (300, 64), (7, 12)])
def test_plain_twins_at_a_subnormal_scale(name, m, b):
    """Each plain twin of the kernel reconstructs a 1e-20 panel within
    8·m·eps (f64 Q), τ in [1, 2] or 0."""
    fn = getattr(kq1 if name == "qr_panel_v1_plain" else kq, name)
    a = _gaussian(b, m, m=m)
    packed, taus = fn(a)
    k = min(m, b)
    pk = packed.double()
    v = torch.tril(pk[:, :k], -1) + torch.eye(m, k, dtype=torch.float64)
    q = torch.eye(m, dtype=torch.float64)
    for j in range(k - 1, -1, -1):
        q -= taus[j].double() * torch.outer(v[:, j], v[:, j] @ q)
    tol = 8 * m * EPS32
    assert (q.T @ q - torch.eye(m, dtype=torch.float64)).abs().max().item() <= tol
    assert ((q @ torch.triu(pk) - a.double()).abs().max() / a.abs().max()).item() <= tol
    assert bool(((taus == 0) | ((taus >= 1) & (taus <= 2))).all())


def _onepass_unscaled(panel):
    """The kernel's one-pass order with the norm from unscaled squares, as
    before the repair."""
    m, b = panel.shape
    a = panel.clone()
    taus = panel.new_zeros(min(m, b))
    one = panel.new_ones(())
    for j in range(min(m, b)):
        alpha, tail = a[j, j].clone(), a[j + 1:, j].clone()
        tail_sq = (tail * tail).sum()
        shares = tail @ a[j + 1:, j + 1:]
        norm = torch.sqrt(alpha * alpha + tail_sq)
        beta = torch.where(alpha >= 0, -norm, norm)
        is_id = tail_sq == 0
        tau = torch.where(is_id, 0.0, (beta - alpha) / torch.where(is_id, one, beta))
        s = torch.where(is_id, one, 1.0 / torch.where(is_id, one, alpha - beta))
        w = a[j, j + 1:] + s * shares
        v = torch.where(is_id, 0.0, tail * s)
        a[j, j + 1:] -= tau * w
        a[j + 1:, j + 1:] -= (tau * v)[:, None] * w[None, :]
        a[j, j] = torch.where(is_id, alpha, beta)
        a[j + 1:, j] = v
        taus[j] = tau
    return a, taus


def _householder_unscaled(x):
    alpha, tail = x[0], x[1:]
    tail_sq = (tail * tail).sum()
    one = x.new_ones(())
    norm = torch.sqrt(alpha * alpha + tail_sq)
    beta = -torch.where(alpha >= 0, one, -one) * norm
    is_id = tail_sq == 0
    safe_s = torch.where(is_id, one, alpha - beta)
    tau = torch.where(is_id, 0.0, (beta - alpha) / torch.where(is_id, one, beta))
    v = torch.cat([x.new_ones(1), torch.where(is_id, 0.0, tail / safe_s)])
    return v, tau, torch.where(is_id, alpha, beta)


@pytest.mark.parametrize("scale", [1.0, 1e-12, 1e12])
def test_scale_one_results_unchanged(scale):
    """Above the threshold the scale is 1: the one-pass twin and
    ``make_householder`` are bitwise the unscaled formulas, in float32 and
    float64; at 1e-20 the rescaled branch runs (and differs)."""
    for seed in range(3):
        a = _gaussian(24, seed, scale=scale, m=60)
        assert all(torch.equal(x, y) for x, y in zip(kq.qr_panel_onepass_plain(a),
                                                     _onepass_unscaled(a)))
        for dt in (torch.float32, torch.float64):
            col = a[:, 0].to(dt)
            assert all(torch.equal(x, y) for x, y in zip(hh.make_householder(col),
                                                         _householder_unscaled(col)))
    tiny = _gaussian(24, 0, m=60)
    assert not torch.equal(kq.qr_panel_onepass_plain(tiny)[0], _onepass_unscaled(tiny)[0])
    assert not torch.equal(hh.make_householder(tiny[:, 0])[0],
                           _householder_unscaled(tiny[:, 0])[0])


@pytest.mark.parametrize("dtype,thresh,scale", [
    (torch.float32, 2.0 ** -103, 2.0 ** 64), (torch.float64, 2.0 ** -970, 2.0 ** 512),
    (torch.complex64, 2.0 ** -103, 2.0 ** 64), (torch.complex128, 2.0 ** -970, 2.0 ** 512)])
def test_norm_rescale_constants(dtype, thresh, scale):
    """tiny/eps and the power of two, per real field; ``rescale_of`` picks
    it only below the threshold."""
    assert hh.norm_rescale(dtype) == (thresh, scale)
    rdt = dtype.to_real()
    assert hh.rescale_of(torch.tensor(thresh / 2, dtype=rdt)).item() == scale
    assert hh.rescale_of(torch.tensor(thresh, dtype=rdt)).item() == 1.0


@pytest.mark.parametrize("dtype,scale", [(torch.float32, 1e-20), (torch.float64, 1e-170),
                                         (torch.complex64, 1e-20),
                                         (torch.complex128, 1e-170)])
def test_make_householder_at_a_tiny_scale(dtype, scale):
    """(I − τ v vᴴ)ᴴ x = β e₁ relative to ‖x‖ within 8·m·eps, |β| = ‖x‖."""
    m = 9
    rng = np.random.default_rng(5)
    x = rng.standard_normal(m) + (1j * rng.standard_normal(m) if dtype.is_complex else 0)
    x = torch.from_numpy(x * scale).to(dtype)
    v, tau, beta = hh.make_householder(x)
    xd = x.to(torch.complex128)
    h = torch.eye(m, dtype=torch.complex128) - tau.to(torch.complex128) * torch.outer(
        v.to(torch.complex128), v.to(torch.complex128).conj())
    y = h.mH @ xd
    nx = np.linalg.norm(xd.numpy() / scale) * scale  # numpy's squares underflow
    tol = 8 * m * float(torch.finfo(dtype.to_real()).eps)
    assert abs(abs(beta.item()) - nx) <= tol * nx
    assert (y[1:].abs().max() / nx).item() <= tol
    assert abs((y[0] - beta.to(torch.complex128)).item()) <= tol * nx
