"""SVD of a real upper-bidiagonal matrix: implicit-shift Golub–Kahan QR
(counterpart of ``faer_tpu/linalg/bidiag_svd.py``).

faer ``bidiag_svd`` QR-algorithm path (``svd/bidiag_svd.rs:274``); large n
routes to divide & conquer (``bidiag_dnc.py``). Each iteration zeroes the
negligible off-diagonals and diagonals, finds the unreduced block [l, m],
and then splits at a zero diagonal with a row or column chase, advances l,
or runs one shifted sweep through the ``bidiag_sweep`` kernel, whose right
and left rotation chains V and U absorb as a few small GEMMs.

The JAX package runs the iteration as one ``lax.while_loop`` on the device.
Here the host drives it, with one read of (m, zero diagonal?, where) per
iteration (``core.config.host_read``); the sweep and everything else stay
on the device. The chases (rare: an exactly negligible diagonal) run their
rotations as host-issued steps over the block only.
"""
from __future__ import annotations

import torch

from faer_tpu_torch.core import dtypes
from faer_tpu_torch.core.config import host_read
from faer_tpu_torch.linalg.tridiag_evd import (
    _apply_rotation_chain,
    _givens_real,
    _info,
    _wilkinson_shift,
)
from faer_tpu_torch.ops.kernels.sweep import bidiag_sweep


def _rotate_cols(x, i: int, j: int, c, s) -> None:
    """Columns (i, j) of ``x`` ← (c·x_i + s·x_j, −s·x_i + c·x_j), in place."""
    xi, xj = x[:, i].clone(), x[:, j].clone()
    x[:, i] = c * xi + s * xj
    x[:, j] = -s * xi + c * xj


def _row_chase(d, e, u, i0: int, m: int) -> None:
    """d[i0] == 0 with e[i0] ≠ 0: left rotations push row i0's off-diagonal
    rightwards until it vanishes (dbdsqr splitting), decoupling i0 from the
    rest of the block; U absorbs them. In place."""
    n = d.shape[0]
    b = e[i0].clone()
    e[i0] = 0.0
    for k in range(i0 + 1, m + 1):
        c, s, r = _givens_real(d[k], b)
        d[k] = r
        kk = min(k, n - 2)
        e_k = e[kk].clone()
        if k < m:
            e[kk] = c * e_k
            b = -s * e_k
        if u is not None:
            _rotate_cols(u, k, i0, c, s)


def _col_chase(d, e, v, l: int, m: int) -> None:
    """d[m] == 0 with e[m−1] ≠ 0: right rotations push column m's
    off-diagonal upwards until it vanishes; V absorbs them. In place."""
    b = e[m - 1].clone()
    e[m - 1] = 0.0
    for k in range(m - 1, l - 1, -1):
        c, s, r = _givens_real(d[k], b)
        d[k] = r
        if k > l:
            e_km1 = e[k - 1].clone()
            e[k - 1] = c * e_km1
            b = -s * e_km1
        if v is not None:
            _rotate_cols(v, k, m, c, s)


def _shift(d, e, m: int):
    """Wilkinson shift from the trailing 2×2 of BᵀB on block end m."""
    dm, dm1, em1 = d[m], d[m - 1], e[m - 1]
    em2 = e[m - 2] if m >= 2 else torch.zeros_like(dm)
    t11 = dm1 * dm1 + em2 * em2
    t22 = dm * dm + em1 * em1
    t12 = dm1 * em1
    return _wilkinson_shift(t11, t12, t22)


def bidiag_svd(d, e, *, want_u: bool = True, want_v: bool = True,
               max_sweeps_factor: int = 30, use_dnc: bool | None = None):
    """SVD of B = bidiag(d, e) (d (n,), e (n−1,), real): ``(s, u, v, info)``
    with ``B = U diag(s) Vᵀ``, s descending ≥ 0. n ≥ 512 routes to divide &
    conquer (faer's large-n choice, ``bidiag_svd.rs:1005``), unless
    ``use_dnc`` says otherwise."""
    n = d.shape[0]
    if use_dnc is None:
        use_dnc = n >= 512 and d.dtype in (torch.float32, torch.float64)
    if use_dnc and n > 64:
        from faer_tpu_torch.linalg.bidiag_dnc import bidiag_svd_dnc

        return bidiag_svd_dnc(d, e, want_u=want_u, want_v=want_v)
    dev = d.device
    eye = torch.eye(n, dtype=d.dtype, device=dev)
    if n == 1:
        u = torch.where(d < 0, -eye, eye) if want_u else None
        return d.abs(), u, (eye if want_v else None), _info(True, 0, dev)
    eps = dtypes.eps(d.dtype)
    max_iters = max_sweeps_factor * n
    d, e = d.clone(), e.clone()
    u = eye.clone() if want_u else None
    v = eye.clone() if want_v else None
    didx = torch.arange(n, device=dev)
    l = it = 0
    while l < n - 1 and it < max_iters:
        it += 1
        tol = eps * (d[:-1].abs() + d[1:].abs())
        e = torch.where(e.abs() <= tol, torch.zeros_like(e), e)
        is_zero = torch.cat([e[l:] == 0, e.new_ones(1, dtype=torch.bool)])
        m_t = l + torch.argmax(is_zero.to(torch.uint8))
        # negligible diagonal inside the block → splitting chase
        dscale = d.abs().max() + e.abs().max()
        d = torch.where(d.abs() <= eps * dscale, torch.zeros_like(d), d)
        dz = (d[l:] == 0) & (didx[l:] <= m_t)
        m, has_dz, i0 = host_read(torch.stack(
            [m_t, dz.any().to(m_t.dtype), l + torch.argmax(dz.to(torch.uint8))]))
        if has_dz and m > l:
            if i0 == m:
                _col_chase(d, e, v, l, m)
            else:
                _row_chase(d, e, u, i0, m)
        elif m <= l:
            l += 1
        else:
            lm = torch.tensor([l, m], dtype=torch.int32, device=dev)
            d, e, c1, s1, c2, s2 = bidiag_sweep(d, e, lm, _shift(d, e, m).reshape(1))
            if v is not None:
                v[:, l:m + 1] = _apply_rotation_chain(v[:, l:m + 1], c1[l:m], s1[l:m])
            if u is not None:
                u[:, l:m + 1] = _apply_rotation_chain(u[:, l:m + 1], c2[l:m], s2[l:m])
    # sign fix (σ ≥ 0, flip U's columns) and sort descending
    sgn = torch.where(d < 0, -torch.ones_like(d), torch.ones_like(d))
    s = d * sgn
    order = torch.argsort(-s, stable=True)
    if u is not None:
        u = (u * sgn[None, :])[:, order]
    if v is not None:
        v = v[:, order]
    return s[order], u, v, _info(l >= n - 1, it, dev)
