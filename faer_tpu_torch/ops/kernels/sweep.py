"""Kernels 9 and 10: one implicit-QR sweep of the spectral drivers.

Counterparts of ``faer_tpu/ops/pallas/panel_kernels.py``:

* :func:`tridiag_sweep` of ``tridiag_sweep_pallas`` (``:390``, body
  ``:322``): one Wilkinson-shifted bulge chase on the block [l, m] of a
  symmetric tridiagonal (d, e); returns ``(d', e', c, s)``;
* :func:`bidiag_sweep` of ``bidiag_sweep_pallas`` (``:502``, body ``:423``):
  one shifted Golub–Kahan sweep on an upper bidiagonal (d, e); returns
  ``(d', e', c1, s1, c2, s2)``, the right rotations (for V) and the left
  ones (for U).

The rotation arrays have n − 1 entries and are 1 and 0 outside [l, m).
``lm`` is an int32 tensor (l, m) and ``mu`` an f32 shift, both on the
device of ``d``: the CUDA kernels (``csrc/tridiag_sweep.cu``,
``csrc/bidiag_sweep.cu``) read them there, so the wrapper cannot check them
without a host sync; a block that is empty or does not lie in [0, n−1] is
the identity sweep, in the kernels and the plain versions alike. The plain
versions follow the Pallas bodies step for step, over [l, m) only (the
Pallas loop's other steps are identity), on 0-d tensors, with the kernels'
order of operations, so the two round alike.
"""
from __future__ import annotations

import torch

from faer_tpu_torch.core.config import count_launch
from faer_tpu_torch.core.errors import ShapeError
from faer_tpu_torch.ops.kernels import _build


def _givens(x, z, one):
    """c, s, r with [[c, −s], [s, c]]ᵀ [x, z]ᵀ = [r, 0]ᵀ (0-d tensors)."""
    r = torch.sqrt(x * x + z * z)
    zero = r == 0
    safe = torch.where(zero, one, r)
    c = torch.where(zero, one, x / safe)
    s = torch.where(zero, 0.0 * one, z / safe)
    return c, s, r


def _block(lm, n: int) -> tuple[int, int] | None:
    """(l, m) if the block is a non-empty part of [0, n−1], else None."""
    l, m = (int(x) for x in lm.tolist())
    return (l, m) if 0 <= l < m <= n - 1 else None


def tridiag_sweep_plain(d, e, lm, mu):
    """Plain PyTorch version of the tridiagonal sweep (same contract)."""
    n = d.shape[0]
    d, e = d.clone(), e.clone()
    c_arr, s_arr = d.new_ones(n - 1), d.new_zeros(n - 1)
    block = _block(lm, n)
    if block is None:
        return d, e, c_arr, s_arr
    l, m = block
    one = d.new_ones(())
    x = d[l] - mu.reshape(())
    bz = e[l].clone()
    for i in range(l, m):
        c, s, r = _givens(x, bz, one)
        c_arr[i] = c
        s_arr[i] = s
        if i > l:
            e[i - 1] = r
        di, dip1, ei = d[i].clone(), d[i + 1].clone(), e[i].clone()
        cc, ss = c * c, s * s
        cs2 = 2 * c * s
        new_di = cc * di + cs2 * ei + ss * dip1
        new_dip1 = ss * di - cs2 * ei + cc * dip1
        new_ei = c * s * (dip1 - di) + (cc - ss) * ei
        d[i] = new_di
        d[i + 1] = new_dip1
        e[i] = new_ei
        e_next = e[min(i + 1, n - 2)].clone()
        if i + 1 < m:
            e[i + 1] = c * e_next
            bz = s * e_next
        else:
            bz = 0.0 * one
        x = new_ei
    return d, e, c_arr, s_arr


def bidiag_sweep_plain(d, e, lm, mu):
    """Plain PyTorch version of the Golub–Kahan sweep (same contract)."""
    n = d.shape[0]
    d, e = d.clone(), e.clone()
    c1_arr, s1_arr = d.new_ones(n - 1), d.new_zeros(n - 1)
    c2_arr, s2_arr = d.new_ones(n - 1), d.new_zeros(n - 1)
    block = _block(lm, n)
    if block is None:
        return d, e, c1_arr, s1_arr, c2_arr, s2_arr
    l, m = block
    one = d.new_ones(())
    dl = d[l].clone()
    x = dl * dl - mu.reshape(())
    bz = dl * e[l]
    for i in range(l, m):
        c1, s1, r1 = _givens(x, bz, one)
        c1_arr[i] = c1
        s1_arr[i] = s1
        if i > l:
            e[i - 1] = r1
        di, dip1, ei = d[i].clone(), d[i + 1].clone(), e[i].clone()
        new_di = c1 * di + s1 * ei
        new_ei = -s1 * di + c1 * ei
        bulge = s1 * dip1
        new_dip1 = c1 * dip1
        c2, s2, r2 = _givens(new_di, bulge, one)
        c2_arr[i] = c2
        s2_arr[i] = s2
        e2v = c2 * new_ei + s2 * new_dip1
        d2ip1 = -s2 * new_ei + c2 * new_dip1
        d[i] = r2
        d[i + 1] = d2ip1
        e[i] = e2v
        e_next = e[min(i + 1, n - 2)].clone()
        if i + 1 < m:
            e[i + 1] = c2 * e_next
            bz = s2 * e_next
        else:
            bz = 0.0 * one
        x = e2v
    return d, e, c1_arr, s1_arr, c2_arr, s2_arr


def _check(d, e, lm, mu, name: str) -> None:
    for x, what in ((d, "d"), (e, "e"), (mu, "mu")):
        if x.dtype != torch.float32:
            raise TypeError(f"{name}: {what} must be float32, got {x.dtype}")
    if lm.dtype != torch.int32 or lm.numel() != 2:
        raise TypeError(f"{name}: lm must be an int32 pair (l, m)")
    n = d.shape[0] if d.dim() == 1 else 0
    if n < 2 or tuple(e.shape) != (n - 1,) or mu.numel() != 1:
        raise ShapeError(f"{name}: needs d (n,), e (n-1,) with n ≥ 2 and one "
                         f"mu, got {tuple(d.shape)}, {tuple(e.shape)}")
    if any(x.device != d.device for x in (e, lm, mu)):
        raise ValueError(f"{name}: d, e, lm and mu must be on one device")
    if d.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {d.device}")


def _launch(name: str, n_rot: int, d, e, lm, mu):
    """Launch ``faer_<name>`` with ``n_rot`` rotation arrays as outputs."""
    if not all(x.is_contiguous() for x in (d, e, lm, mu)):
        raise ValueError(f"{name}: d, e, lm and mu must be contiguous")
    outs = [torch.empty_like(d), torch.empty_like(e)]
    outs += [torch.empty_like(e) for _ in range(n_rot)]
    with torch.cuda.device(d.device):  # the C entry launches on the current device
        code = getattr(_build.library(), f"faer_{name}")(
            lm.data_ptr(), mu.data_ptr(), d.data_ptr(), e.data_ptr(),
            *(o.data_ptr() for o in outs), d.shape[0], _build.stream_of(d))
    _build.check(name, code)
    count_launch(name)
    return tuple(outs)


def tridiag_sweep(d, e, lm, mu):
    """One tridiagonal QR sweep on block [l, m]: ``(d', e', c, s)``. f32."""
    _check(d, e, lm, mu, "tridiag_sweep")
    if d.device.type == "cpu":
        return tridiag_sweep_plain(d, e, lm, mu)
    return _launch("tridiag_sweep", 2, d, e, lm, mu)


def bidiag_sweep(d, e, lm, mu):
    """One Golub–Kahan sweep on block [l, m]: ``(d', e', c1, s1, c2, s2)``. f32."""
    _check(d, e, lm, mu, "bidiag_sweep")
    if d.device.type == "cpu":
        return bidiag_sweep_plain(d, e, lm, mu)
    return _launch("bidiag_sweep", 4, d, e, lm, mu)
