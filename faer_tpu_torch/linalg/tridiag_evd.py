"""Symmetric tridiagonal eigensolver: implicit-shift QR with deflation
(counterpart of ``faer_tpu/linalg/tridiag_evd.py``).

faer ``qr_algorithm`` (``evd/tridiag_evd.rs:9``); large n routes to divide &
conquer (``tridiag_dnc.py``). Each iteration zeroes the negligible
off-diagonals, finds the end m of the unreduced block that starts at l, and
either advances l or runs one Wilkinson-shifted sweep on [l, m] through the
``tridiag_sweep`` kernel, as the JAX package does on a TPU; the eigenvector
matrix then absorbs the sweep's rotation chain as a few small GEMMs.

The JAX package runs the iteration as one ``lax.while_loop`` on the device.
Here the host drives it: the end of the block is read once per iteration
(``core.config.host_read``, one host sync), and everything else stays on
the device. The XLA ``scan`` sweep of the reference (its non-TPU branch) has
no counterpart: the port always sweeps through the kernel wrapper, whose
plain version runs for a CPU tensor.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from faer_tpu_torch.core import dtypes
from faer_tpu_torch.core.config import host_read
from faer_tpu_torch.core.errors import SpectralInfo
from faer_tpu_torch.ops.kernels.sweep import tridiag_sweep
from faer_tpu_torch.ops.matmul import matmul


def _wilkinson_shift(a, b, c):
    """Eigenvalue of [[a, b], [b, c]] closest to c."""
    one = torch.ones_like(c)
    delta = (a - c) / 2
    sq = torch.sqrt(delta * delta + b * b)
    denom = delta + torch.where(delta >= 0, one, -one) * sq
    denom = torch.where(denom == 0, one, denom)
    return torch.where(b == 0, c, c - b * b / denom)


def _givens_real(x, z):
    """c, s, r with [[c, −s], [s, c]]ᵀ [x, z]ᵀ = [r, 0]ᵀ (all real)."""
    r = torch.hypot(x, z)
    one = torch.ones_like(r)
    safe = torch.where(r == 0, one, r)
    c = torch.where(r == 0, one, x / safe)
    s = torch.where(r == 0, 0.0 * one, z / safe)
    return c, s, r


@functools.lru_cache(maxsize=None)
def _chain_pattern(chunk: int, device, dtype):
    """The data-independent parts of :func:`_chain_chunks`: where the
    product mask is 1 (t ≥ j), the signs (−1)^{j−r} on r ≤ j (0 below), and
    the subdiagonal's indices."""
    w = chunk + 1
    idx = torch.arange(w, device=device)
    ones_at = idx[:, None] >= idx[None, :]  # (t, j): t ≥ j
    sign = 1 - 2 * ((idx[None, :] - idx[:, None]) % 2)
    signed_upper = torch.where(idx[:, None] <= idx[None, :], sign, 0).to(dtype)
    return ones_at, signed_upper, idx[:chunk]


def _chain_chunks(c_arr, s_arr, chunk: int):
    """The products P_q = G_{qk} ⋯ G_{qk+k−1} (k = ``chunk``) of adjacent
    Givens rotations, G_t = [[c_t, −s_t], [s_t, c_t]] on (t, t+1), as a
    (nchunks, k+1, k+1) tensor, in closed form. With c₋₁ = c_k = 1 (chunk
    local): P[j+1, j] = s_j; P[r, j] = (−1)^{j−r} c_{r−1} c_j ∏_{t=r}^{j−1} s_t
    for r ≤ j; every other entry 0. The products ∏ s_t come from one
    ``cumprod`` over a tensor masked to 1 where t ≥ j, so nothing is divided.
    Padding rotations are the identity (c = 1, s = 0)."""
    nr = c_arr.shape[0]
    nchunks = -(-nr // chunk)
    pad = nchunks * chunk - nr
    ones_at, signed_upper, sub = _chain_pattern(chunk, c_arr.device, c_arr.dtype)
    s_p = F.pad(s_arr, (0, pad)).reshape(nchunks, chunk)
    # c padded with the identity and with c₋₁ = c_k = 1 around each chunk
    c_pad = F.pad(F.pad(c_arr, (0, pad), value=1.0).reshape(nchunks, chunk),
                  (1, 1), value=1.0)
    # x[q, t, j] = s_t for t < j, else 1 (row t = k: all 1);
    # y[q, r, j] = ∏_{t=r}^{j−1} s_t
    x = F.pad(s_p, (0, 1), value=1.0)[:, :, None].expand(nchunks, chunk + 1, chunk + 1)
    x = x.masked_fill(ones_at, 1.0)
    y = torch.flip(torch.cumprod(torch.flip(x, dims=[1]), dim=1), dims=[1])
    p = signed_upper * c_pad[:, :-1, None] * c_pad[:, None, 1:] * y
    p[:, sub + 1, sub] = s_p
    return p


def _apply_rotation_chain(z, c_arr, s_arr, chunk: int = 64):
    """Z ← Z · G_0 G_1 ⋯ G_{nr−1} with G_i the Givens rotation of columns
    (i, i+1), parameters (c_arr[i], s_arr[i]); ``z`` has nr + 1 columns.
    The chunk products come in closed form (:func:`_chain_chunks`) and are
    applied as a short chain of (rows × chunk+1) GEMMs (adjacent chunks share
    one boundary column). Returns a new tensor."""
    rows, ncols = z.shape
    nr = c_arr.shape[0]
    if nr == 0:
        return z.clone()
    p = _chain_chunks(c_arr, s_arr, chunk)
    nchunks = p.shape[0]
    zp = torch.cat([z, z.new_zeros((rows, nchunks * chunk + 1 - ncols))], dim=1)
    for k in range(nchunks):
        j0 = k * chunk
        # full FP32 as the reference's HIGHEST dot (tridiag_evd.py:79)
        zp[:, j0:j0 + chunk + 1] = matmul(None, zp[:, j0:j0 + chunk + 1], p[k],
                                          precision="highest")
    return zp[:, :ncols]


def _apply_rotation_chain_rows(u, c_arr, s_arr, chunk: int = 64):
    """U ← G_0 G_1 ⋯ G_{nr−1} · U: the rotations applied to the rows of
    ``u`` (nr + 1 rows) in descending order, G_{nr−1} first — the row
    loops of the D&C merges (``undefl``) as a chain of chunk GEMMs."""
    nrows = u.shape[0]
    nr = c_arr.shape[0]
    if nr == 0:
        return u.clone()
    p = _chain_chunks(c_arr.to(u.dtype), s_arr.to(u.dtype), chunk)
    nchunks = p.shape[0]
    up = torch.cat([u, u.new_zeros((nchunks * chunk + 1 - nrows, u.shape[1]))])
    for k in range(nchunks - 1, -1, -1):
        j0 = k * chunk
        # full FP32: the reference applies these rotations elementwise
        up[j0:j0 + chunk + 1] = matmul(None, p[k], up[j0:j0 + chunk + 1],
                                       precision="highest")
    return up[:nrows]


def _block_end(e, l: int):
    """The end m of the unreduced block starting at l (first i ≥ l with
    e[i] == 0, else n−1), read on the host."""
    is_zero = torch.cat([e[l:] == 0, e.new_ones(1, dtype=torch.bool)])
    return l + host_read(torch.argmax(is_zero.to(torch.uint8)))


def _info(converged: bool, iterations: int, device) -> SpectralInfo:
    return SpectralInfo(
        converged=torch.tensor(converged, device=device),
        iterations=torch.tensor(iterations, dtype=torch.int32, device=device))


def tridiag_evd(d, e, *, want_vectors: bool = True, max_sweeps_factor: int = 30,
                use_dnc: bool | None = None):
    """Eigendecomposition of the symmetric tridiagonal (d, e).

    Returns ``(w, z, info)``: ascending eigenvalues ``w``; ``z`` the
    orthogonal eigenvector matrix of the tridiagonal (or None). n ≥ 512
    routes to divide & conquer (faer's own large-n choice,
    ``tridiag_evd.rs:608``), unless ``use_dnc`` says otherwise.
    """
    n = d.shape[0]
    if use_dnc is None:
        use_dnc = n >= 512 and d.dtype in (torch.float32, torch.float64)
    if use_dnc and n > 64:
        from faer_tpu_torch.linalg.tridiag_dnc import tridiag_evd_dnc

        return tridiag_evd_dnc(d, e, want_vectors=want_vectors)
    dev = d.device
    if n == 1:
        z = torch.ones((1, 1), dtype=d.dtype, device=dev) if want_vectors else None
        return d.clone(), z, _info(True, 0, dev)
    eps = dtypes.eps(d.dtype)
    max_iters = max_sweeps_factor * n
    z = torch.eye(n, dtype=d.dtype, device=dev) if want_vectors else None
    l = it = 0
    while l < n - 1 and it < max_iters:
        it += 1
        tol = eps * (d[:-1].abs() + d[1:].abs())
        e = torch.where(e.abs() <= tol, torch.zeros_like(e), e)
        m = _block_end(e, l)
        if m <= l:
            l += 1
            continue
        mu = _wilkinson_shift(d[m - 1], e[m - 1], d[m])
        lm = torch.tensor([l, m], dtype=torch.int32, device=dev)
        d, e, c_arr, s_arr = tridiag_sweep(d, e, lm, mu.reshape(1))
        if z is not None:
            # the rotations are the identity outside [l, m): only columns
            # l..m of z change
            z[:, l:m + 1] = _apply_rotation_chain(z[:, l:m + 1], c_arr[l:m],
                                                  s_arr[l:m])
    # ascending, as faer sorts self-adjoint eigenvalues (lib.rs:143)
    order = torch.argsort(d, stable=True)
    if z is not None:
        z = z[:, order]
    return d[order], z, _info(l >= n - 1, it, dev)
