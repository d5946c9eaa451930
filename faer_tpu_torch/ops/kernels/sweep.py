"""Kernels 9 and 10: the implicit-QR iteration of the spectral drivers.

Counterparts of ``faer_tpu/ops/pallas/panel_kernels.py``:

* :func:`tridiag_sweep` of ``tridiag_sweep_pallas`` (``:390``, body
  ``:322``): one Wilkinson-shifted bulge chase on the block [l, m] of a
  symmetric tridiagonal (d, e); returns ``(d', e', c, s)``;
* :func:`bidiag_sweep` of ``bidiag_sweep_pallas`` (``:502``, body ``:423``):
  one shifted Golub–Kahan sweep on an upper bidiagonal (d, e); returns
  ``(d', e', c1, s1, c2, s2)``, the right rotations (for V) and the left
  ones (for U);
* :func:`tridiag_qr_batched` and :func:`bidiag_qr_batched`: the whole
  iteration around those sweeps (``tridiag_evd``'s and ``bidiag_svd``'s
  loops, the JAX package's ``lax.while_loop``), for a batch of problems in
  one launch of the same CUDA sources, with the eigen- or singular vectors.
  They count under the sweeps' counters, ``tridiag_sweep`` and
  ``bidiag_sweep``, and take float32 and float64 (one instantiation of the
  CUDA sources each: the f64 spectral entry points' route).

The one-sweep rotation arrays have n − 1 entries and are 1 and 0 outside
[l, m). ``lm`` is an int32 tensor (l, m) and ``mu`` an f32 shift, both on
the device of ``d``: the CUDA kernels (``csrc/tridiag_sweep.cu``,
``csrc/bidiag_sweep.cu``) read them there, so the wrapper cannot check them
without a host sync; a block that is empty or does not lie in [0, n−1] is
the identity sweep, in the kernels and the plain versions alike. The plain
sweeps follow the Pallas bodies step for step, over [l, m) only (the
Pallas loop's other steps are identity), on 0-d tensors, with the kernels'
order of operations, so the two round alike.

The batched plain versions are the drivers' per-problem host loops, run for
each problem of the batch: the plain sweeps, the chases and the rotation
chain of chunk GEMMs (:func:`_apply_rotation_chain`). The kernels repeat
their scalar operations in the same order, so d, e and the iteration counts
agree to the bit; the vectors, rotated row by row in the kernels, agree to
rounding.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from faer_tpu_torch.core import dtypes
from faer_tpu_torch.core.config import count_launch
from faer_tpu_torch.core.errors import ShapeError
from faer_tpu_torch.ops.kernels import _build
from faer_tpu_torch.ops.matmul import matmul

MAX_N = 8192  # the largest problem the batched kernels take (kMaxN)


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


# ---------------------------------------------------------------------------
# the iteration around the sweeps: the plain versions of the batched kernels
# ---------------------------------------------------------------------------

def _wilkinson_shift(a, b, c):
    """Eigenvalue of [[a, b], [b, c]] closest to c."""
    one = torch.ones_like(c)
    delta = (a - c) / 2
    sq = torch.sqrt(delta * delta + b * b)
    denom = delta + torch.where(delta >= 0, one, -one) * sq
    denom = torch.where(denom == 0, one, denom)
    return torch.where(b == 0, c, c - b * b / denom)


def _shift(d, e, m: int):
    """Wilkinson shift from the trailing 2×2 of BᵀB on block end m."""
    dm, dm1, em1 = d[m], d[m - 1], e[m - 1]
    em2 = e[m - 2] if m >= 2 else torch.zeros_like(dm)
    t11 = dm1 * dm1 + em2 * em2
    t22 = dm * dm + em1 * em1
    t12 = dm1 * em1
    return _wilkinson_shift(t11, t12, t22)


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


def _chase_extra_column(d, e):
    """Reduce a wide (m, m+1) upper bidiagonal to square: ``(d', e', w0)``
    with ``B_wide @ w0 = [B_square | 0]``, w0 orthogonal (m+1)×(m+1). Right
    Givens rotations on columns (j, m) zero the last column bottom-up."""
    m = d.shape[0]
    d, e = d.clone(), e.clone()
    w0 = torch.eye(m + 1, dtype=d.dtype, device=d.device)
    one = d.new_ones(())
    f = e[m - 1].clone()
    for j in range(m - 1, -1, -1):
        c, s, r = _givens(d[j].clone(), f, one)
        d[j] = r
        if j > 0:
            ej = e[j - 1].clone()
            e[j - 1] = c * ej
            f = -s * ej
        cj, cm = w0[:, j].clone(), w0[:, m].clone()
        w0[:, j] = c * cj + s * cm
        w0[:, m] = -s * cj + c * cm
    return d, e[:m - 1], w0


def _tridiag_qr_one(d, e, z, max_iters: int):
    """``tridiag_evd``'s QR iteration on one problem: ``(d, e, z,
    iterations, converged, sweep steps)``, d unsorted. Each iteration zeroes
    the negligible off-diagonals, finds the end m of the unreduced block
    that starts at l, and advances l or sweeps [l, m] with the Wilkinson
    shift; Z absorbs each sweep's rotation chain as chunk GEMMs."""
    n = d.shape[0]
    eps = dtypes.eps(d.dtype)
    l = it = steps = 0
    while l < n - 1 and it < max_iters:
        it += 1
        tol = eps * (d[:-1].abs() + d[1:].abs())
        e = torch.where(e.abs() <= tol, torch.zeros_like(e), e)
        # the first i ≥ l with e[i] == 0, else n − 1
        is_zero = torch.cat([e[l:] == 0, e.new_ones(1, dtype=torch.bool)])
        m = l + int(torch.argmax(is_zero.to(torch.uint8)))
        if m <= l:
            l += 1
            continue
        mu = _wilkinson_shift(d[m - 1], e[m - 1], d[m])
        lm = torch.tensor([l, m], dtype=torch.int32, device=d.device)
        d, e, c_arr, s_arr = tridiag_sweep_plain(d, e, lm, mu.reshape(1))
        steps += m - l
        if z is not None:
            # the rotations are the identity outside [l, m): only columns
            # l..m of z change
            z[:, l:m + 1] = _apply_rotation_chain(z[:, l:m + 1], c_arr[l:m],
                                                  s_arr[l:m])
    return d, e, z, it, l >= n - 1, steps


def _bidiag_qr_one(d, e, u, v, max_iters: int):
    """``bidiag_svd``'s QR iteration on one square problem: ``(d, e, u, v,
    iterations, converged, sweep steps)``, d unsigned and unsorted. Each
    iteration zeroes the negligible off-diagonals and diagonals, finds the
    unreduced block [l, m], and then splits at a zero diagonal with a row or
    column chase, advances l, or sweeps; V and U absorb the right and left
    rotation chains as chunk GEMMs."""
    n = d.shape[0]
    eps = dtypes.eps(d.dtype)
    didx = torch.arange(n, device=d.device)
    l = it = steps = 0
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
        m, has_dz, i0 = torch.stack(
            [m_t, dz.any().to(m_t.dtype), l + torch.argmax(dz.to(torch.uint8))]).tolist()
        if has_dz and m > l:
            if i0 == m:
                _col_chase(d, e, v, l, m)
            else:
                _row_chase(d, e, u, i0, m)
        elif m <= l:
            l += 1
        else:
            lm = torch.tensor([l, m], dtype=torch.int32, device=d.device)
            d, e, c1, s1, c2, s2 = bidiag_sweep_plain(d, e, lm, _shift(d, e, m).reshape(1))
            steps += m - l
            if v is not None:
                v[:, l:m + 1] = _apply_rotation_chain(v[:, l:m + 1], c1[l:m], s1[l:m])
            if u is not None:
                u[:, l:m + 1] = _apply_rotation_chain(u[:, l:m + 1], c2[l:m], s2[l:m])
    return d, e, u, v, it, l >= n - 1, steps


def _info_of(info):
    """(iterations, converged, sweep steps) of an int32 (B, 3) info tensor."""
    return info[:, 0], info[:, 1] != 0, info[:, 2]


def _eye_batch(batch: int, n: int, like):
    return torch.eye(n, dtype=like.dtype, device=like.device).repeat(batch, 1, 1)


def tridiag_qr_batched_plain(d, e, sizes, *, max_sweeps_factor: int = 30,
                             want_vectors: bool = True):
    """Plain PyTorch version of :func:`tridiag_qr_batched` (same contract):
    ``tridiag_evd``'s loop for each problem in turn."""
    batch, nmax = d.shape
    z = _eye_batch(batch, nmax, d) if want_vectors else None
    info = torch.zeros((batch, 3), dtype=torch.int32)
    for b, n in enumerate(sizes.tolist()):
        if not 1 <= n <= nmax:
            continue
        zb = z[b, :n, :n].clone() if want_vectors else None
        db, eb, zb, it, conv, steps = _tridiag_qr_one(
            d[b, :n].clone(), e[b, :n - 1].clone(), zb, max_sweeps_factor * n)
        d[b, :n], e[b, :n - 1] = db, eb
        if want_vectors:
            z[b, :n, :n] = zb
        info[b] = torch.tensor([it, int(conv), steps], dtype=torch.int32)
    return (z, *_info_of(info.to(d.device)))


def bidiag_qr_batched_plain(d, e, sizes, sqre, *, max_sweeps_factor: int = 30,
                            want_u: bool = True, want_v: bool = True):
    """Plain PyTorch version of :func:`bidiag_qr_batched` (same contract):
    for each problem in turn, the extra column chased out of a wide one
    (``sqre`` 1), then ``bidiag_svd``'s loop, and W = w0 · blkdiag(V, 1)."""
    batch, nmax = d.shape
    u_all = _eye_batch(batch, nmax, d) if want_u else None
    w_all = _eye_batch(batch, nmax + 1, d) if want_v else None
    info = torch.zeros((batch, 3), dtype=torch.int32)
    for b, (n, sq) in enumerate(zip(sizes.tolist(), sqre.tolist())):
        if not 1 <= n <= nmax:
            continue
        sq = int(sq != 0)
        db, eb = d[b, :n].clone(), e[b, :n - 1 + sq].clone()
        if sq:
            db, eb, w0 = _chase_extra_column(db, eb)
        eye = torch.eye(n, dtype=d.dtype, device=d.device)
        db, eb, ub, vb, it, conv, steps = _bidiag_qr_one(
            db, eb, eye.clone() if want_u else None, eye.clone() if want_v else None,
            max_sweeps_factor * n)
        d[b, :n], e[b, :n - 1] = db, eb
        if sq:
            e[b, n - 1] = 0.0
        if want_u:
            u_all[b, :n, :n] = ub
        if want_v:
            w_all[b, :n + sq, :n + sq] = (
                torch.cat([matmul(None, w0[:, :n], vb), w0[:, n:]], dim=1) if sq else vb)
        info[b] = torch.tensor([it, int(conv), steps], dtype=torch.int32)
    return (u_all, w_all, *_info_of(info.to(d.device)))


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------

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


def _check_batched(name: str, d, e, e_cols: int, ints, max_sweeps_factor) -> None:
    """d (B, nmax) and e (B, ``e_cols``) of one dtype, float32 or float64,
    the int32 (B,) tensors ``ints``, all contiguous on one CPU or CUDA
    device."""
    if d.dtype not in (torch.float32, torch.float64) or e.dtype != d.dtype:
        raise TypeError(f"{name}: d and e must be float32 or float64 (one dtype), "
                        f"got {d.dtype}, {e.dtype}")
    if d.dim() != 2 or not 1 <= d.shape[1] <= MAX_N or d.shape[0] < 1:
        raise ShapeError(f"{name}: needs d (B, nmax) with B ≥ 1 and 1 ≤ nmax ≤ "
                         f"{MAX_N}, got {tuple(d.shape)}")
    batch = d.shape[0]
    if tuple(e.shape) != (batch, e_cols):
        raise ShapeError(f"{name}: needs e {(batch, e_cols)}, got {tuple(e.shape)}")
    for x in ints:
        if x.dtype != torch.int32 or tuple(x.shape) != (batch,):
            raise TypeError(f"{name}: sizes and sqre must be int32 ({batch},)")
    if int(max_sweeps_factor) < 0:
        raise ValueError(f"{name}: max_sweeps_factor must be ≥ 0")
    if any(x.device != d.device for x in (e, *ints)):
        raise ValueError(f"{name}: d, e, sizes and sqre must be on one device")
    if d.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {d.device}")
    if not all(x.is_contiguous() for x in (d, e, *ints)):
        raise ValueError(f"{name}: d, e, sizes and sqre must be contiguous")


def tridiag_qr_batched(d, e, sizes, *, max_sweeps_factor: int = 30,
                       want_vectors: bool = True):
    """The implicit-QR iteration of B symmetric tridiagonals in one launch.

    ``d`` (B, nmax) and ``e`` (B, nmax − 1) (float32 or float64) hold problem b in
    ``d[b, :n]``, ``e[b, :n − 1]`` with n = ``sizes[b]`` (int32, on the
    card: the batch may be ragged); each runs ``tridiag_evd``'s loop of at
    most ``max_sweeps_factor``·n iterations. d and e are overwritten: d with
    the unsorted eigenvalues, e with what the iteration left (negligible
    entries zeroed). Returns ``(z, iterations, converged, steps)``: ``z``
    (B, nmax, nmax) with ``z[b, :n, :n]`` the eigenvectors in the order of
    ``d[b, :n]`` and the identity past them (None without vectors);
    int32 iterations, bool converged and int32 sweep chain steps (B,), all
    on the device. A size outside [1, nmax] leaves its problem as it is,
    with 0 iterations, not converged. One ``tridiag_sweep`` launch.
    """
    _check_batched("tridiag_qr_batched", d, e, d.shape[1] - 1 if d.dim() == 2 else 0,
                   (sizes,), max_sweeps_factor)
    if d.device.type == "cpu":
        return tridiag_qr_batched_plain(d, e, sizes, max_sweeps_factor=max_sweeps_factor,
                                        want_vectors=want_vectors)
    batch, nmax = d.shape
    # column-major Z: a warp's rows are adjacent
    zt = torch.empty((batch, nmax, nmax), dtype=d.dtype, device=d.device) \
        if want_vectors else None
    info = torch.empty((batch, 3), dtype=torch.int32, device=d.device)
    with torch.cuda.device(d.device):  # the C entry launches on the current device
        code = _entry("faer_tridiag_qr_batched", d.dtype)(
            d.data_ptr(), e.data_ptr(), sizes.data_ptr(),
            zt.data_ptr() if want_vectors else None, info.data_ptr(), batch, nmax,
            int(max_sweeps_factor), int(want_vectors), _build.stream_of(d))
    _build.check("tridiag_qr_batched", code)
    count_launch("tridiag_sweep")
    return (zt.transpose(1, 2) if want_vectors else None, *_info_of(info))


def bidiag_qr_batched(d, e, sizes, sqre, *, max_sweeps_factor: int = 30,
                      want_u: bool = True, want_v: bool = True):
    """The implicit-QR iteration of B upper bidiagonals in one launch.

    ``d`` and ``e`` (B, nmax) (float32 or float64) hold problem b, an (n, n + sqre) upper
    bidiagonal with n = ``sizes[b]`` and sqre = ``sqre[b]`` (int32 (B,), on
    the card), in ``d[b, :n]`` and ``e[b, :n − 1 + sqre]``. A wide one
    (sqre 1) first has its extra column chased out by right rotations; then
    ``bidiag_svd``'s loop runs at most ``max_sweeps_factor``·n iterations.
    d and e are overwritten: d with the singular values, unsigned and
    unsorted, e with what the iteration left. Returns ``(u, w, iterations,
    converged, steps)``: ``u`` (B, nmax, nmax) with ``u[b, :n, :n]`` the
    left vectors in the order of ``d[b, :n]``, ``w`` (B, nmax + 1,
    nmax + 1) with ``w[b, :n + sqre, :n + sqre]`` the right ones, its first
    n columns in that order (for a wide problem W = w0 · blkdiag(V, 1),
    w0 the chase's rotations), each the identity past its problem (None
    when not wanted); iterations, converged, sweep chain steps as
    :func:`tridiag_qr_batched`. One ``bidiag_sweep`` launch.
    """
    _check_batched("bidiag_qr_batched", d, e, d.shape[1] if d.dim() == 2 else 0,
                   (sizes, sqre), max_sweeps_factor)
    if d.device.type == "cpu":
        return bidiag_qr_batched_plain(d, e, sizes, sqre,
                                       max_sweeps_factor=max_sweeps_factor,
                                       want_u=want_u, want_v=want_v)
    batch, nmax = d.shape
    # column-major U and W: a warp's rows are adjacent
    ut = torch.empty((batch, nmax, nmax), dtype=d.dtype, device=d.device) \
        if want_u else None
    wt = torch.empty((batch, nmax + 1, nmax + 1), dtype=d.dtype, device=d.device) \
        if want_v else None
    info = torch.empty((batch, 3), dtype=torch.int32, device=d.device)
    with torch.cuda.device(d.device):  # the C entry launches on the current device
        code = _entry("faer_bidiag_qr_batched", d.dtype)(
            d.data_ptr(), e.data_ptr(), sizes.data_ptr(), sqre.data_ptr(),
            ut.data_ptr() if want_u else None, wt.data_ptr() if want_v else None,
            info.data_ptr(), batch, nmax, int(max_sweeps_factor), _build.stream_of(d))
    _build.check("bidiag_qr_batched", code)
    count_launch("bidiag_sweep")
    return (ut.transpose(1, 2) if want_u else None, wt.transpose(1, 2) if want_v else None,
            *_info_of(info))


def _entry(name: str, dtype):
    """The float32 entry ``name`` of the kernel library, or its float64
    twin ``name_f64``."""
    return getattr(_build.library(), name + ("_f64" if dtype == torch.float64 else ""))


def qr_batched_route(kind: str, nmax: int, *, vectors: bool = True,
                     dtype=torch.float32) -> str:
    """Where the batched kernel of ``kind`` ("tridiag" or "bidiag") keeps
    its vectors for problems of up to ``nmax`` in ``dtype``: "shared" or
    "global" memory (as ``csrc/*_sweep.cu`` decide it), or "refused". Needs
    the built library."""
    route = (_entry("faer_tridiag_qr_route", dtype)(nmax, int(vectors)) if kind == "tridiag"
             else _entry("faer_bidiag_qr_route", dtype)(nmax, int(vectors), int(vectors)))
    return {0: "shared", 1: "global"}.get(route, "refused")
