"""SVD of a real upper-bidiagonal matrix: implicit-shift Golub–Kahan QR
(counterpart of ``faer_tpu/linalg/bidiag_svd.py``).

faer ``bidiag_svd`` QR-algorithm path (``svd/bidiag_svd.rs:274``); large n
routes to divide & conquer (``bidiag_dnc.py``). Each iteration zeroes the
negligible off-diagonals and diagonals, finds the unreduced block [l, m],
and then splits at a zero diagonal with a row or column chase, advances l,
or runs one shifted sweep, whose right and left rotations V and U absorb.

The JAX package runs the iteration as one ``lax.while_loop`` on the device,
its sweeps through the ``bidiag_sweep`` kernel on a TPU. Here the whole
iteration, chases included, is one launch of the batched kernel
(``bidiag_qr_batched``, a batch of one), counted under ``bidiag_sweep``:
nothing is read on the host. The sign fix and the sort stay in PyTorch.
"""
from __future__ import annotations

import torch

from faer_tpu_torch.core.errors import SpectralInfo
from faer_tpu_torch.linalg.tridiag_evd import _info
from faer_tpu_torch.ops.kernels.sweep import bidiag_qr_batched


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
    if n == 1:
        eye = torch.eye(1, dtype=d.dtype, device=dev)
        u = torch.where(d < 0, -eye, eye) if want_u else None
        return d.abs(), u, (eye if want_v else None), _info(True, 0, dev)
    # the batched layout: e padded to n entries (square: the last unused)
    db = d.reshape(1, n).clone()
    eb = torch.cat([e, e.new_zeros(1)]).reshape(1, n)
    sizes = torch.full((1,), n, dtype=torch.int32, device=dev)
    u, w, its, conv, _ = bidiag_qr_batched(
        db, eb, sizes, torch.zeros(1, dtype=torch.int32, device=dev),
        max_sweeps_factor=max_sweeps_factor, want_u=want_u, want_v=want_v)
    d = db[0]
    # sign fix (σ ≥ 0, flip U's columns) and sort descending
    sgn = torch.where(d < 0, -torch.ones_like(d), torch.ones_like(d))
    s = d * sgn
    order = torch.argsort(-s, stable=True)
    if u is not None:
        u = (u[0] * sgn[None, :])[:, order]
    v = w[0, :n, :n][:, order] if w is not None else None
    return s[order], u, v, SpectralInfo(converged=conv[0], iterations=its[0])
