"""Symmetric tridiagonal eigensolver: implicit-shift QR with deflation
(counterpart of ``faer_tpu/linalg/tridiag_evd.py``).

faer ``qr_algorithm`` (``evd/tridiag_evd.rs:9``); large n routes to divide &
conquer (``tridiag_dnc.py``). Each iteration zeroes the negligible
off-diagonals, finds the end m of the unreduced block that starts at l, and
either advances l or runs one Wilkinson-shifted sweep on [l, m], the
eigenvector matrix absorbing the sweep's rotations.

The JAX package runs the iteration as one ``lax.while_loop`` on the device,
its sweeps through the ``tridiag_sweep`` kernel on a TPU. Here the whole
iteration is one launch of the batched kernel (``tridiag_qr_batched``, a
batch of one), counted under ``tridiag_sweep``: nothing is read on the
host. The XLA ``scan`` sweep of the reference (its non-TPU branch) has no
counterpart: on a CPU tensor the wrapper runs its plain version.
"""
from __future__ import annotations

import torch

from faer_tpu_torch.core.errors import SpectralInfo
from faer_tpu_torch.ops.kernels.sweep import _chain_chunks, tridiag_qr_batched
from faer_tpu_torch.ops.matmul import matmul


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
    db, eb = d.reshape(1, n).clone(), e.reshape(1, n - 1).clone()
    sizes = torch.full((1,), n, dtype=torch.int32, device=dev)
    z, its, conv, _ = tridiag_qr_batched(db, eb, sizes, max_sweeps_factor=max_sweeps_factor,
                                         want_vectors=want_vectors)
    d = db[0]
    # ascending, as faer sorts self-adjoint eigenvalues (lib.rs:143)
    order = torch.argsort(d, stable=True)
    if z is not None:
        z = z[0][:, order]
    return d[order], z, SpectralInfo(converged=conv[0], iterations=its[0])
