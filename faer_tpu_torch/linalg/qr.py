"""Householder QR without pivoting (counterpart of ``faer_tpu/linalg/qr.py``).

faer ``qr_in_place`` (``qr/no_pivoting/factor.rs:258``) and its solve,
lstsq, inverse and reconstruct siblings. Packed layout = LAPACK ``geqrt``:
R in the upper triangle, the reflector tails below the diagonal, and one
compact-WY T factor per ``block``-wide panel, stacked and zero-padded to
(npanels, block, block).

The driver is the JAX package's kernel route (``_qr_in_place_impl``,
``qr.py:273-332``): right-looking over a shrinking trail; each panel is
halved recursively (``_panel_qr_blocked_classic``) down to leaves of
``base`` columns, and every leaf is one ``qr_panel`` kernel call. The halves
are coupled, and the trail is updated, by compact-WY block applies
(``ops/householder.py``). The port is float32 only; other dtypes raise
``NotImplementedError``. Left out: the CholeskyQR2 panel
(``_panel_qr_cholqr``, gated off at ``qr.py:221``), the non-kernel ``fori``
panel (``_panel_qr``, whose role the kernel's plain version takes on the
CPU) and the column-pivoted QR (ROADMAP §1 item 8).
"""
from __future__ import annotations

import torch

from faer_tpu_torch.core import dtypes
from faer_tpu_torch.core.errors import ShapeError
from faer_tpu_torch.core.params import QrParams
from faer_tpu_torch.ops.householder import (
    apply_block_on_left,
    apply_sequence_on_left,
    form_block_t,
)
from faer_tpu_torch.ops.kernels.qr_panel import qr_panel
from faer_tpu_torch.ops.triangular_solve import solve_upper_triangular


def _extract_v(packed, bw: int):
    """Unit-lower-trapezoidal V from the first ``bw`` columns of a packed panel."""
    return torch.tril(packed[:, :bw], -1) + torch.eye(
        packed.shape[0], bw, dtype=packed.dtype, device=packed.device)


def _qr_block(kmax: int, params: QrParams) -> int:
    return params.block_size or (512 if kmax >= 2048 else
                                 256 if kmax >= 1024 else
                                 128 if kmax >= 512 else
                                 32 if kmax >= 64 else kmax)


def _panel_qr_blocked_classic(panel, base: int):
    """Panel QR by recursive column halving down to ``qr_panel`` leaves; the
    halves are coupled by one compact-WY block apply."""
    m, b = panel.shape
    if b <= base or m <= base:
        return qr_panel(panel)
    h = (b + 1) // 2
    left, taus1 = _panel_qr_blocked_classic(panel[:, :h], base)
    v1 = _extract_v(left, h)
    right = apply_block_on_left(v1, form_block_t(v1, taus1), panel[:, h:],
                                adjoint=True)
    bot, taus2 = _panel_qr_blocked_classic(right[h:], base)
    # in place into a fresh output where the JAX package concatenates
    out = panel.new_empty((m, b))
    out[:, :h] = left
    out[:h, h:] = right[:h]
    out[h:, h:] = bot
    return out, torch.cat([taus1, taus2])


def _qr_in_place_impl(a, block: int, base: int):
    """Right-looking over a shrinking trail (rows k:, columns k:). Each
    panel's column strip and its finished R12 rows are written once into a
    fresh output, which takes the place of the JAX package's strip
    assembly, the wide (n > min(m, n)) tail included."""
    m, n = a.shape
    kmax = min(m, n)
    out = a.new_zeros((m, n))
    t_stack = a.new_zeros((-(-kmax // block), block, block))
    trail = a
    for p, k in enumerate(range(0, kmax, block)):
        bw = min(block, kmax - k)
        panel, taus = _panel_qr_blocked_classic(trail[:, :bw], base)
        v = _extract_v(panel, bw)
        t = form_block_t(v, taus)
        t_stack[p, :bw, :bw] = t
        out[k:, k:k + bw] = panel
        if k + bw < n:
            right = apply_block_on_left(v, t, trail[:, bw:], adjoint=True)
            out[k:k + bw, k + bw:] = right[:bw]
            trail = right[bw:]
    return out, t_stack


def qr_in_place(a, params: QrParams | None = None):
    """Blocked Householder QR: returns ``(packed, t_stack, block)``.

    ``packed`` holds R (upper) and the reflector tails (strict lower);
    ``t_stack[p]`` is the compact-WY T of panel p, zero-padded to
    (block, block). Leaves are ``kernel_leaf`` wide (default 128, clamped to
    [128, 512]), as on the JAX package's kernel route.
    """
    if a.dim() != 2:
        raise ShapeError(f"qr_in_place: needs a matrix, got {tuple(a.shape)}")
    dtypes.require_f32(a, "qr_in_place")
    # the kernels read rows with unit stride: a strided input is copied once
    a = a.contiguous()
    params = params or QrParams.auto(a.dtype, a.shape)
    block = _qr_block(min(a.shape), params)
    leaf = params.kernel_leaf if params.kernel_leaf is not None else 128
    base = min(max(128, -(-leaf // 128) * 128), 512)
    packed, t_stack = _qr_in_place_impl(a, block, base)
    return packed, t_stack, block


def qr_compute_q(packed, t_stack, block: int, *, thin: bool = True):
    """Q (m × min(m, n) if ``thin``, else m × m) from the packed factor."""
    m = packed.shape[0]
    k = min(packed.shape)
    eye = torch.eye(m, k if thin else m, dtype=packed.dtype, device=packed.device)
    return apply_sequence_on_left(packed, t_stack, eye, adjoint=False, block=block)


def qr_apply_q(packed, t_stack, block: int, b, *, adjoint: bool):
    """``Q b`` or ``Qᵀ b``."""
    return apply_sequence_on_left(packed, t_stack, b, adjoint=adjoint, block=block)


def qr_reconstruct(packed, t_stack, block: int):
    """A = Q R (faer ``qr/no_pivoting/reconstruct.rs``)."""
    m, n = packed.shape
    k = min(m, n)
    rfull = packed.new_zeros((m, n))
    rfull[:k] = torch.triu(packed[:k])
    return apply_sequence_on_left(packed, t_stack, rfull, adjoint=False, block=block)


def qr_solve_lstsq(packed, t_stack, block: int, b):
    """Least-squares solve through Qᵀ b and the R triangle (faer
    ``solvers.rs:639``); m ≥ n."""
    n = packed.shape[1]
    qtb = apply_sequence_on_left(packed, t_stack, b, adjoint=True, block=block)
    return solve_upper_triangular(packed[:n, :n], qtb[:n])


def qr_solve(packed, t_stack, block: int, b):
    """Square-system solve (m == n)."""
    return qr_solve_lstsq(packed, t_stack, block, b)


def qr_inverse(packed, t_stack, block: int):
    """A⁻¹ = R⁻¹ Qᵀ of a square factor."""
    n = packed.shape[1]
    eye = torch.eye(n, dtype=packed.dtype, device=packed.device)
    qt = apply_sequence_on_left(packed, t_stack, eye, adjoint=True, block=block)
    return solve_upper_triangular(packed[:n, :n], qt)
