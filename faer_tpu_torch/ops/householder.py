"""Householder reflectors and compact-WY block application (counterpart of
``faer_tpu/ops/householder.py``).

faer ``make_householder_in_place`` (``householder.rs:117``) and the
``apply_block_householder_[sequence_]on_the_{left,right}`` family
(``:275-862``). Conventions (LAPACK, as in faer and the JAX package):

* ``H = I − τ v vᵀ`` with ``v[0] = 1`` and ``H x = β e₁``;
* a block of b reflectors is ``Q = H₀ H₁ ⋯ H_{b−1} = I − V T Vᵀ`` with V the
  unit-lower-trapezoidal panel and T upper triangular.

T is formed in closed form, ``T = (diag(1/τ) + strict_upper(VᵀV))⁻¹``: one
product and a triangular inverse, whose ≤ 128 blocks go to the ``trtri``
kernel in float32 and to the non-kernel inverse (leaves of side
min(b, 128)) in float64. Block application is three products. The port's
dtypes are real, so the adjoint is the transpose.
"""
from __future__ import annotations

import torch

from faer_tpu_torch.ops.matmul import matmul
from faer_tpu_torch.ops.triangular import invert_upper_triangular


def make_householder(x):
    """Reflector for a vector ``x`` of shape (m,): ``(v, tau, beta)`` with
    ``v[0] = 1`` and ``(I − τ v vᵀ) x = β e₁``. A zero tail gives τ = 0
    (the identity) and β = x[0]."""
    alpha = x[0]
    tail = x[1:]
    tail_sq = (tail * tail).sum()
    one = x.new_ones(())
    norm = torch.sqrt(alpha * alpha + tail_sq)
    beta = -torch.where(alpha >= 0, one, -one) * norm
    is_id = tail_sq == 0
    safe_s = torch.where(is_id, one, alpha - beta)
    tau = torch.where(is_id, 0.0, (beta - alpha) / torch.where(is_id, one, beta))
    beta = torch.where(is_id, alpha, beta)
    v = torch.cat([x.new_ones(1), torch.where(is_id, 0.0, tail / safe_s)])
    return v, tau, beta


def form_block_t(v, tau):
    """Compact-WY T of an (m, b) unit-lower-trapezoidal V and its (b,) τ.

    τ = 0 columns (identity reflectors) get a unit pivot in the inverse and
    a zero row and column in T.
    """
    tau_safe = torch.where(tau == 0, torch.ones_like(tau), tau)
    tinv = torch.triu(matmul(None, v.mT, v), 1) + torch.diag(1.0 / tau_safe)
    live = (tau != 0).to(v.dtype)
    t = invert_upper_triangular(tinv, base=tinv.shape[0])
    return t * live[None, :] * live[:, None]


def apply_block_on_left(v, t, b_mat, *, adjoint: bool):
    """``Q B`` or ``Qᵀ B`` with ``Q = I − V T Vᵀ``, as a new tensor."""
    tw = matmul(None, t.mT if adjoint else t, matmul(None, v.mT, b_mat))
    return b_mat - matmul(None, v, tw)


def apply_block_on_right(v, t, b_mat, *, adjoint: bool):
    """``B Q`` or ``B Qᵀ``, as a new tensor."""
    tw = matmul(None, matmul(None, b_mat, v), t.mT if adjoint else t)
    return b_mat - matmul(None, tw, v.mT)


def _extract_panel_v(h_mat, j0: int, b: int):
    """Unit-lower-trapezoidal V of the panel of columns [j0, j0 + b)."""
    vp = h_mat[j0:, j0:j0 + b]
    return torch.tril(vp, -1) + torch.eye(vp.shape[0], b, dtype=vp.dtype,
                                          device=vp.device)


def apply_sequence_on_left(h_mat, t_stack, b_mat, *, adjoint: bool, block: int):
    """``Q B`` or ``Qᵀ B`` for ``Q = Π_j (I − V_j T_j V_jᵀ)``, the reflectors
    stored below the diagonal of ``h_mat`` and ``t_stack[p]`` the T of panel
    p (faer ``householder.rs:724``)."""
    n = min(h_mat.shape)
    panels = list(range(0, n, block))
    # a fresh copy of B, updated in place where the JAX package concatenates
    out = b_mat.clone(memory_format=torch.contiguous_format)
    for j0 in (panels if adjoint else reversed(panels)):
        bw = min(block, n - j0)
        vj = _extract_panel_v(h_mat, j0, bw)
        tj = t_stack[j0 // block][:bw, :bw]
        out[j0:] = apply_block_on_left(vj, tj, out[j0:], adjoint=adjoint)
    return out


def apply_sequence_on_right(h_mat, t_stack, b_mat, *, adjoint: bool, block: int):
    """``B Q`` or ``B Qᵀ`` (faer ``householder.rs:826``)."""
    n = min(h_mat.shape)
    panels = list(range(0, n, block))
    # a fresh copy of B, updated in place where the JAX package concatenates
    out = b_mat.clone(memory_format=torch.contiguous_format)
    for j0 in (reversed(panels) if adjoint else panels):
        bw = min(block, n - j0)
        vj = _extract_panel_v(h_mat, j0, bw)
        tj = t_stack[j0 // block][:bw, :bw]
        out[:, j0:] = apply_block_on_right(vj, tj, out[:, j0:], adjoint=adjoint)
    return out
