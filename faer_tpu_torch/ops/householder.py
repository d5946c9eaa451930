"""Householder reflectors and compact-WY block application (counterpart of
``faer_tpu/ops/householder.py``).

faer ``make_householder_in_place`` (``householder.rs:117``) and the
``apply_block_householder_[sequence_]on_the_{left,right}`` family
(``:275-862``). Conventions (LAPACK, as in faer and the JAX package):

* ``H = I − τ v vᵀ`` with ``v[0] = 1`` and ``H x = β e₁``;
* a block of b reflectors is ``Q = H₀ H₁ ⋯ H_{b−1} = I − V T Vᵀ`` with V the
  unit-lower-trapezoidal panel and T upper triangular.

T is formed in closed form, ``T = (diag(1/τ) + strict_upper(VᴴV))⁻¹``: one
product and a triangular inverse, whose ≤ 128 blocks go to the ``trtri``
kernel in float32 and to the non-kernel inverse (leaves of side
min(b, 128)) in the other dtypes. Block application is three products.
For complex input (``faer_tpu/linalg/qr.py:50-60``) β is real, τ complex,
``H = I − τ v vᴴ`` with ``Hᴴ x = β e₁``, and the adjoints conjugate.

The norm is scaled where its squares would lose bits (:func:`make_householder`):
when ‖x‖² (in the QR panel kernel and its plain twins, :func:`rescale_of`)
or max|x|² (here: one reduction a column ahead of the squares) falls below
``tiny/eps`` of the real dtype, the reflector is formed from x times an
exact power of two (LAPACK ``xLARFG``, ``xNRM2``).
This deliberately differs from the reference, which keeps unscaled
squares (``faer_tpu/linalg/qr.py:51-53``) where XLA flushes subnormals to
zero; PyTorch keeps them, and a Gaussian column of scale 1e-20 in float32
then reconstructed to 56·n·eps. Above the threshold the scale is 1 and
every bit is as before.
"""
from __future__ import annotations

import math

import torch

from faer_tpu_torch.core import dtypes
from faer_tpu_torch.ops.matmul import matmul
from faer_tpu_torch.ops.triangular import invert_upper_triangular


def norm_rescale(dtype) -> tuple[float, float]:
    """``(threshold, scale)`` of the scaled reflector norm for ``dtype``'s
    real field: a column whose ‖x‖² is below ``tiny/eps`` (2⁻¹⁰³ in
    float32, 2⁻⁹⁷⁰ in float64) is scaled by ``2^⌈−log2(tiny)/2⌉`` (2⁶⁴,
    2⁵¹²) first, so that every entry from ``tiny`` up squares to a normal
    number and the scaled squares cannot overflow."""
    fi = torch.finfo(dtypes.real_dtype_of(dtype))
    return fi.tiny / fi.eps, 2.0 ** (round(-math.log2(fi.tiny)) // 2 + 1)


def rescale_of(norm_sq):
    """The exact power of two that the QR panel kernel and its plain twins
    scale a column by: :func:`norm_rescale`'s scale where ``norm_sq`` (‖x‖²
    formed unscaled, a 0-d tensor) is below its threshold, else 1 (every
    bit as before)."""
    thresh, big = norm_rescale(norm_sq.dtype)
    big = torch.full((), big, dtype=norm_sq.dtype, device=norm_sq.device)
    return torch.where(norm_sq < thresh, big, torch.ones_like(big))


def make_householder(x):
    """Reflector for a vector ``x`` of shape (m,): ``(v, tau, beta)`` with
    ``v[0] = 1`` and ``(I − τ v vᴴ)ᴴ x = β e₁``, β real-valued: larfg's
    τ = (β − α)/β and v = [1; tail/(α − β)], formed on x times
    :func:`norm_rescale`'s power of two where max|x|² is below tiny/eps, on
    x itself (every bit as before) otherwise. The test is one reduction, so
    that a column of scale 1 pays no second pass over its squares. A zero
    tail with a real x[0] gives τ = 0 (the identity) and β = x[0]."""
    thresh, big = norm_rescale(x.dtype)
    small = torch.linalg.vector_norm(x, float("inf")) < math.sqrt(thresh)
    xs = torch.where(small, x * big, x)  # exact: a power of two
    alpha, alpha_s, tail_s = x[0], xs[0], xs[1:]
    one = x.new_ones(())
    sq = dtypes.abs2
    tail_sq = sq(tail_s).sum()
    norm = torch.sqrt(sq(alpha_s) + tail_sq)
    a_re = alpha_s.real
    beta = torch.where(a_re >= 0, -norm, norm).to(x.dtype)
    is_id = tail_sq == 0
    if x.is_complex():
        is_id = is_id & (alpha.imag == 0)
    tau = torch.where(is_id, 0 * one, (beta - alpha_s) / torch.where(is_id, one, beta))
    v = torch.cat([x.new_ones(1),
                   torch.where(is_id, 0.0, tail_s / torch.where(is_id, one, alpha_s - beta))])
    return v, tau, torch.where(is_id, alpha, torch.where(small, beta * (1 / big), beta))


def form_block_t(v, tau):
    """Compact-WY T of an (m, b) unit-lower-trapezoidal V and its (b,) τ.

    τ = 0 columns (identity reflectors) get a unit pivot in the inverse and
    a zero row and column in T.
    """
    tau_safe = torch.where(tau == 0, torch.ones_like(tau), tau)
    tinv = torch.triu(matmul(None, v.mH, v), 1) + torch.diag(1.0 / tau_safe)
    live = (tau != 0).to(v.dtype)
    t = invert_upper_triangular(tinv, base=tinv.shape[0])
    return t * live[None, :] * live[:, None]


def apply_block_on_left(v, t, b_mat, *, adjoint: bool):
    """``Q B`` or ``Qᴴ B`` with ``Q = I − V T Vᴴ``, as a new tensor."""
    tw = matmul(None, t.mH if adjoint else t, matmul(None, v.mH, b_mat))
    return b_mat - matmul(None, v, tw)


def apply_block_on_right(v, t, b_mat, *, adjoint: bool):
    """``B Q`` or ``B Qᴴ``, as a new tensor."""
    tw = matmul(None, matmul(None, b_mat, v), t.mH if adjoint else t)
    return b_mat - matmul(None, tw, v.mH)


def _extract_panel_v(h_mat, j0: int, b: int):
    """Unit-lower-trapezoidal V of the panel of columns [j0, j0 + b)."""
    vp = h_mat[j0:, j0:j0 + b]
    return torch.tril(vp, -1) + torch.eye(vp.shape[0], b, dtype=vp.dtype,
                                          device=vp.device)


def apply_sequence_on_left(h_mat, t_stack, b_mat, *, adjoint: bool, block: int):
    """``Q B`` or ``Qᴴ B`` for ``Q = Π_j (I − V_j T_j V_jᴴ)``, the reflectors
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
    """``B Q`` or ``B Qᴴ`` (faer ``householder.rs:826``)."""
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
