"""Kernel 12: ``lu_panel_v2``, the LU panel of the CALU tournament leaf.

Counterpart of ``lu_panel_v2_pallas`` (``faer_tpu/ops/pallas/lu_panel_v2.py:152``,
body ``:58``): the partial-pivot LU of an (m, b) f32 panel with virtual
pivots, returning ``(packed, perm, nt, ok)`` with the contract of
``lu_panel``: ``panel[perm] = L·U``, ``nt`` the minimal transposition count
of ``perm`` (``perm_transposition_count``), pivot ties to the lowest row.

The CALU leaf (``linalg/lu.py:_lu_leaf_calu``) factors ``ng`` independent
row groups, then their stacked pivot candidates. :func:`lu_panel_v2_batched`
factors a (g, m, b) stack of panels in one launch of ``csrc/lu_panel_batched.cu``
(one slice of CTAs for each panel), where the JAX package loops over the
groups; :func:`lu_panel_v2` is the same kernel on one panel, as
``lu_panel`` and ``lu_leaf`` are. Each counts one ``lu_panel_v2`` launch.
The plain version is ``lu_panel_plain`` at the Pallas body's sub-block
width of 8: the same virtual pivots and Neumann-coupled deferred rank-8
updates, in full FP32.
"""
from __future__ import annotations

import torch

from faer_tpu_torch.core.config import count_launch
from faer_tpu_torch.core.errors import ShapeError
from faer_tpu_torch.ops.kernels import _build
from faer_tpu_torch.ops.kernels.lu_panel import launch, launch_batched, lu_panel_plain

SUB_BLOCK = 8  # the Pallas body's sub-block width (``SB``)


def lu_panel_v2_plain(panel):
    """Plain PyTorch version of ``lu_panel_v2``: ``(packed, perm, nt, ok)``."""
    return lu_panel_plain(panel, sb=SUB_BLOCK)


def lu_panel_v2_batched_plain(panels):
    """Plain version of ``lu_panel_v2_batched``: each panel on its own,
    the results stacked."""
    outs = [lu_panel_v2_plain(p) for p in panels]
    return tuple(torch.stack(parts) for parts in zip(*outs))


def _check_stack(panels, name: str) -> None:
    """Raise unless ``panels`` is a (g, m, b) float32 stack, m ≥ b ≥ 1, g ≥ 1."""
    if panels.dtype != torch.float32:
        raise TypeError(f"{name}: needs float32, got {panels.dtype}")
    if panels.dim() != 3:
        raise ShapeError(f"{name}: needs a (g, m, b) stack, got shape {tuple(panels.shape)}")
    g, m, b = panels.shape
    if g < 1 or m < b or b < 1:
        raise ShapeError(f"{name}: needs g ≥ 1 and m ≥ b ≥ 1, got {(g, m, b)}")
    if panels.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {panels.device}")


def lu_panel_v2(panel):
    """Partial-pivot LU of an (m, b) float32 panel, m ≥ b ≥ 1, with the
    contract of ``lu_panel``. On a CUDA tensor the rows must be contiguous
    (any row stride)."""
    _build.check_panel(panel, "lu_panel_v2")
    if panel.device.type == "cpu":
        return lu_panel_v2_plain(panel)
    res = launch(panel)
    count_launch("lu_panel_v2")
    return res


def lu_panel_v2_batched(panels):
    """``lu_panel_v2`` of each (m, b) panel of a (g, m, b) float32 stack, in
    one launch: ``(packed, perm, nt, ok)`` with shapes (g, m, b), (g, m),
    (g,) and (g,). On a CUDA tensor the rows must be contiguous (any row and
    panel strides), and the call raises if the g panels cannot be
    co-resident even at one CTA each."""
    _check_stack(panels, "lu_panel_v2_batched")
    if panels.device.type == "cpu":
        return lu_panel_v2_batched_plain(panels)
    res = launch_batched(panels)
    count_launch("lu_panel_v2")
    return res
