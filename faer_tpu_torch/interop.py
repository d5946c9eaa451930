"""Carrying factor state between ``faer_tpu`` and the port.

The library has no weights: its state is factor objects. These functions
turn the JAX package's factor outputs, as numpy arrays, into the port's
tensors and info dataclasses, and back, so that a factor computed by one
package can be solved by the other.
"""
from __future__ import annotations

import numpy as np
import torch

from faer_tpu_torch.core.errors import LltInfo, LuInfo


def _scalar(x, dtype, device):
    return torch.tensor(np.asarray(x)).to(dtype=dtype, device=device)


def llt_from_numpy(l, count, success, device="cpu"):
    """``(L, LltInfo)`` on ``device`` from the numpy outputs of ``llt_factor``."""
    info = LltInfo(dynamic_regularization_count=_scalar(count, torch.int32, device),
                   success=_scalar(success, torch.bool, device))
    return torch.tensor(np.asarray(l)).to(device), info


def llt_to_numpy(l, info: LltInfo):
    """``(L, count, success)`` as numpy arrays."""
    return (l.detach().cpu().numpy(),
            info.dynamic_regularization_count.cpu().numpy(),
            info.success.cpu().numpy())


def lu_from_numpy(lu, perm, nt, success, device="cpu"):
    """``(lu, perm, LuInfo)`` on ``device`` from the numpy outputs of
    ``lu_in_place``; ``perm`` becomes an int64 index tensor."""
    info = LuInfo(transposition_count=_scalar(nt, torch.int32, device),
                  success=_scalar(success, torch.bool, device))
    return (torch.tensor(np.asarray(lu)).to(device),
            torch.tensor(np.asarray(perm).astype(np.int64)).to(device), info)


def lu_to_numpy(lu, perm, info: LuInfo):
    """``(lu, perm, nt, success)`` as numpy arrays; ``perm`` as int32, the
    JAX package's index type."""
    return (lu.detach().cpu().numpy(), perm.cpu().numpy().astype(np.int32),
            info.transposition_count.cpu().numpy(), info.success.cpu().numpy())


def qr_from_numpy(packed, t_stack, block, device="cpu"):
    """``(packed, t_stack, block)`` on ``device`` from the numpy outputs of
    ``qr_in_place``."""
    return (torch.tensor(np.asarray(packed)).to(device),
            torch.tensor(np.asarray(t_stack)).to(device), int(block))


def qr_to_numpy(packed, t_stack, block):
    """``(packed, t_stack, block)`` as numpy arrays and an int."""
    return (packed.detach().cpu().numpy(), t_stack.detach().cpu().numpy(),
            int(block))


def tridiag_from_numpy(d, e, hh, taus, device="cpu"):
    """``(d, e, hh, taus)`` on ``device`` from the numpy outputs of
    ``tridiag_in_place``, so either package's reflectors can be applied by
    the port's ``tridiag_apply_q``."""
    return tuple(torch.tensor(np.asarray(x)).to(device) for x in (d, e, hh, taus))


def tridiag_to_numpy(d, e, hh, taus):
    """``(d, e, hh, taus)`` as numpy arrays."""
    return tuple(x.detach().cpu().numpy() for x in (d, e, hh, taus))
