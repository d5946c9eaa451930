"""Carrying factor state between ``faer_tpu`` and the port.

The library has no weights: its state is factor objects. These functions
turn the JAX package's factor outputs and solver objects, as numpy arrays,
into the port's tensors, info dataclasses and solver objects, and back, so
that a factor computed by one package can be solved by the other.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from faer_tpu_torch.core.errors import LltInfo, LuInfo, SpectralInfo


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


_INFO_TYPES = {"Llt": LltInfo, "PartialPivLu": LuInfo, "Svd": SpectralInfo,
               "SelfAdjointEigen": SpectralInfo}
_INDEX_FIELDS = ("row_perm",)  # int32 in the JAX package, int64 in the port
_INFO_DTYPES = {"dynamic_regularization_count": torch.int32,
                "transposition_count": torch.int32, "iterations": torch.int32,
                "success": torch.bool, "converged": torch.bool}


def solver_from_numpy(kind: str, *, device="cuda", **fields):
    """A port solver object (``linalg/solvers.py``) of class ``kind``
    (``"Llt"``, ``"PartialPivLu"``, ``"Qr"``, ``"Svd"`` or
    ``"SelfAdjointEigen"``) from the fields of the JAX package's solver
    dataclass of the same name, as numpy arrays: ``info`` as a mapping of
    its field names to arrays, ``Qr.block`` as an int. Data goes to
    ``device``."""
    from faer_tpu_torch.linalg.solvers import SOLVERS

    cls = SOLVERS[kind]
    out = {}
    for name, value in fields.items():
        if name == "info":
            out[name] = _INFO_TYPES[kind](**{
                k: _scalar(v, _INFO_DTYPES[k], device) for k, v in value.items()})
        elif name == "block":
            out[name] = int(value)
        else:
            arr = np.asarray(value)
            if name in _INDEX_FIELDS:
                arr = arr.astype(np.int64)
            out[name] = torch.tensor(arr).to(device)
    return cls(**out)


def solver_to_numpy(obj):
    """``(kind, fields)`` of a port solver object: the fields of the JAX
    dataclass of the same name as numpy arrays (``row_perm`` as int32, the
    JAX index type; ``info`` as a dict; ``block`` as an int), for
    ``faer_tpu.linalg.solvers.<kind>(**fields)`` once converted to arrays."""
    fields = {}
    for f in dataclasses.fields(obj):
        value = getattr(obj, f.name)
        if f.name == "info":
            fields[f.name] = {k.name: getattr(value, k.name).cpu().numpy()
                              for k in dataclasses.fields(value)}
        elif f.name == "block":
            fields[f.name] = int(value)
        else:
            arr = value.detach().cpu().numpy()
            fields[f.name] = arr.astype(np.int32) if f.name in _INDEX_FIELDS else arr
    return type(obj).__name__, fields
