"""Carrying factor state between ``faer_tpu`` and the port.

The library has no weights: its state is factor objects. These functions
turn the JAX package's factor outputs and solver objects, as numpy arrays,
into the port's tensors, info dataclasses and solver objects, and back, so
that a factor computed by one package can be solved by the other. Complex
numpy arrays become complex64 or complex128 tensors and back; the JAX
package's split (re, im) pairs (its TPU path, ``factor_cpair``) become
native complex tensors (:func:`complex_from_pair`, and any field of
:func:`solver_from_numpy` given as an ``(re, im)`` tuple).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from faer_tpu_torch.core.errors import LbltInfo, LdltInfo, LltInfo, LuInfo, SpectralInfo


def _scalar(x, dtype, device):
    return torch.tensor(np.asarray(x)).to(dtype=dtype, device=device)


def complex_from_pair(re, im, device="cuda"):
    """The complex tensor ``re + i·im`` on ``device`` from a JAX (re, im)
    pair of real arrays (complex64 from float32, complex128 from float64)."""
    return torch.complex(torch.tensor(np.asarray(re)), torch.tensor(np.asarray(im))).to(device)


def complex_to_pair(x):
    """A complex tensor as the JAX package's ``(re, im)`` numpy pair."""
    x = x.detach().cpu().resolve_conj()
    return x.real.numpy(), x.imag.numpy()


def _array(value, device):
    """A numpy array, or an (re, im) pair of them, as a tensor on device."""
    if isinstance(value, tuple) and len(value) == 2:
        return complex_from_pair(*value, device=device)
    return torch.tensor(np.asarray(value)).to(device)


def llt_from_numpy(l, count, success, device="cuda"):
    """``(L, LltInfo)`` on ``device`` from the numpy outputs of ``llt_factor``."""
    info = LltInfo(dynamic_regularization_count=_scalar(count, torch.int32, device),
                   success=_scalar(success, torch.bool, device))
    return _array(l, device), info


def llt_to_numpy(l, info: LltInfo):
    """``(L, count, success)`` as numpy arrays."""
    return (l.detach().cpu().numpy(),
            info.dynamic_regularization_count.cpu().numpy(),
            info.success.cpu().numpy())


def lu_from_numpy(lu, perm, nt, success, device="cuda"):
    """``(lu, perm, LuInfo)`` on ``device`` from the numpy outputs of
    ``lu_in_place``; ``perm`` becomes an int64 index tensor."""
    info = LuInfo(transposition_count=_scalar(nt, torch.int32, device),
                  success=_scalar(success, torch.bool, device))
    return (_array(lu, device),
            torch.tensor(np.asarray(perm).astype(np.int64)).to(device), info)


def lu_to_numpy(lu, perm, info: LuInfo):
    """``(lu, perm, nt, success)`` as numpy arrays; ``perm`` as int32, the
    JAX package's index type."""
    return (lu.detach().cpu().numpy(), perm.cpu().numpy().astype(np.int32),
            info.transposition_count.cpu().numpy(), info.success.cpu().numpy())


def qr_from_numpy(packed, t_stack, block, device="cuda"):
    """``(packed, t_stack, block)`` on ``device`` from the numpy outputs of
    ``qr_in_place``."""
    return _array(packed, device), _array(t_stack, device), int(block)


def qr_to_numpy(packed, t_stack, block):
    """``(packed, t_stack, block)`` as numpy arrays and an int."""
    return (packed.detach().cpu().numpy(), t_stack.detach().cpu().numpy(),
            int(block))


def tridiag_from_numpy(d, e, hh, taus, device="cuda"):
    """``(d, e, hh, taus)`` on ``device`` from the numpy outputs of
    ``tridiag_in_place``, so either package's reflectors can be applied by
    the port's ``tridiag_apply_q``."""
    return tuple(_array(x, device) for x in (d, e, hh, taus))


def tridiag_to_numpy(d, e, hh, taus):
    """``(d, e, hh, taus)`` as numpy arrays."""
    return tuple(x.detach().cpu().numpy() for x in (d, e, hh, taus))


_INFO_TYPES = {"Llt": LltInfo, "Ldlt": LdltInfo, "PivLlt": LltInfo, "Lblt": LbltInfo,
               "PartialPivLu": LuInfo, "FullPivLu": LuInfo, "Svd": SpectralInfo,
               "SelfAdjointEigen": SpectralInfo, "Eigen": SpectralInfo,
               "GeneralizedEigen": SpectralInfo}
# int32 in the JAX package, int64 in the port
_INDEX_FIELDS = ("row_perm", "col_perm", "perm")
_INFO_DTYPES = {"dynamic_regularization_count": torch.int32,
                "transposition_count": torch.int32, "iterations": torch.int32,
                "success": torch.bool, "converged": torch.bool}


def solver_from_numpy(kind: str, *, device="cuda", **fields):
    """A port solver object (``linalg/solvers.py``) of class ``kind``
    (``"Llt"``, ``"Ldlt"``, ``"PivLlt"``, ``"Lblt"``, ``"PartialPivLu"``,
    ``"FullPivLu"``, ``"Qr"``, ``"ColPivQr"``, ``"Svd"``,
    ``"SelfAdjointEigen"``, ``"Eigen"``, whose ``w`` and ``v`` are
    complex, or ``"GeneralizedEigen"``, whose ``alpha``, ``beta`` and ``v``
    are) from the fields of the JAX package's solver
    dataclass of the same name, as numpy arrays: ``info`` as a mapping of
    its field names to arrays, ``Qr.block`` as an int, permutations as any
    integer array, a complex field as a complex array or an ``(re, im)``
    pair. Data goes to ``device`` in its own dtype (float64 stays float64,
    complex128 complex128)."""
    from faer_tpu_torch.linalg.solvers import SOLVERS

    cls = SOLVERS[kind]
    out = {}
    for name, value in fields.items():
        if name == "info":
            out[name] = _INFO_TYPES[kind](**{
                k: _scalar(v, _INFO_DTYPES[k], device) for k, v in value.items()})
        elif name == "block":
            out[name] = int(value)
        elif name in _INDEX_FIELDS:
            out[name] = torch.tensor(np.asarray(value).astype(np.int64)).to(device)
        else:
            out[name] = _array(value, device)
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
