"""Batched decompositions (counterpart of ``faer_tpu/linalg/batched.py``).

The JAX package maps each driver over a leading batch axis with
``jax.vmap``. The port's drivers launch hand-written kernels, which have no
batching rule, so each function here runs the driver once per problem and
stacks the results: ``a_batch`` is ``(*B, m, n)`` for any leading batch
shape ``B`` (one axis in the reference; the port flattens several), the
other operands carry the same leading ``B``, and every returned tensor and
every field of an info dataclass gains that leading ``B``. Any dtype the
drivers take (float32, float64, complex64, complex128); a float32 or
complex64 batch on the card launches each problem's kernels in turn.
"""
from __future__ import annotations

import dataclasses

import torch

from faer_tpu_torch.core.errors import ShapeError
from faer_tpu_torch.linalg import cholesky as _ch
from faer_tpu_torch.linalg import evd as _evd
from faer_tpu_torch.linalg import lu as _lu
from faer_tpu_torch.linalg import qr as _qr
from faer_tpu_torch.linalg import svd as _svd


def _stack(outs, batch):
    """The per-problem outputs ``outs`` stacked under the batch shape: a
    tensor, tuple, info dataclass, or a Python value that every problem
    shares (QR's block)."""
    first = outs[0]
    if isinstance(first, torch.Tensor):
        st = torch.stack(outs)
        return st.reshape(tuple(batch) + tuple(st.shape[1:]))
    if isinstance(first, tuple):
        return tuple(_stack([o[i] for o in outs], batch) for i in range(len(first)))
    if dataclasses.is_dataclass(first):
        return type(first)(**{f.name: _stack([getattr(o, f.name) for o in outs], batch)
                              for f in dataclasses.fields(first)})
    if first is None or all(o == first for o in outs):
        return first
    raise TypeError(f"batched: cannot stack {type(first).__name__} outputs")


def _map(fn, a_batch, *others):
    """``fn`` over the leading batch dimensions of ``a_batch`` (a stack of
    matrices) and of each operand in ``others``, the results stacked."""
    if a_batch.dim() < 3:
        raise ShapeError(f"batched: needs (*batch, m, n), got {tuple(a_batch.shape)}")
    batch = a_batch.shape[:-2]
    flat = [a_batch.reshape((-1,) + tuple(a_batch.shape[-2:]))]
    for x in others:
        if tuple(x.shape[:len(batch)]) != tuple(batch):
            raise ShapeError(f"batched: operand batch {tuple(x.shape)} does not lead "
                             f"with {tuple(batch)}")
        flat.append(x.reshape((-1,) + tuple(x.shape[len(batch):])))
    return _stack([fn(*args) for args in zip(*flat)], batch)


def llt_factor(a_batch, **kw):
    """Batched LLT: ``(L (*B, n, n), LltInfo of (*B,) fields)``."""
    return _map(lambda a: _ch.llt_factor(a, **kw), a_batch)


def llt_solve(l_batch, b_batch):
    return _map(_ch.llt_solve, l_batch, b_batch)


def llt_solve_batched(a_batch, b_batch):
    """Factor and solve each problem: ``(x, LltInfo)``."""

    def one(a, b):
        l, info = _ch.llt_factor(a)
        return _ch.llt_solve(l, b), info

    return _map(one, a_batch, b_batch)


def lu_factor(a_batch, **kw):
    """Batched partial-pivot LU: ``(lu, perm, LuInfo)``."""
    return _map(lambda a: _lu.lu_in_place(a, **kw), a_batch)


def lu_solve(lu_batch, perm_batch, b_batch):
    return _map(_lu.lu_solve, lu_batch, perm_batch, b_batch)


def qr_factor(a_batch, **kw):
    """Batched QR: ``(packed, t_stack)`` (the block is
    ``qr.qr_in_place``'s for the problem's shape)."""
    return _map(lambda a: _qr.qr_in_place(a, **kw)[:2], a_batch)


def qr_solve_lstsq_batched(a_batch, b_batch):
    def one(a, b):
        packed, ts, block = _qr.qr_in_place(a)
        return _qr.qr_solve_lstsq(packed, ts, block, b)

    return _map(one, a_batch, b_batch)


def svd(a_batch, **kw):
    """Batched SVD: ``(U, S, V, SpectralInfo)`` with leading batch dims."""
    return _map(lambda a: _svd.svd(a, **kw), a_batch)


def self_adjoint_evd(a_batch):
    return _map(_evd.self_adjoint_evd, a_batch)


def eigenvalues(a_batch):
    """Batched general eigenvalues, real or complex input (``evd.eigenvalues``
    on each matrix: complex64 and complex128 run the complex Schur form)."""
    return _map(_evd.eigenvalues, a_batch)
