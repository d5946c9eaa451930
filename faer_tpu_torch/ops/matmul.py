"""GEMM front door (counterpart of ``faer_tpu/ops/matmul.py``).

faer ``matmul`` (``matmul/mod.rs:1617``) and its dispatcher
(``matmul_imp``, ``:1176``). As in the JAX package, the front door sends a
2-D product of two f32 or two bf16 operands with ``m·n·k`` above
``_SMALL_MATMUL`` to the hand-written tile kernel
(``ops/kernels/matmul.py:tile_matmul``, the twin of ``pallas_matmul``)
when the switch ``config.use_tile_matmul`` is on (``FAER_TPU_USE_PALLAS``;
off by default, as there) and the call pins no precision. Every other
product, batched ones included, goes to ``torch.matmul`` in full FP32.

``precision="highest"`` is the port's spelling of the JAX package's
``Precision.HIGHEST``: the call sites that pin it (the triangular inverses
and their applications, the LU U12 solves, the D&C top-level merges and
the QR iteration's rotation chains) never take the tile kernel, whatever
``config.f32_precision`` says.
"""
from __future__ import annotations

import torch

from faer_tpu_torch.core.config import check_f32_policy, config
from faer_tpu_torch.core.flags import Accum, Conj
from faer_tpu_torch.ops.kernels.matmul import tile_matmul

_TILE_DTYPES = (torch.float32, torch.bfloat16)
# below this m·n·k a product stays with torch.matmul (the JAX package's
# nano-GEMM threshold, faer matmul/mod.rs:16)
_SMALL_MATMUL = 128 ** 3


def _prep(x, conj: Conj, transpose: bool):
    if transpose:
        x = x.mT
    return x.conj() if conj is Conj.YES else x


def _torch_matmul(a, b):
    if a.is_cuda:
        check_f32_policy()
    return torch.matmul(a, b)


def _use_tile_matmul(a, b) -> bool:
    if not config.tile_matmul_enabled():
        return False
    if a.dim() != 2 or b.dim() != 2:
        return False
    if a.dtype != b.dtype or a.dtype not in _TILE_DTYPES:
        return False
    m, k = a.shape
    n = b.shape[1]
    return m * n * k > _SMALL_MATMUL


def _scale(prod, alpha):
    if isinstance(alpha, (int, float)) and alpha == 1.0:
        return prod
    return prod * alpha


def matmul(acc, lhs, rhs, *, alpha=1.0, accum: Accum = Accum.REPLACE,
           conj_lhs: Conj = Conj.NO, conj_rhs: Conj = Conj.NO,
           transpose_lhs: bool = False, transpose_rhs: bool = False,
           precision: str | None = None):
    """Return ``accum(acc) + alpha · op(lhs) @ op(rhs)`` as a new tensor.

    ``acc`` may be ``None`` when ``accum`` is ``REPLACE``. Leading batch
    dimensions broadcast through ``torch.matmul``. ``precision`` is ``None``
    (the dispatch above) or ``"highest"`` (always ``torch.matmul``, FP32).
    """
    if precision not in (None, "highest"):
        raise ValueError(f"matmul: precision must be None or 'highest', got {precision!r}")
    a = _prep(lhs, conj_lhs, transpose_lhs)
    b = _prep(rhs, conj_rhs, transpose_rhs)
    if precision is None and _use_tile_matmul(a, b):
        prod = tile_matmul(a, b)
    else:
        prod = _torch_matmul(a, b)
    prod = _scale(prod, alpha)
    if accum is Accum.ADD:
        if acc is None:
            raise ValueError("Accum.ADD requires an accumulator operand")
        prod = acc + prod
    return prod


def rank_update(acc, u, v, *, alpha=1.0, accum: Accum = Accum.ADD,
                conj_u: Conj = Conj.NO, conj_v: Conj = Conj.YES):
    """Rank-1 update ``acc + alpha · u vᴴ`` (faer ``matmul/mod.rs:1292``)."""
    uu = _prep(u.reshape(-1, 1), conj_u, False)
    vv = _prep(v.reshape(1, -1), conj_v, False)
    prod = _scale(uu * vv, alpha)
    return prod if accum is Accum.REPLACE else acc + prod


def matvec(a, x, *, conj_a: Conj = Conj.NO, transpose_a: bool = False):
    """y = op(A) x: always ``torch.matmul``, as the JAX package always
    hands it to XLA."""
    aa = _prep(a, conj_a, transpose_a)
    return _torch_matmul(aa, x[:, None])[:, 0] if x.dim() == 1 else _torch_matmul(aa, x)
