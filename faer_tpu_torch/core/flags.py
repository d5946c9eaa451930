"""Semantics flags (counterpart of ``faer_tpu/core/flags.py``).

faer's ``Accum`` (``faer/src/lib.rs:869``), ``Conj``, ``Side`` and
``Norm``: plain Python enums, read on the host when a function is called.
``Accum`` and ``Conj`` are the GEMM front door's options (``ops/matmul.py``),
``Side`` says which triangle a self-adjoint routine reads, and ``Norm``
selects ``ops.reductions.norm``.
"""
from __future__ import annotations

import enum


class Accum(enum.Enum):
    """What to do with the existing destination value: ``dst = acc ⊕ a·b``."""

    REPLACE = 0
    ADD = 1


class Conj(enum.Enum):
    """Whether an operand is implicitly conjugated."""

    NO = 0
    YES = 1


class Side(enum.Enum):
    """Which triangle of a self-adjoint matrix the input data lives in."""

    LOWER = 0
    UPPER = 1


class Norm(enum.Enum):
    """Norm selector for ``faer_tpu_torch.ops.reductions.norm``."""

    L1 = 0
    L2 = 1
    L2_SQR = 2
    MAX = 3
