"""Semantics flags (counterpart of ``faer_tpu/core/flags.py``).

faer's ``Accum`` (``faer/src/lib.rs:869``), ``Conj`` and ``Side``: plain
Python enums, read on the host when a function is called. ``Side`` says
which triangle ``self_adjoint_eigenvalues`` reads. ``Accum`` and ``Conj``
keep the names for the complex dtypes and the accumulating front door of
later slices.
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
