"""Semantics flags (counterpart of ``faer_tpu/core/flags.py``).

faer's ``Accum`` (``faer/src/lib.rs:869``), ``Conj``, ``Side``, ``Par``
(``:929``), ``Norm``, ``NanHandling`` and the ``BlockStructure`` of the
triangular matmul (``matmul/triangular.rs:906``): plain Python enums, read
on the host when a function is called. ``Accum`` and ``Conj`` are the GEMM
front door's options (``ops/matmul.py``), ``Side`` says which triangle a
self-adjoint routine reads, ``BlockStructure`` is
``ops.triangular.triangular_matmul``'s, ``Norm`` selects
``ops.reductions.norm``; ``Par`` is kept for API parity (a card runs each
launch with all its SMs either way).
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

    @property
    def flip(self) -> "Conj":
        return Conj.YES if self is Conj.NO else Conj.NO


class Side(enum.Enum):
    """Which triangle of a self-adjoint matrix the input data lives in."""

    LOWER = 0
    UPPER = 1


class Par(enum.Enum):
    """Parallelism policy (faer's ``Par::Seq | Par::Rayon``), for parity."""

    SEQ = 0
    AUTO = 1


class BlockStructure(enum.Enum):
    """Structure of a matmul operand or destination block
    (``faer/src/linalg/matmul/triangular.rs:906``)."""

    RECTANGULAR = 0
    TRIANGULAR_LOWER = 1
    TRIANGULAR_UPPER = 2
    STRICT_TRIANGULAR_LOWER = 3
    STRICT_TRIANGULAR_UPPER = 4
    UNIT_TRIANGULAR_LOWER = 5
    UNIT_TRIANGULAR_UPPER = 6

    @property
    def is_lower(self) -> bool:
        return self in (BlockStructure.TRIANGULAR_LOWER,
                        BlockStructure.STRICT_TRIANGULAR_LOWER,
                        BlockStructure.UNIT_TRIANGULAR_LOWER)

    @property
    def is_upper(self) -> bool:
        return self in (BlockStructure.TRIANGULAR_UPPER,
                        BlockStructure.STRICT_TRIANGULAR_UPPER,
                        BlockStructure.UNIT_TRIANGULAR_UPPER)

    @property
    def is_strict(self) -> bool:
        return self in (BlockStructure.STRICT_TRIANGULAR_LOWER,
                        BlockStructure.STRICT_TRIANGULAR_UPPER)

    @property
    def is_unit(self) -> bool:
        return self in (BlockStructure.UNIT_TRIANGULAR_LOWER,
                        BlockStructure.UNIT_TRIANGULAR_UPPER)

    @property
    def transpose(self) -> "BlockStructure":
        if self is BlockStructure.RECTANGULAR:
            return self
        return BlockStructure(self.value + 1 if self.value % 2 else self.value - 1)


class Norm(enum.Enum):
    """Norm selector for ``faer_tpu_torch.ops.reductions.norm``."""

    L1 = 0
    L2 = 1
    L2_SQR = 2
    MAX = 3


class NanHandling(enum.Enum):
    """NaN policy for stats mean and variance (faer ``stats/mod.rs:3``)."""

    PROPAGATE = 0
    IGNORE = 1
