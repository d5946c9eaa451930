"""Numerical policy and kernel launch counters (counterpart of
``faer_tpu/core/config.py``).

* **f32 GEMM policy: full FP32 by default.** Every ``torch.matmul`` of the
  port runs in IEEE float32 with float32 accumulation: no TF32.
  :func:`check_f32_policy` refuses to run if a caller switched TF32 on.
* **The tile GEMM switch** (``config``, counterpart of the JAX package's
  ``_Config``). ``use_tile_matmul`` (``None``: read ``FAER_TPU_USE_PALLAS``,
  the JAX package's own variable, so that one setting drives both packages;
  off when unset, as there) sends the front door's 2-D f32/bf16 products
  above 128³ to the hand-written ``tile_matmul``
  kernel. ``f32_precision`` (``FAER_TPU_F32_PRECISION``) picks that kernel's
  f32 mode: ``"highest"``, full FP32, the port's default since its first
  slice, which keeps every earlier path's numbers; or ``"high"``, the bf16x3
  split ``ah·bh + ah·bl + al·bh`` of the JAX package's default. ``"high"``
  changes only ``tile_matmul`` and ``syrk_lower_sub``: ``torch.matmul`` has
  no bf16x3 mode.
* **Launch counters.** Each kernel wrapper adds one to its counter where it
  launches its CUDA kernel, and nowhere else, so a run can show that the
  main path went through the kernels.
* **Host reads.** A driver that decides on the host (Bunch–Kaufman's panel
  end, a solver object's success check) reads the tensor through
  :func:`host_read`, which counts it, so a run can show how many host
  syncs a call made: none in a self-adjoint EVD or SVD call, whose QR
  iterations run on the card; a few a round in the general EVD's
  multishift driver, which decides on the host where its AED window sits
  and whether to sweep.

The JAX package's ``platform_scope`` and ``effective_platform`` have no
counterpart: the device is the input tensor's.
"""
from __future__ import annotations

import os

import torch

KERNELS = ("trtri", "llt_panel", "lu_panel", "qr_panel", "llt_leaf", "lu_leaf",
           "tridiag_sweep", "bidiag_sweep", "matmul", "syrk", "lu_panel_v2",
           "lu_panel_v3", "lu_panel_swap", "qr_panel_v1", "qr_panel_v2",
           "qr_panel_v3", "qr_leaf", "llt_block", "llt_block_v3", "chase_probe",
           "real_schur", "hess_tri", "real_qz", "complex_schur", "complex_hess_tri",
           "complex_qz")
F32_PRECISIONS = ("highest", "high")


class _Config:
    def __init__(self):
        self.use_tile_matmul: bool | None = None  # None: FAER_TPU_USE_PALLAS, else off
        self.f32_precision: str = os.environ.get("FAER_TPU_F32_PRECISION", "highest")

    def tile_matmul_enabled(self) -> bool:
        if self.use_tile_matmul is None:
            return os.environ.get("FAER_TPU_USE_PALLAS", "0") not in ("0", "false",
                                                                      "False", "")
        return self.use_tile_matmul

    def tile_precision(self) -> str:
        """``f32_precision``, checked: ``"highest"`` or ``"high"``."""
        if self.f32_precision not in F32_PRECISIONS:
            raise ValueError(f"f32_precision must be one of {F32_PRECISIONS}, "
                             f"got {self.f32_precision!r}")
        return self.f32_precision


config = _Config()

_launches = dict.fromkeys(KERNELS, 0)
_host_reads = 0


def check_f32_policy() -> None:
    """Raise unless f32 matmuls run in full FP32 (no TF32)."""
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "faer_tpu_torch needs full FP32 matmuls: "
            "torch.backends.cuda.matmul.allow_tf32 must be False")
    if torch.get_float32_matmul_precision() != "highest":
        raise RuntimeError(
            "faer_tpu_torch needs full FP32 matmuls: "
            "torch.get_float32_matmul_precision() must be 'highest'")


def count_launch(name: str) -> None:
    _launches[name] += 1


def launch_counts() -> dict[str, int]:
    """A copy of the per-kernel launch counters."""
    return dict(_launches)


def reset_launch_counts() -> None:
    """Set every launch counter and the host-read counter to 0."""
    global _host_reads
    for k in _launches:
        _launches[k] = 0
    _host_reads = 0


def host_read(t) -> list | int | float | bool:
    """``t.tolist()``, counted: on a CUDA tensor this is one host sync."""
    global _host_reads
    _host_reads += 1
    return t.tolist()


def host_reads() -> int:
    """How many :func:`host_read` calls were made since the last reset."""
    return _host_reads


_parallelism = None


def set_global_parallelism(par) -> None:
    """API parity with faer ``set_global_parallelism`` (``lib.rs:1123``)."""
    global _parallelism
    _parallelism = par


def get_global_parallelism():
    """The value last set, ``Par.AUTO`` before any."""
    from faer_tpu_torch.core.flags import Par

    return Par.AUTO if _parallelism is None else _parallelism
