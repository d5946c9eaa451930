"""Numerical policy and kernel launch counters (counterpart of
``faer_tpu/core/config.py``).

* **f32 GEMM policy: full FP32.** Every f32 product of the port runs in
  IEEE float32 with float32 accumulation: no TF32. The JAX package's default
  is bf16x3 (``faer_tpu/ops/matmul.py:33-44``); on the GPU PyTorch's own
  default is already full FP32, and :func:`check_f32_policy` refuses to run
  if a caller switched TF32 on. The hand-written kernels use FP32 FMA only.
* **Launch counters.** Each kernel wrapper adds one to its counter where it
  launches its CUDA kernel, and nowhere else, so a run can show that the
  main path went through the kernels.
* **Host reads.** The spectral drivers decide on the host when an iteration
  is done; each such read of a tensor goes through :func:`host_read`,
  which counts it, so a run can show how many host syncs a call made.

The JAX package's ``platform_scope`` and ``effective_platform`` have no
counterpart: the device is the input tensor's.
"""
from __future__ import annotations

import torch

KERNELS = ("trtri", "llt_panel", "lu_panel", "qr_panel", "llt_leaf", "lu_leaf",
           "tridiag_sweep", "bidiag_sweep")

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
