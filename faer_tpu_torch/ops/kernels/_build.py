"""Build and load the hand-written CUDA kernels of ``faer_tpu_torch/csrc``.

The ``.cu`` files have a plain C interface. At first use each is compiled
with ``nvcc`` for ``sm_90a`` in its own process, all at once, and the
objects are linked into one shared library under ``build/faer_tpu_torch/``
at the root of the checkout, named by a hash of the sources and of the
shared ``.cuh`` headers they include, so that an edit rebuilds and an
unchanged tree reuses the library. The library is loaded
with ``ctypes``. Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "faer_tpu_torch"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMPILE_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC"]
LINK_FLAGS = [*ARCH_FLAGS, "-shared"]

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
_IP = ctypes.POINTER(ctypes.c_int)
_SIGNATURES = {
    # name: argtypes (each returns an int: a CUDA error code, or the route
    # for faer_llt_block_route, faer_llt_panel_route, faer_qr_panel_route,
    # faer_lu_panel_route, faer_lu_panel_swap_route, faer_tridiag_qr_route,
    # faer_bidiag_qr_route, faer_real_schur_route, faer_hess_tri_route,
    # faer_real_qz_route and their _f64 twins, faer_complex_schur_route,
    # faer_complex_hess_tri_route, faer_complex_qz_route and their _c128
    # twins; bytes
    # for faer_chase_smem_bytes)
    "faer_tile_matmul": [_P, _L, _L, _P, _L, _L, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                         _P, _P, _P, _P, _P, _I, _P],
    "faer_syrk_lower_sub": [_P, _L, _L, _P, _L, _P, _I, _I, _I, _I, _P, _P, _I, _P, _L,
                            _P],
    "faer_trtri_batched": [_P, _L, _L, _IP, _I, _P, _I, _I, _P],
    "faer_llt_panel": [_P, _L, _P, _P, _L, _P, _I, _I, _F, _F, _P],
    "faer_llt_panel_route": [_I, _I, _IP, _IP, ctypes.POINTER(ctypes.c_longlong)],
    "faer_lu_panel_batched": [_P, _L, _L, _P, _P, _P, _P, _P, _L, _I, _I, _I, _P],
    "faer_lu_panel_route": [_I, _I, _I, _IP, ctypes.POINTER(ctypes.c_longlong)],
    "faer_lu_panel_clusters": [_I, _IP, _IP],
    "faer_lu_panel_swap": [_P, _L, _P, _P, _P, _P, _P, _L, _I, _I, _P],
    "faer_lu_panel_swap_route": [_I, _I, _IP, ctypes.POINTER(ctypes.c_longlong)],
    "faer_qr_panel": [_P, _L, _P, _P, _P, _L, _I, _I, _P],
    "faer_qr_panel_route": [_I, _I, _IP, ctypes.POINTER(ctypes.c_longlong)],
    "faer_qr_panel_clusters": [_I, _IP, _IP],
    "faer_tridiag_sweep": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _P],
    "faer_bidiag_sweep": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _P],
    "faer_tridiag_qr_batched": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "faer_tridiag_qr_route": [_I, _I],
    "faer_bidiag_qr_batched": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "faer_bidiag_qr_route": [_I, _I, _I],
    "faer_tridiag_qr_batched_f64": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "faer_tridiag_qr_route_f64": [_I, _I],
    "faer_bidiag_qr_batched_f64": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "faer_bidiag_qr_route_f64": [_I, _I, _I],
    "faer_real_schur_batched": [_P, _P, _P, _P, _I, _I, _I, _P],
    "faer_real_schur_batched_f64": [_P, _P, _P, _P, _I, _I, _I, _P],
    "faer_real_schur_route": [_I],
    "faer_real_schur_route_f64": [_I],
    "faer_complex_schur_batched": [_P, _P, _P, _P, _I, _I, _I, _P],
    "faer_complex_schur_batched_c128": [_P, _P, _P, _P, _I, _I, _I, _P],
    "faer_complex_schur_route": [_I],
    "faer_complex_schur_route_c128": [_I],
    "faer_complex_hess_tri_batched": [_P, _P, _P, _P, _P, _I, _I, _P],
    "faer_complex_hess_tri_batched_c128": [_P, _P, _P, _P, _P, _I, _I, _P],
    "faer_complex_hess_tri_route": [_I],
    "faer_complex_hess_tri_route_c128": [_I],
    "faer_complex_qz_batched": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "faer_complex_qz_batched_c128": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "faer_complex_qz_route": [_I],
    "faer_complex_qz_route_c128": [_I],
    "faer_hess_tri_batched": [_P, _P, _P, _P, _P, _I, _I, _P],
    "faer_hess_tri_batched_f64": [_P, _P, _P, _P, _P, _I, _I, _P],
    "faer_hess_tri_route": [_I],
    "faer_hess_tri_route_f64": [_I],
    "faer_real_qz_batched": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "faer_real_qz_batched_f64": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "faer_real_qz_route": [_I],
    "faer_real_qz_route_f64": [_I],
    "faer_llt_block": [_P, _I, _P, _P, _I, _F, _F, _I, _P],
    "faer_llt_block_route": [_I],
    "faer_chase_probe": [_P, _P, _P, _L, _I, _I, _I, _I, _I, _I, _P],
    "faer_chase_device": [_IP, _IP],
    "faer_chase_smem_bytes": [_I, _I, _I],
}

NOT_CO_RESIDENT = 100000  # returned by the cooperative entry points

_lib = None
build_seconds = None  # wall time of the nvcc runs, None when the library was reused
build_log = ""


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _library_path() -> Path:
    h = hashlib.sha256()
    # the shared headers too, so that an edit to one rebuilds
    for src in _sources() + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
    return BUILD_DIR / f"libfaer_tpu_torch_{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build(extra_flags: tuple[str, ...] = ()) -> Path:
    """Compile the kernels if the library for these sources is missing:
    one ``nvcc -c`` per source, all started together, then one link.
    ``extra_flags`` go to the compile steps."""
    global build_seconds, build_log
    so = _library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    objdir = so.with_suffix(f".{os.getpid()}.obj")
    objdir.mkdir()
    nvcc = _nvcc()
    t0 = time.perf_counter()
    jobs = []
    for src in _sources():
        obj = objdir / f"{src.stem}.o"
        cmd = [nvcc, *COMPILE_FLAGS, *extra_flags, "-c", str(src), "-o", str(obj)]
        jobs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for src, _, proc in jobs:  # wait for every compile, failed or not
        out, _ = proc.communicate()
        logs.append(out)
        if proc.returncode != 0:
            failed.append(f"{src.name} ({proc.returncode})")
    if not failed:
        link = subprocess.run([nvcc, *LINK_FLAGS, "-o", str(tmp),
                               *(str(obj) for _, obj, _ in jobs)],
                              capture_output=True, text=True)
        logs.append(link.stdout + link.stderr)
        if link.returncode != 0:
            failed.append(f"link ({link.returncode})")
    build_seconds = time.perf_counter() - t0
    build_log = "".join(logs)
    shutil.rmtree(objdir)
    if failed:
        raise RuntimeError(f"nvcc failed: {', '.join(failed)}:\n{build_log}")
    os.replace(tmp, so)  # atomic: a concurrent loader sees all or nothing
    return so


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(name: str, code: int) -> None:
    """Raise if a kernel entry point reported an error."""
    if code == NOT_CO_RESIDENT:
        raise RuntimeError(f"{name}: the cooperative grid cannot be co-resident")
    if code != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error code {code}")


def shared_edge(route, dtype, max_n: int) -> int:
    """The largest nmax in [1, max_n] for which ``route(nmax, dtype)`` says
    "shared" (a kernel keeps its matrices in shared memory up to a size,
    in global memory past it), by bisection. Needs the built library."""
    lo, hi = 1, max_n
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if route(mid, dtype) == "shared":
            lo = mid
        else:
            hi = mid - 1
    return lo


def check_f32_matrix(x, name: str) -> None:
    """Raise unless ``x`` is a 2-D float32 tensor on the CPU or a CUDA card."""
    import torch

    from faer_tpu_torch.core.errors import ShapeError

    if x.dtype != torch.float32:
        raise TypeError(f"{name}: needs float32, got {x.dtype}")
    if x.dim() != 2:
        raise ShapeError(f"{name}: needs a 2-D tensor, got shape {tuple(x.shape)}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {x.device}")


def check_panel(x, name: str) -> None:
    """Raise unless ``x`` is an (m, b) float32 panel with m, b ≥ 1. A wide
    panel (m < b) is one: the panel kernels factor its min(m, b) leading
    columns and carry the rest along, as the Pallas kernels do."""
    from faer_tpu_torch.core.errors import ShapeError

    check_f32_matrix(x, name)
    m, b = x.shape
    if m < 1 or b < 1:
        raise ShapeError(f"{name}: needs m, b ≥ 1, got {(m, b)}")


def grid(m: int, device, min_rows: int) -> tuple[int, int]:
    """(CTAs, rows per CTA) of a cooperative panel kernel: at most one CTA
    per SM, at least ``min_rows`` rows each, every CTA with some rows."""
    import torch

    sms = torch.cuda.get_device_properties(device).multi_processor_count
    g = max(1, min(sms, math.ceil(m / min_rows)))
    rpc = math.ceil(m / g)
    return math.ceil(m / rpc), rpc


def stream_of(x) -> int:
    """The handle of the current CUDA stream on ``x``'s device, by
    PyTorch's raw-handle query: a fraction of a microsecond, where building
    a ``torch.cuda.Stream`` object takes several."""
    import torch

    index = x.device.index if x.device.index is not None else torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)
