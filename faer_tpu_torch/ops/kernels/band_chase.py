"""Kernel 20: ``chase_probe``, serially dependent bulge-chase window steps.

Counterpart of ``chase_probe`` (``faer_tpu/ops/pallas/band_chase.py:89``,
body ``_chase_kernel`` ``:73``, step ``_window_step`` ``:39``), the probe
that measures what one window step of a band-to-tridiagonal chase costs,
which decides whether a two-stage reduction could replace the one-stage
one (``tools/torch_chase.py``).

Contract: ``band`` is a (g·4b, 2b) float32 strip; in each of its g strips
of 4b rows, step i works on the (2b, 2b) window at row offset
``(i mod 3)·b``; ``steps`` steps, each needing the one before (windows
overlap by b rows); returns the updated strip. Any other shape raises
``ShapeError``.

A step (:func:`_window_step`): the Householder v, τ that zeroes rows 2..b
of the window's column 0 (a zero tail, ``tail_sq ≤ 0``, gives τ = 0, the
identity), then u = τ·W v, γ = ½ τ vᵀu, w̃ = u − γ v and
W ← W − v w̃ᵀ − w̃ vᵀ. The strip is not symmetric, so the two-sided rank-2
step is not a similarity and the values grow with the steps.

The CUDA kernel (``csrc/band_chase.cu``) is one CTA per strip with the step
loop inside, one launch a call, as the Pallas kernel loops inside one
program.
"""
from __future__ import annotations

import torch

from faer_tpu_torch.core.config import count_launch
from faer_tpu_torch.core.errors import ShapeError
from faer_tpu_torch.ops.kernels import _build

MAX_B = 1024  # the largest b the CUDA route takes
N_WINDOWS = 3  # window offsets {0, b, 2b} in a strip of 4b rows


def _window_step(w):
    """One chase window step on a (2b, 2b) window (``band_chase.py:39-70``)."""
    tb = w.shape[0]
    b = tb // 2
    rows = torch.arange(tb, device=w.device)[:, None]
    one = w.new_ones(())
    sel = (rows >= 1) & (rows <= b)
    x = torch.where(sel, w[:, 0:1], 0.0)
    sq = (x * x).sum()
    alpha = x[1, 0]
    tail_sq = sq - alpha * alpha
    norm = torch.sqrt(sq)
    sign = torch.where(alpha >= 0, one, -one)
    beta = -sign * norm
    is_id = tail_sq <= 0.0
    safe_s = torch.where(is_id, one, alpha - beta)
    safe_b = torch.where(is_id, one, beta)
    tau = torch.where(is_id, 0.0 * one, (beta - alpha) / safe_b)
    v = torch.where(rows == 1, one, x * (1.0 / safe_s))
    v = torch.where(sel, v, 0.0)
    # u = τ·W v; w̃ = u − (τ/2)(vᵀu)·v
    u = (w @ v) * tau
    gamma = 0.5 * tau * (v * u).sum()
    wt = u - gamma * v
    return w - v * wt.reshape(1, tb) - wt * v.reshape(1, tb)


def chase_probe_plain(band, *, b: int, steps: int, g: int = 1):
    """Plain PyTorch version of ``chase_probe``: the step loop over
    :func:`_window_step` for each of the g strips in turn."""
    _check(band, b, steps, g)
    out = band.clone(memory_format=torch.contiguous_format)
    tb, r = 2 * b, 4 * b
    for gi in range(g):
        for i in range(steps):
            off = gi * r + (i % N_WINDOWS) * b
            out[off:off + tb] = _window_step(out[off:off + tb])
    return out


def _check(band, b: int, steps: int, g: int) -> None:
    _build.check_f32_matrix(band, "chase_probe")
    if b < 1 or steps < 0 or g < 1:
        raise ShapeError(f"chase_probe: needs b, g ≥ 1 and steps ≥ 0, got "
                         f"b={b}, steps={steps}, g={g}")
    if tuple(band.shape) != (g * 4 * b, 2 * b):
        raise ShapeError(f"chase_probe: needs a ({g * 4 * b}, {2 * b}) strip for "
                         f"b={b}, g={g}, got {tuple(band.shape)}")


def chase_probe(band, *, b: int, steps: int, g: int = 1):
    """Run ``steps`` serially dependent chase window steps on each of the g
    strips of ``band`` and return the updated (g·4b, 2b) strip. On a CUDA
    tensor b must be at most ``MAX_B``."""
    _check(band, b, steps, g)
    if band.device.type == "cpu":
        return chase_probe_plain(band, b=b, steps=steps, g=g)
    if b > MAX_B:
        raise ShapeError(f"chase_probe: b must be ≤ {MAX_B}, got {b}")
    band = band.contiguous()
    out = torch.empty_like(band)
    with torch.cuda.device(band.device):  # the C entry uses the current device
        code = _build.library().faer_chase_probe(
            band.data_ptr(), out.data_ptr(), b, steps, g, _build.stream_of(band))
    _build.check("chase_probe", code)
    count_launch("chase_probe")
    return out
