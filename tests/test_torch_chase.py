"""The port's bulge-chase probe (``chase_probe``) and its lab against the JAX
package.

The plain PyTorch version (what the wrapper runs for a CPU tensor) is
compared with the Pallas kernel (``faer_tpu/ops/pallas/band_chase.py``) run
in interpret mode on the CPU, on the same numpy strips from a seed, and with
the same steps in f64. The strip is Gaussian and not symmetric, so the
rank-2 steps are not similarities: the values grow and rounding differences
grow with them. At these short step counts (at most eight cycles of the
three windows) the tolerance is faer's 8·n·eps_f32 with n = 2b, the window's
side, relative to the largest entry of the output.
"""
import os
import runpy
import subprocess
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import faer_tpu_torch.ops.kernels.band_chase as tbc
from faer_tpu_torch.core.config import KERNELS, launch_counts, reset_launch_counts
from faer_tpu_torch.core.errors import ShapeError
from faer_tpu_torch.ops.kernels.band_chase import chase_probe, chase_probe_plain

torch.set_num_threads(1)

EPS32 = float(np.finfo(np.float32).eps)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAB = os.path.join(REPO, "tools", "torch_chase.py")


@pytest.fixture
def interp(monkeypatch):
    """Route every pallas_call through the interpreter (as in
    tests/test_pallas_kernels.py) and drop cached traces of the kernel."""
    from jax.experimental import pallas as pl

    import faer_tpu.ops.pallas.band_chase as bc

    orig = pl.pallas_call

    def interp_call(*args, **kwargs):
        kwargs["interpret"] = True
        kwargs.pop("compiler_params", None)
        return orig(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", interp_call)
    bc.chase_probe.clear_cache()
    yield types.SimpleNamespace(chase_probe=bc.chase_probe)
    bc.chase_probe.clear_cache()


def _strip(b, g, seed):
    return np.random.default_rng(seed).standard_normal((g * 4 * b, 2 * b)).astype(np.float32)


def _f64_steps(band, b, steps, g):
    """The plain step loop in f64 (``_window_step`` is dtype-generic)."""
    out = torch.from_numpy(band).double()
    for gi in range(g):
        for i in range(steps):
            off = gi * 4 * b + (i % 3) * b
            out[off:off + 2 * b] = tbc._window_step(out[off:off + 2 * b])
    return out.numpy()


def _close(got, want, b):
    top = np.abs(want).max()
    assert np.abs(got - want).max() <= 8 * 2 * b * EPS32 * top


@pytest.mark.parametrize("b,g,steps", [(16, 2, 6), (64, 1, 24), (8, 3, 0)])
def test_plain_matches_pallas_and_f64(b, g, steps, interp):
    band = _strip(b, g, b + g + steps)
    want = np.asarray(interp.chase_probe(jnp.asarray(band), b=b, steps=steps, g=g))
    got = chase_probe_plain(torch.from_numpy(band), b=b, steps=steps, g=g).numpy()
    assert got.shape == band.shape and np.all(np.isfinite(got))
    _close(got, want, b)
    _close(got, _f64_steps(band, b, steps, g), b)
    if steps == 0:
        assert np.array_equal(got, band)


def test_zero_tail_window_is_the_identity(interp):
    """Rows 2..b of the first window's column 0 are zero: tail_sq = 0, so
    τ = 0 and the first step changes nothing, in both versions, to the bit;
    the later steps still match. α = 0.75, whose square is exact in f32:
    XLA on the CPU fuses sq − α·α into one FMA, which leaves the rounding
    error of α², and where that is positive the Pallas kernel in interpret
    mode takes a zero tail for a reflection (τ = 2). The port rounds α·α on
    its own, as the body is written, so any zero tail gives τ = 0."""
    b, g = 16, 2
    band = _strip(b, g, 1)
    for gi in range(g):
        band[gi * 4 * b + 1, 0] = 0.75
        band[gi * 4 * b + 2:gi * 4 * b + b + 1, 0] = 0.0
    one = chase_probe_plain(torch.from_numpy(band), b=b, steps=1, g=g).numpy()
    assert np.array_equal(one, band)
    assert np.array_equal(np.asarray(interp.chase_probe(jnp.asarray(band), b=b,
                                                        steps=1, g=g)), band)
    want = np.asarray(interp.chase_probe(jnp.asarray(band), b=b, steps=4, g=g))
    _close(chase_probe_plain(torch.from_numpy(band), b=b, steps=4, g=g).numpy(), want, b)


def test_strips_are_independent():
    """Each strip of a g = 3 call equals a g = 1 call on that strip alone."""
    b = 8
    band = torch.from_numpy(_strip(b, 3, 2))
    out = chase_probe_plain(band, b=b, steps=7, g=3)
    for gi in range(3):
        rows = slice(gi * 4 * b, (gi + 1) * 4 * b)
        assert torch.equal(out[rows], chase_probe_plain(band[rows], b=b, steps=7, g=1))


def test_cpu_wrapper_takes_the_plain_version_and_counts_nothing():
    band = torch.from_numpy(_strip(8, 2, 3))
    reset_launch_counts()
    assert torch.equal(chase_probe(band, b=8, steps=5, g=2),
                       chase_probe_plain(band, b=8, steps=5, g=2))
    assert launch_counts() == dict.fromkeys(KERNELS, 0)


@pytest.mark.parametrize("x,kw,err", [
    (torch.zeros(64, 32), dict(b=16, steps=3, g=2), ShapeError),  # rows of g = 1
    (torch.zeros(64, 16), dict(b=16, steps=3, g=1), ShapeError),  # b columns
    (torch.zeros(64, 32), dict(b=16, steps=-1, g=1), ShapeError),
    (torch.zeros(64, 32), dict(b=16, steps=3, g=0), ShapeError),
    (torch.zeros(0, 0), dict(b=0, steps=3, g=1), ShapeError),
    (torch.zeros(64 * 32), dict(b=16, steps=3, g=1), ShapeError),
    (torch.zeros(64, 32, dtype=torch.float64), dict(b=16, steps=3, g=1), TypeError),
])
def test_wrapper_rejects_bad_inputs(x, kw, err):
    with pytest.raises(err):
        chase_probe(x, **kw)
    with pytest.raises(err):
        chase_probe_plain(x, **kw)


def test_lab_predictions_and_break_even_arithmetic():
    """The lab's grid (r5chase.py's 12 points), its launches, and the
    decision arithmetic of r5chase.py:8-14: 65 536 steps at n = 4096,
    b = 128, divided among g chains."""
    lab = runpy.run_path(LAB)
    assert len(lab["GRID"]) == 12
    assert {(b, g, s) for b, g, s in lab["GRID"]} == {
        (b, g, s) for b in (64, 128) for g in (1, 4, 8) for s in (256, 1024)}
    assert lab["predicted_launches"](5, 1) == {"chase_probe": 12 * 7}
    assert lab["chase_steps"]() == 65536
    cases = lab["break_even"]({1: 0.005, 4: 0.02}, reduction_ms=1000.0)
    assert [c["chase_ms"] for c in cases] == pytest.approx([327.68, 327.68])
    assert [c["share"] for c in cases] == pytest.approx([0.32768, 0.32768])
    assert not any(c["pays"] for c in cases)  # budget 0.3 of the reduction
    assert lab["break_even"]({8: 0.02}, reduction_ms=1000.0)[0]["pays"]


def test_lab_exits_without_a_card():
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, LAB, "--reps", "1", "--warmup", "0"],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0 and "{" not in proc.stdout
