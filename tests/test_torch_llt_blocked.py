"""The blocked order of the port's LLT diagonal-block kernel against the JAX
package.

``csrc/llt_block.cu`` serves ``llt_leaf``, ``llt_block`` and
``llt_block_v3`` on a card, in an order of its own: 32-column panels, the
diagonal tile column by column, the rows below it by substitution, the
trailing block minus P·Pᵀ. ``llt_block_blocked_plain`` follows that order.
Here it is held against the three Pallas functions that compute the same
function (``llt_block_pallas``, ``llt_block_v3_pallas``,
``llt_block_v4_pallas``), run in interpret mode on the CPU, and against an
f64 Cholesky factor, on numpy inputs from a seed. The tolerance is faer's
8·b·eps_f32 (``utils/approx.py``) relative to max|L|.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from faer_tpu_torch.ops.kernels.leaf import llt_leaf
from faer_tpu_torch.ops.kernels.llt_block import (
    PANEL, llt_block, llt_block_blocked_plain, llt_block_v3)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EPS32 = float(np.finfo(np.float32).eps)
SIZES = (1, 7, 31, 32, 33, 64, 100, 128)
KERNELS = ("v1", "v3", "v4")
# v1's Pallas wrapper pads every block to 128 and costs the same at every
# size in interpret mode; v3's and v4's bodies unroll their sub-blocks and
# take 3-14 s a size from b = 31 on, so they are held at a ragged block
# inside one sub-block (7) and at one column past a panel (33)
CASES = [("v1", b) for b in SIZES] + [(k, b) for k in ("v3", "v4") for b in (7, 33)]


@pytest.fixture(scope="module")
def pallas():
    """``pallas(kernel, name, blk, **reg)``: a Pallas kernel's numpy
    ``(L, count, ok)`` in interpret mode, computed once per case (as in
    ``tests/test_pallas_kernels.py``, every pallas_call through the
    interpreter, cached traces dropped before and after)."""
    from jax.experimental import pallas as pl

    import faer_tpu.ops.pallas.leaf_v4 as leaf4
    import faer_tpu.ops.pallas.panel_kernels as pk

    orig = pl.pallas_call

    def interp_call(*args, **kwargs):
        kwargs["interpret"] = True
        kwargs.pop("compiler_params", None)
        return orig(*args, **kwargs)

    fns = {"v1": pk.llt_block_pallas, "v3": pk.llt_block_v3_pallas,
           "v4": leaf4.llt_block_v4_pallas}
    cache = {}

    def run(kernel, name, blk, **reg):
        key = (kernel, name, tuple(sorted(reg.items())))
        if key not in cache:
            l, c, o = fns[kernel](jnp.asarray(blk), **reg)
            cache[key] = (np.asarray(l), int(c), bool(o))
        return cache[key]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pl, "pallas_call", interp_call)
        for fn in fns.values():
            fn.clear_cache()
        yield run
    for fn in fns.values():
        fn.clear_cache()


def _spd(b, seed):
    """g gᵀ/b + 2I, symmetric in full storage."""
    g = np.random.default_rng(seed).standard_normal((b, b))
    return (g @ g.T / b + 2 * np.eye(b)).astype(np.float32)


def _regularized(b, bad, seed):
    """L Lᵀ − 1e-3·Σ e_k e_kᵀ over the ``bad`` columns k, where L has 0 on
    the diagonal there and [1.5, 2.5] elsewhere: the bad pivots are clearly
    negative, every other pivot at least 2.25 (``chip_smoke.py``'s
    ``_regularized_spd``)."""
    rng = np.random.default_rng(seed)
    lo = np.tril(rng.standard_normal((b, b)) / np.sqrt(b), -1)
    diag = 1.5 + rng.random(b)
    diag[bad] = 0.0
    lo = lo + np.diag(diag)
    a = lo @ lo.T
    a[bad, bad] -= 1e-3
    return a.astype(np.float32)


def _blocked(blk, **kw):
    l, c, o = llt_block_blocked_plain(torch.from_numpy(blk), **kw)
    return l.numpy(), int(c), bool(o)


def _close(got, want, b):
    """max|got − want| ≤ 8·b·eps_f32 · max|want|."""
    err = np.abs(got.astype(np.float64) - want).max()
    assert err <= 8 * b * EPS32 * np.abs(want).max(), err


@pytest.mark.parametrize("kernel,b", CASES)
def test_blocked_order_matches_pallas(kernel, b, pallas):
    blk = _spd(b, b)
    lj, cj, oj = pallas(kernel, f"spd{b}", blk)
    lt, ct, ot = _blocked(blk)
    assert (cj, oj) == (ct, ot) == (0, True)
    assert np.all(np.triu(lt, 1) == 0)
    _close(lt, lj, b)


@pytest.mark.parametrize("nb", [PANEL, 8, 1])
@pytest.mark.parametrize("b", SIZES)
def test_blocked_order_matches_f64(b, nb):
    """At the kernel's panel width and at two others (nb = 1 is the
    unblocked column loop)."""
    blk = _spd(b, b)
    lt, ct, ot = _blocked(blk, nb=nb)
    assert (ct, ot) == (0, True)
    _close(lt, np.linalg.cholesky(blk.astype(np.float64)), b)


@pytest.mark.parametrize("kernel,b,bad,reg,want", [
    ("v1", 128, [3, 20, 77], dict(eps=1.0, delta=1.0), (3, False)),
    *((k, 40, [3, 20, 37], dict(eps=1.0, delta=1.0), (3, False)) for k in KERNELS),
    *((k, 40, [3, 20, 37], dict(eps=0.0, delta=0.0), (0, False)) for k in KERNELS),
])
def test_blocked_order_regularized_matches_pallas(kernel, b, bad, reg, want, pallas):
    """With eps = delta = 1 the three negative pivots are replaced and
    counted; with eps = 0 the first negative pivot becomes 1. ok is False
    either way, and L agrees where it is finite."""
    blk = _regularized(b, bad, b)
    lj, cj, oj = pallas(kernel, f"reg{b}", blk, **reg)
    lt, ct, ot = _blocked(blk, **reg)
    assert (cj, oj) == (ct, ot) == want
    fin = np.isfinite(lj)
    assert np.array_equal(fin, np.isfinite(lt))
    _close(lt[fin], lj[fin], b)


def test_blocked_order_reads_only_the_lower_triangle():
    blk = _spd(70, 3)
    junk = blk + np.triu(np.random.default_rng(4).standard_normal((70, 70)), 1)
    for got, want in zip(_blocked(junk.astype(np.float32)), _blocked(blk)):
        assert np.array_equal(got, want)


@pytest.mark.parametrize("fn", [llt_leaf, llt_block, llt_block_v3,
                                llt_block_blocked_plain])
def test_row_strided_views_factor_like_contiguous_blocks(fn):
    """The recursive driver hands its leaves over as (b, b) views of a
    larger matrix; on the CPU every wrapper and the blocked order give the
    bits of a contiguous copy."""
    big = torch.from_numpy(_spd(40, 9))
    view = big[:37, :37]
    assert view.stride(0) == 40
    for got, want in zip(fn(view), fn(view.contiguous())):
        assert torch.equal(got, want)


@pytest.mark.parametrize("tool", ["torch_split.py", "torch_profile.py"])
def test_timing_tools_exit_without_a_card_and_import_no_jax(tool):
    """The per-call/device split and the phase profile of the LLT block
    refuse to run without a card, printing no result, and load neither JAX
    nor the JAX package."""
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    path = os.path.join(REPO, "tools", tool)
    proc = subprocess.run([sys.executable, path, "llt"], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and "{" not in proc.stdout and "b=" not in proc.stdout
    assert "CUDA card" in proc.stderr
    code = (f"import sys, runpy; runpy.run_path({path!r}); "
            "bad = sorted(m for m in sys.modules if m in ('jax', 'faer_tpu') "
            "or m.startswith(('jax.', 'faer_tpu.'))); assert not bad, bad")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
