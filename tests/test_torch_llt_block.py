"""The port's LLT diagonal-block kernels (``llt_block``, ``llt_block_v3``)
and their lab against the JAX package.

Each plain PyTorch version (what the wrapper runs for a CPU tensor) is
compared with its Pallas kernel (``llt_block_pallas``,
``llt_block_v3_pallas``) run in interpret mode on the CPU, on the same numpy
inputs from a seed, and with an f64 Cholesky factor. The Pallas bodies'
dots are HIGHEST and the port is FP32, so every comparison is faer's
8·b·eps_f32 (``utils/approx.py``). The lab's plugged-leaf factor
(``tools/torch_llt_blocks.py``) is compared with the reference lab's
``_llt_factor_variant`` (``tools/r4lab2.py:50-87``) on the Pallas leaf, and
its launch predictions with the launches of a CPU run counted by hand.
"""
import ast
import functools
import os
import runpy
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faer_tpu_torch.core.config import KERNELS, launch_counts, reset_launch_counts
from faer_tpu_torch.core.errors import ShapeError
from faer_tpu_torch.ops.kernels.llt_block import (
    llt_block, llt_block_plain, llt_block_v3, llt_block_v3_plain)
from faer_tpu_torch.utils.approx import assert_approx_eq, size_scale

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAB = os.path.join(REPO, "tools", "torch_llt_blocks.py")


@pytest.fixture
def interp(monkeypatch):
    """Route every pallas_call through the interpreter (as in
    tests/test_pallas_kernels.py) and drop cached traces of the kernels."""
    from jax.experimental import pallas as pl

    import faer_tpu.ops.pallas.panel_kernels as pk

    orig = pl.pallas_call

    def interp_call(*args, **kwargs):
        kwargs["interpret"] = True
        kwargs.pop("compiler_params", None)
        return orig(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", interp_call)
    fns = (pk.llt_block_pallas, pk.llt_block_v3_pallas)
    for fn in fns:
        fn.clear_cache()
    yield types.SimpleNamespace(v1=pk.llt_block_pallas, v3=pk.llt_block_v3_pallas)
    for fn in fns:
        fn.clear_cache()


PLAIN = {"v1": llt_block_plain, "v3": llt_block_v3_plain}
WRAPPER = {"v1": llt_block, "v3": llt_block_v3}


def _spd(b, seed):
    """g gᵀ/b + 2I, symmetric in full storage."""
    g = np.random.default_rng(seed).standard_normal((b, b))
    return (g @ g.T / b + 2 * np.eye(b)).astype(np.float32)


def _both(kernel, blk, interp, **reg):
    """(Pallas, plain) results as numpy (L, count, ok)."""
    lj, cj, oj = getattr(interp, kernel)(jnp.asarray(blk), **reg)
    lt, ct, ot = PLAIN[kernel](torch.from_numpy(blk), **reg)
    return (np.asarray(lj), int(cj), bool(oj)), (lt.numpy(), int(ct), bool(ot))


# b = 40 is ragged (the Pallas wrappers pad it to 128), 128 is not
@pytest.mark.parametrize("kernel", ["v1", "v3"])
@pytest.mark.parametrize("b", [40, 128])
def test_plain_matches_pallas_and_f64(kernel, b, interp):
    blk = _spd(b, b)
    (lj, cj, oj), (lt, ct, ot) = _both(kernel, blk, interp)
    assert (cj, oj) == (ct, ot) == (0, True)
    assert np.all(np.triu(lt, 1) == 0)
    assert_approx_eq(lt, lj, scale=size_scale(b), tol_dtype=np.float32)
    l64 = np.linalg.cholesky(blk.astype(np.float64))
    assert_approx_eq(lt, l64, scale=size_scale(b), tol_dtype=np.float32)


@pytest.mark.parametrize("kernel", ["v1", "v3"])
@pytest.mark.parametrize("b,count", [(40, 35), (128, 120)])
def test_regularized_counts_match_pallas(kernel, b, count, interp):
    """A[5, 5] = −1 with eps 1e-3, delta 1e-6: the replaced pivot's column
    is O(1/√eps), so later pivots go negative and are replaced in turn, and
    L overflows. The counts and ok must match, and L where it is finite."""
    blk = _spd(b, b)
    blk[5, 5] = -1.0
    (lj, cj, oj), (lt, ct, ot) = _both(kernel, blk, interp, eps=1e-3, delta=1e-6)
    assert (cj, oj) == (ct, ot) == (count, False)
    fin = np.isfinite(lj)
    assert np.array_equal(fin, np.isfinite(lt))
    assert_approx_eq(lt[fin], lj[fin], scale=size_scale(b), tol_dtype=np.float32)


@pytest.mark.parametrize("kernel", ["v1", "v3"])
@pytest.mark.parametrize("eps,delta,count", [(0.0, 0.0, 0), (1.0, 1e-6, 1)])
def test_non_positive_pivot_matches_pallas(kernel, eps, delta, count, interp):
    """A[5, 5] = −1 with eps = 0 (the pivot becomes 1) or eps = 1 (counted):
    L stays finite and within 8·b·eps of the Pallas kernel's, ok False."""
    b = 40
    blk = _spd(b, 7)
    blk[5, 5] = -1.0
    (lj, cj, oj), (lt, ct, ot) = _both(kernel, blk, interp, eps=eps, delta=delta)
    assert (cj, oj) == (ct, ot) == (count, False)
    assert np.all(np.isfinite(lt))
    assert_approx_eq(lt, lj, scale=size_scale(b), tol_dtype=np.float32)


def test_v1_and_v3_plain_agree_on_odd_sizes():
    """Every b from 1 to 20 (sub-blocks of 8 ragged or not, no trailing
    update at all): v1 and v3 agree with each other and with f64."""
    for b in range(1, 21):
        blk = _spd(b, 100 + b)
        l1, c1, o1 = llt_block_plain(torch.from_numpy(blk))
        l3, c3, o3 = llt_block_v3_plain(torch.from_numpy(blk))
        assert (int(c1), bool(o1)) == (int(c3), bool(o3)) == (0, True)
        l64 = np.linalg.cholesky(blk.astype(np.float64))
        for lt in (l1, l3):
            assert_approx_eq(lt.numpy(), l64, scale=size_scale(b), tol_dtype=np.float32)


def test_cpu_wrappers_take_the_plain_version_and_count_nothing():
    blk = torch.from_numpy(_spd(24, 3))
    reset_launch_counts()
    for kernel, wrapper in WRAPPER.items():
        for reg in ({}, {"eps": 1e-3, "delta": 1e-6}):
            for got, want in zip(wrapper(blk, **reg), PLAIN[kernel](blk, **reg)):
                assert torch.equal(got, want)
    assert launch_counts() == dict.fromkeys(KERNELS, 0)


@pytest.mark.parametrize("wrapper", [llt_block, llt_block_v3])
@pytest.mark.parametrize("x,err", [
    (torch.zeros(8, 8, dtype=torch.float64), TypeError),
    (torch.zeros(8, 6), ShapeError),
    (torch.zeros(8), ShapeError),
    (torch.zeros(0, 0), ShapeError),
    (torch.zeros(2, 8, 8), ShapeError),
])
def test_wrappers_reject_bad_inputs(wrapper, x, err):
    with pytest.raises(err):
        wrapper(x)


def _reference_variant():
    """``_llt_factor_variant`` from ``tools/r4lab2.py``, taken from its source
    without running the module (which sets up a persistent compile cache)."""
    path = os.path.join(REPO, "tools", "r4lab2.py")
    tree = ast.parse(open(path).read())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "_llt_factor_variant")
    ns = {"jnp": jnp, "jax": jax}
    exec(compile(ast.Module(body=[fn], type_ignores=[]), path, "exec"), ns)
    return ns["_llt_factor_variant"]


@pytest.mark.parametrize("block,leaf", [(256, 128), (128, 128)])
def test_lab_factor_matches_the_reference_lab(block, leaf, interp):
    """The lab's plugged-leaf factor with the v1 plain leaf against the
    reference lab's with the v1 Pallas leaf, n = 384 (a ragged last block at
    block 256), and both against f64."""
    lab = runpy.run_path(LAB)
    n = 384
    a = _spd(n, 5)
    want = np.asarray(jax.jit(functools.partial(
        _reference_variant(), block=block, leaf=leaf,
        leaf_fn=lambda blk: interp.v1(blk)[0]))(jnp.asarray(a)))
    got = lab["llt_factor_variant"](torch.from_numpy(a), block=block, leaf=leaf,
                                    leaf_fn=lambda blk: llt_block(blk)[0]).numpy()
    assert_approx_eq(got, want, scale=size_scale(n), tol_dtype=np.float32)
    assert_approx_eq(got, np.linalg.cholesky(a.astype(np.float64)),
                     scale=size_scale(n), tol_dtype=np.float32)


def _count_trtri_launches(monkeypatch, ttri, calls):
    """Wrap ``ops.triangular``'s two kernel wrappers so that ``calls["trtri"]``
    counts the launches they would make on a card: one for ``trtri``, one
    per ``MAX_BATCH`` blocks for ``trtri_batched``."""
    from faer_tpu_torch.ops.kernels.trtri import MAX_BATCH

    orig, orig_batched = ttri.trtri, ttri.trtri_batched

    def counted_trtri(*args, **kwargs):
        calls["trtri"] += 1
        return orig(*args, **kwargs)

    def counted_batched(t, blocks, **kwargs):
        calls["trtri"] += -(-len(blocks) // MAX_BATCH)
        return orig_batched(t, blocks, **kwargs)

    monkeypatch.setattr(ttri, "trtri", counted_trtri)
    monkeypatch.setattr(ttri, "trtri_batched", counted_batched)


@pytest.mark.parametrize("n,block,leaf", [(4096, 256, 128), (4096, 512, 256),
                                          (640, 256, 128), (384, 256, 128)])
def test_lab_launch_predictions_follow_the_code(n, block, leaf, monkeypatch):
    """The lab's leaf and trtri counts against a CPU run of the same calls,
    counted by wrapping the leaf, ``trtri`` and ``trtri_batched`` (the CPU
    wrappers count nothing); n = 4096 only by the arithmetic of the
    docstring."""
    lab = runpy.run_path(LAB)
    leaves, trtri = lab["variant_calls"](n, block, leaf)
    if n == 4096:
        assert leaves == n // leaf
        return
    import faer_tpu_torch.ops.triangular as ttri

    calls = {"leaf": 0, "trtri": 0}

    def leaf_fn(blk):
        calls["leaf"] += 1
        return llt_block_plain(blk)[0]

    _count_trtri_launches(monkeypatch, ttri, calls)
    a = torch.from_numpy(_spd(n, 9))
    lab["llt_factor_variant"](a, block=block, leaf=leaf, leaf_fn=leaf_fn)
    assert calls == {"leaf": leaves, "trtri": trtri}


def test_lab_recursive_predictions_follow_the_code(monkeypatch):
    """``_llt_panel_recursive(·, reg, 256)``'s leaves and trtri launches at
    the lab's block sizes, counted on a CPU run."""
    from faer_tpu_torch.core.params import LltRegularization
    from faer_tpu_torch.linalg import cholesky as tchol
    import faer_tpu_torch.ops.triangular as ttri

    lab = runpy.run_path(LAB)
    calls = {"leaf": 0, "trtri": 0}
    orig_leaf = tchol.llt_leaf

    def counted_leaf(*args, **kwargs):
        calls["leaf"] += 1
        return orig_leaf(*args, **kwargs)

    _count_trtri_launches(monkeypatch, ttri, calls)
    monkeypatch.setattr(tchol, "llt_leaf", counted_leaf)
    for b in lab["BLOCKS"]:
        calls.update(leaf=0, trtri=0)
        tchol._llt_panel_recursive(torch.from_numpy(_spd(b, b)), LltRegularization(),
                                   lab["RECURSIVE_BASE"])
        assert tuple(calls.values()) == lab["recursive_calls"](b)


def test_lab_predicted_launches():
    """Per factor: 4096/leaf leaves; the fused route's 16 panels; the block
    part's calls; every counter the lab reads."""
    lab = runpy.run_path(LAB)
    reps, warmup = 5, 1
    calls = 1 + warmup + reps
    want = lab["predicted_launches"](reps, warmup)
    assert set(want) == {"llt_block", "llt_block_v3", "llt_leaf", "trtri", "llt_panel"}
    per_kernel = sum(4096 // leaf for leaf in (128, 256) for _ in (256, 512))
    assert want["llt_block"] == want["llt_block_v3"] == calls * (3 + per_kernel) + 1
    # llt_leaf also runs inside _llt_panel_recursive: 1, 1 and 2 leaves
    assert want["llt_leaf"] == calls * (3 + 4 + per_kernel) + 1
    assert want["llt_panel"] == calls * 16
    # one batched trtri launch inverts the two 128-leaves of a 256 block
    assert lab["v5_panels"](4096) == 16 and lab["recursive_calls"](512) == (2, 1)


def test_lab_exits_without_a_card_and_imports_no_jax():
    """The lab refuses to run without a card, printing no result; importing
    it and the port's new modules loads neither JAX nor the JAX package."""
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, LAB, "--reps", "1", "--warmup", "0"],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0 and "{" not in proc.stdout
    code = ("import sys, runpy, faer_tpu_torch.ops.kernels.llt_block, "
            "faer_tpu_torch.ops.kernels.band_chase; "
            "runpy.run_path('tools/torch_llt_blocks.py')['_kernels'](); "
            "runpy.run_path('tools/torch_chase.py'); "
            "bad = sorted(m for m in sys.modules if m in ('jax', 'faer_tpu') "
            "or m.startswith(('jax.', 'faer_tpu.'))); "
            "assert not bad, bad")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
