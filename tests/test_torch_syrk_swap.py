"""What the CPU can check of the redesigned ``syrk_lower_sub`` and
``lu_panel_swap`` kernels: how the SYRK kernel reads A (``syrk_read``, from
strides and alignment alone), that both wrappers run their plain versions
on a CPU tensor, and that the timing and profile tools' ``syrk`` and
``lu_swap`` modes refuse to run without a card and load no JAX. The
kernels themselves run in ``tests/test_torch_gpu.py`` and ``chip_smoke.py``
on a card.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from faer_tpu_torch.ops.kernels.lu_panel_swap import lu_panel_swap, lu_panel_swap_plain
from faer_tpu_torch.ops.kernels.syrk import syrk_lower_sub, syrk_lower_sub_plain, syrk_read

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _offset(m, k):
    """An (m, k) row-major view one element past a 64-byte aligned base."""
    flat = torch.zeros(m * k + 1)
    return flat[1:].view(m, k)


# (label, operand, read): 16-byte reads along k (a transposing pass) need a
# unit k stride, a row stride that is a multiple of 4 and an aligned base;
# 16-byte copies along m a unit m stride; anything else 4-byte copies
# walking the smaller stride
READS = [("row-major k 256", lambda: torch.zeros(384, 256), "cp16_k"),
         ("row-major k 257", lambda: torch.zeros(300, 257), "cp4_k"),
         ("first 257 of 260 columns", lambda: torch.zeros(300, 260)[:, :257], "cp16_k"),
         ("M-major", lambda: torch.zeros(256, 384).mT, "cp16_mn"),
         ("M-major, m 301", lambda: torch.zeros(256, 301).mT, "cp4_mn"),
         ("offset", lambda: _offset(300, 256), "cp4_k"),
         ("one column", lambda: torch.zeros(129, 1), "cp4_k")]


@pytest.mark.parametrize("label,make,want", READS, ids=[r[0] for r in READS])
def test_syrk_read_follows_strides_and_alignment(label, make, want):
    a = make()
    assert a.data_ptr() % 16 == 0 or label == "offset"
    assert syrk_read(a) == want


@pytest.mark.parametrize("precision", ["highest", "high"])
def test_syrk_lower_sub_on_cpu_is_its_plain_version(precision, monkeypatch):
    """On a CPU tensor the wrapper runs the plain version: the whole matrix
    back, C − A·Aᵀ on and below the diagonal, C's values above it."""
    from faer_tpu_torch.core.config import config

    monkeypatch.setattr(config, "f32_precision", precision)
    rng = np.random.default_rng(5)
    c = torch.from_numpy(rng.standard_normal((70, 70)).astype(np.float32))
    a = torch.from_numpy(rng.standard_normal((70, 9)).astype(np.float32))
    got = syrk_lower_sub(c, a)
    assert torch.equal(got, syrk_lower_sub_plain(c, a))
    assert torch.equal(torch.triu(got, 1), torch.triu(c, 1))
    want = c.double() - a.double() @ a.double().T
    tol = 2e-5 if precision == "high" else 16 * float(np.finfo(np.float32).eps)
    scale = a.norm(dim=1).max().item() ** 2
    assert (torch.tril(got.double() - want)).abs().max().item() <= tol * scale


def test_lu_panel_swap_on_cpu_is_its_plain_version():
    rng = np.random.default_rng(6)
    a = torch.from_numpy(rng.standard_normal((90, 24)).astype(np.float32))
    for x, y in zip(lu_panel_swap(a), lu_panel_swap_plain(a)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("tool,mode", [("torch_split.py", "syrk"), ("torch_split.py", "lu_swap"),
                                       ("torch_profile.py", "lu_swap")])
def test_tool_modes_exit_without_a_card_and_import_no_jax(tool, mode):
    """``tools/torch_split.py syrk`` and ``lu_swap`` and ``tools/
    torch_profile.py lu_swap`` refuse to run without a card, printing no
    result; loading the tool and the two kernel modules loads neither JAX
    nor the JAX package."""
    path = os.path.join(REPO, "tools", tool)
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, path, mode], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and "{" not in proc.stdout and "ms" not in proc.stdout
    assert "CUDA card" in proc.stderr
    code = ("import sys, runpy, faer_tpu_torch.ops.kernels.syrk, "
            "faer_tpu_torch.ops.kernels.lu_panel_swap; "
            f"runpy.run_path({path!r}); "
            "bad = sorted(m for m in sys.modules if m in ('jax', 'faer_tpu') "
            "or m.startswith(('jax.', 'faer_tpu.'))); assert not bad, bad")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
