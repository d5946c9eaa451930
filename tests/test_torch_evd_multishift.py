"""The port's multishift QR with aggressive early deflation
(``multishift_real_schur``) against ``faer_tpu`` and f64 numpy: a
companion of ``tests/test_torch_evd_general.py``, split from it to keep
each file's time short.

Inputs are made with numpy from a seed; the JAX multishift Schur form is
jitted once a module (``_jax``) and runs on the CPU with x64 on
(``tests/conftest.py``); the port runs on the CPU, every AED window
through the ``real_schur`` kernel's plain version. A Schur form can order
its blocks differently under different rounding, so the forms are
compared through sorted eigenvalues, ‖A − QTQᵀ‖/‖A‖, ‖QᵀQ − I‖, the
quasi-triangular shape, standardized 2×2 blocks and adjacent conjugate
pairs. Tolerances: the JAX package's own
(``tests/test_schur_multishift.py:46-50``: 2e-4 in float32 at 130–150,
1e-10 in float64 at 200; 2e-4 and trace/n within 1e-3 on the defective
cluster, ``:60``).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faer_tpu.linalg import real_schur as jrs
from faer_tpu.linalg import schur_multishift as jms
import faer_tpu_torch as ft
from faer_tpu_torch.core.config import host_reads, reset_launch_counts
from faer_tpu_torch.linalg import real_schur as trs
from faer_tpu_torch.linalg import schur_multishift as tms

torch.set_num_threads(1)

DT = {"f32": (torch.float32, jnp.float32, np.float32),
      "f64": (torch.float64, jnp.float64, np.float64)}


@functools.lru_cache(maxsize=None)
def _jax(fn_name):
    """The JAX package's function, jitted once a module."""
    return jax.jit({"ms": jms.multishift_real_schur}[fn_name])


def _check_schur(a, t, q, tol):
    """Converged-form checks: ‖A − QTQᵀ‖ ≤ tol·max(1, ‖A‖), ‖QᵀQ − I‖ ≤
    tol·n, nothing below the subdiagonal, 1×1 and 2×2 blocks only, each 2×2
    block standardized (equal diagonal, b·c < 0)."""
    an, tn, qn = (np.asarray(x, np.float64) for x in (a, t, q))
    n = an.shape[0]
    assert np.linalg.norm(qn @ tn @ qn.T - an) <= tol * max(1.0, np.linalg.norm(an))
    assert np.linalg.norm(qn.T @ qn - np.eye(n)) <= tol * n
    assert np.all(np.tril(tn, -2) == 0)
    sd = np.diag(tn, -1) != 0
    assert not np.any(sd[:-1] & sd[1:])
    for i in np.flatnonzero(sd):
        assert tn[i, i] == tn[i + 1, i + 1] and tn[i, i + 1] * tn[i + 1, i] < 0


def _sorted_close(w, wref, tol):
    w, wref = np.sort_complex(np.asarray(w)), np.sort_complex(np.asarray(wref))
    assert np.max(np.abs(w - wref)) <= tol * max(1.0, np.max(np.abs(wref)))


def _pair_eigs(t):
    wr, wi = trs.schur_eigenvalues_pair(t)
    return wr.double().numpy() + 1j * wi.double().numpy()


def _conjugates_adjacent(w):
    w = np.asarray(w)
    i = 0
    while i < len(w):
        if w.imag[i] != 0:
            assert w.imag[i] > 0 and w[i + 1] == np.conj(w[i])
            i += 2
        else:
            i += 1


# ---------------------------------------------------------------------------
# multishift QR with AED
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,name,tol,with_jax", [(130, "f32", 2e-4, False),
                                                 (150, "f32", 2e-4, True),
                                                 (200, "f64", 1e-10, False)])
def test_multishift_random(n, name, tol, with_jax):
    """``tests/test_schur_multishift.py:46``'s cases (and 130, just past the
    route edge), against f64 numpy and, at 150, the JAX package's
    multishift Schur form's eigenvalues; two host reads a round."""
    tdt, jdt, _ = DT[name]
    a = np.random.default_rng(n).standard_normal((n, n))
    h, q = ft.hessenberg_in_place(torch.tensor(a, dtype=tdt))
    reset_launch_counts()
    t, qs, info = tms.multishift_real_schur(h, q)
    rounds = int(info.iterations)
    assert bool(info.converged) and 0 < host_reads() <= 2 * rounds
    _check_schur(a, t, qs, tol)
    w = _pair_eigs(t)
    _sorted_close(w, np.linalg.eigvals(a), tol)
    _conjugates_adjacent(w)
    if with_jax:
        tj, _, infoj = _jax("ms")(jnp.asarray(h.numpy()), jnp.asarray(q.numpy()))
        wr, wi = jrs.schur_eigenvalues_pair(tj)
        _sorted_close(w, np.asarray(wr, np.float64) + 1j * np.asarray(wi, np.float64), tol)


def test_multishift_defective_cluster():
    """I + nilpotent at 150 in float32 (``tests/test_schur_multishift.py:
    60``): AED terminates and trace/n is exact."""
    n = 150
    a = np.eye(n) + np.diag(np.ones(n - 1), 1)
    h, q = ft.hessenberg_in_place(torch.tensor(a, dtype=torch.float32))
    t, qs, info = tms.multishift_real_schur(h, q)
    assert bool(info.converged)
    assert abs(float(torch.trace(t)) / n - 1.0) < 1e-3
    _check_schur(a, t, qs, 2e-4)


def test_spike_householder_scaled():
    """The AED spike's reflector from entries whose squares are subnormal
    in float32: orthogonal, mapping the spike's first k entries to a
    multiple of e0 and fixing the rest."""
    w, k = 8, 5
    s = torch.tensor([3e-21, -1e-21, 2e-21, 5e-22, 1e-21, 7.0, 7.0, 7.0])
    p = tms._spike_householder(w, s, torch.tensor(k))
    pn = p.double().numpy()
    assert np.abs(pn.T @ pn - np.eye(w)).max() <= 1e-6
    out = pn.T @ np.where(np.arange(w) < k, s.double().numpy(), 0.0)
    assert np.abs(out[1:]).max() <= 1e-6 * np.abs(out[0]) and abs(out[0]) > 3e-21
    assert np.abs(pn[k:, k:] - np.eye(w - k)).max() == 0


def test_gevd_split_mode_exits_without_a_card_and_imports_no_jax():
    """``tools/torch_split.py gevd`` refuses to run without a card, printing
    no result; loading it and the general EVD's modules loads neither JAX
    nor the JAX package."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = os.path.join(repo, "tools", "torch_split.py")
    env = dict(os.environ, PYTHONPATH=repo, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, path, "gevd"], cwd=repo, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and "{" not in proc.stdout
    assert "CUDA card" in proc.stderr
    code = ("import sys, runpy, faer_tpu_torch.linalg.evd, "
            "faer_tpu_torch.linalg.schur_multishift, faer_tpu_torch.linalg.eigvec; "
            f"runpy.run_path({path!r}); "
            "bad = sorted(m for m in sys.modules if m in ('jax', 'faer_tpu') "
            "or m.startswith(('jax.', 'faer_tpu.'))); assert not bad, bad")
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_sweep_ops_tool_counts_a_step():
    """``tools/torch_sweep_ops.py`` on the CPU at a small block: its last
    line one JSON object, the launching operations and views counted per
    inner step of one sweep over the block (3 chunks of 47 steps at 60)."""
    import json
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = os.path.join(repo, "tools", "torch_sweep_ops.py")
    env = dict(os.environ, PYTHONPATH=repo, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, path, "--n", "60"], cwd=repo, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    r = json.loads(proc.stdout.strip().splitlines()[-1])
    assert r["n"] == 60 and r["bulges"] == 16 and r["steps"] == 3 * 47
    assert r["launches_per_step"] > 0 and r["views_per_step"] > 0
    assert abs(sum(r["by_name"].values()) - r["launches_per_step"]) < 1e-9
