"""What the CPU can check of the redesigned ``chase_probe`` kernel: the
arithmetic of its planner (``band_chase.plan``: the route, the CTAs of a
strip's cluster and the columns each holds, from b and the card's facts),
and that the timing and profile tools' ``chase`` modes refuse to run
without a card and load no JAX. The kernel itself runs in
``tests/test_torch_gpu.py`` and ``chip_smoke.py`` on a card.
"""
import math
import os
import subprocess
import sys

import pytest

from faer_tpu_torch.core.errors import ShapeError
from faer_tpu_torch.ops.kernels import band_chase as bc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHARED, GLOBAL = "cluster, strip in shared memory", "cluster, strip in global memory"
EDGE = bc.shared_edge()  # an H100's: 16-CTA clusters, 232 448 bytes a CTA


def test_the_h100_edge_is_the_last_b_a_16_cta_cluster_holds():
    """Up to the edge every strip lies in the shared memory of one cluster;
    past it no cluster of at most 16 CTAs holds it, so it takes the global
    copy, on the largest cluster."""
    assert EDGE == 288
    assert all(bc.plan(b).route == SHARED for b in range(1, EDGE + 1))
    assert all(bc.plan(b).route == GLOBAL for b in range(EDGE + 1, bc.MAX_B + 1))
    for k in range(1, 17):
        ctas, cw = bc._split(EDGE + 1, k)
        assert bc.smem_bytes(EDGE + 1, cw, True) > bc.H100[0]


# b: (route, CTAs of the cluster, columns a CTA)
PLANS = {16: (SHARED, 1, 32), 64: (SHARED, 4, 32), 84: (SHARED, 6, 28), 85: (SHARED, 6, 32),
         128: (SHARED, 8, 32), EDGE: (SHARED, 16, 36), EDGE + 1: (GLOBAL, 15, 40),
         1024: (GLOBAL, 16, 128)}


@pytest.mark.parametrize("b", sorted(PLANS))
def test_plan_at(b):
    """The plan at the named b: at most ``COLS_PER_CTA`` columns a CTA where
    the cluster allows, every CTA with some of the strip's 2b columns, the
    shared memory within the card's, the global copy sized for g strips."""
    route, ctas, cw = PLANS[b]
    for g in (1, 3):
        p = bc.plan(b, g)
        assert (p.route, p.ctas, p.cw) == (route, ctas, cw)
        assert cw % 4 == 0 and ctas == math.ceil(2 * b / cw) and (ctas - 1) * cw < 2 * b
        assert bc.smem_bytes(b, cw, route == SHARED) <= bc.H100[0]
        assert p.scratch == (0 if route == SHARED else g * 4 * b * ctas * cw)


def test_smem_counts_what_the_kernel_holds():
    """b = 128 in 8 CTAs of 32 columns: 512 rows of 36 floats, v on the 32
    columns, two slots of the 5 contributors' 256 partial sums (CTAs 0..4,
    whose columns meet 1..128), u and v, the 512-row column 0 and 20 floats
    of barriers and scalars."""
    assert bc.contributors(128, 32) == 5
    assert bc.smem_bytes(128, 32, True) == 4 * (512 * 36 + 32 + (2 * 5 + 2) * 256 + 512 + 20)
    assert bc.smem_bytes(128, 32, False) == 4 * (32 + (2 * 5 + 2) * 256 + 512 + 20)
    assert bc.smem_bytes(3, 8, True) == 4 * (12 * 12 + 8 + (2 * 1 + 2) * 8 + 12 + 20)


@pytest.mark.parametrize("facts", [(232448, 8), (232448, 4), (232448, 1), (200000, 16)])
def test_every_b_has_a_plan_on_smaller_cards(facts):
    """With smaller clusters (a card that places none of 16 CTAs) or less
    shared memory (static shared memory of another build) the edge moves
    down and every b up to ``MAX_B`` still has a plan within the card's
    limits."""
    edge = bc.shared_edge(*facts)
    assert 1 <= edge < EDGE
    for b in range(1, bc.MAX_B + 1, 7):
        p = bc.plan(b, 1, *facts)
        assert p.ctas <= facts[1] and bc.smem_bytes(b, p.cw, p.route == SHARED) <= facts[0]
        assert p.route == (SHARED if b <= edge else GLOBAL)


@pytest.mark.parametrize("b,g", [(0, 1), (bc.MAX_B + 1, 1), (64, 0)])
def test_plan_refuses(b, g):
    with pytest.raises(ShapeError):
        bc.plan(b, g)


@pytest.mark.parametrize("tool", ["torch_split.py", "torch_profile.py"])
def test_chase_modes_exit_without_a_card_and_import_no_jax(tool):
    """``tools/torch_split.py chase`` and ``tools/torch_profile.py chase``
    exist, refuse to run without a card, printing no result, and loading
    either tool and the kernel module loads neither JAX nor the JAX
    package."""
    path = os.path.join(REPO, "tools", tool)
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, path, "chase"], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and "{" not in proc.stdout and "ms" not in proc.stdout
    assert "CUDA card" in proc.stderr
    code = ("import sys, runpy, faer_tpu_torch.ops.kernels.band_chase; "
            f"tool = runpy.run_path({path!r}); "
            "modes = tool.get('ROWS', tool.get('KERNELS')); assert 'chase' in modes; "
            "bad = sorted(m for m in sys.modules if m in ('jax', 'faer_tpu') "
            "or m.startswith(('jax.', 'faer_tpu.'))); assert not bad, bad")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
