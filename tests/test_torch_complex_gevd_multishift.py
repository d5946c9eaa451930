"""The port's complex ``gevd`` on the multishift route (n ≥ 128:
multishift QZ with AED, each AED window one ``complex_qz`` call and its
Givens phase one ``complex_hess_tri`` call), held as
``tests/test_torch_complex_gevd.py`` holds it below the route edge
(``check_complex_gevd``: the QZ step's backward errors and unitarity and
the pencil residual within 8·n·eps, (α, β) within 2·κ_i·η of f64
``scipy.linalg.eig`` in the chordal metric). Split from that file to keep
each file's time short.
"""
import pytest
import torch

from test_torch_complex_gevd import check_complex_gevd

torch.set_num_threads(1)


@pytest.mark.parametrize("n,name", [(128, "c128"), (130, "c64")])
def test_complex_gevd_slice(n, name, monkeypatch):
    """``gevd`` of a complex pencil at the route edge 128 and at 130."""
    check_complex_gevd(n, name, monkeypatch)
