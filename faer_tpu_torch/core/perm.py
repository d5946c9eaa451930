"""Permutations as index tensors (counterpart of ``faer_tpu/core/perm.py``).

A permutation is an int64 index vector applied with one gather
(``index_select``); its inverse is a scatter.
"""
from __future__ import annotations

import torch


def invert_perm(perm):
    n = perm.shape[0]
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(n, dtype=perm.dtype, device=perm.device)
    return inv


def permute_rows(a, perm):
    """Row i of the result is row ``perm[i]`` of ``a`` (faer ``permute_rows``)."""
    return a.index_select(0, perm)


def permute_rows_inverse(a, perm):
    return permute_rows(a, invert_perm(perm))


def perm_transposition_count(perm):
    """Minimal transposition count of ``perm``: ``n − #cycles(perm)``.

    Pointer doubling over cycle-minimum labels, as at
    ``faer_tpu/core/perm.py:74-96``: ⌈log2 n⌉ rounds of two gathers, no
    sequential walk and no host sync. Returns an int32 tensor: a scalar for
    one permutation, one count each for a (..., n) stack of them.
    """
    n = perm.shape[-1]
    nxt = perm.long()
    idx = torch.arange(n, dtype=torch.long, device=perm.device).expand(perm.shape)
    mn = idx
    for _ in range(max(1, int(n - 1).bit_length())):
        mn = torch.minimum(mn, torch.gather(mn, -1, nxt))
        nxt = torch.gather(nxt, -1, nxt)
    # one position per cycle holds its cycle's minimum label
    ncyc = (mn == idx).sum(-1)
    return (n - ncyc).to(torch.int32)
