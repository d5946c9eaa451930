"""Permutations as index tensors (counterpart of ``faer_tpu/core/perm.py``).

A permutation is an int64 index vector applied with one gather
(``index_select``); its inverse is a scatter. The swap helpers take their
indices as Python ints or as 0-d tensors on the operand's device, so a
pivot found on the card (``torch.argmax``) is applied without a host read;
``swap_rows_`` and ``swap_cols_`` swap in place, which the pivoted drivers'
loops use.
"""
from __future__ import annotations

import torch


def identity_perm(n: int, device=None):
    return torch.arange(n, dtype=torch.long, device=device)


def invert_perm(perm):
    n = perm.shape[0]
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(n, dtype=perm.dtype, device=perm.device)
    return inv


def permute_rows(a, perm):
    """Row i of the result is row ``perm[i]`` of ``a`` (faer ``permute_rows``)."""
    return a.index_select(0, perm)


def permute_cols(a, perm):
    return a.index_select(1, perm)


def permute_rows_inverse(a, perm):
    return permute_rows(a, invert_perm(perm))


def permute_cols_inverse(a, perm):
    return permute_cols(a, invert_perm(perm))


def pair_index(a, i, j):
    """The indices (i, j) as one int64 (2,) tensor on ``a``'s device; a
    driver that swaps several operands at one pivot forms it once."""
    def one(x):
        if isinstance(x, torch.Tensor):
            return x.reshape(1).to(torch.long)
        return torch.full((1,), int(x), dtype=torch.long, device=a.device)

    return torch.cat([one(i), one(j)])


def swap_rows_(a, i, j):
    """Swap rows (entries, for a vector) i and j of ``a`` in place; i == j
    leaves it as it is."""
    idx = pair_index(a, i, j)
    a[idx] = a[idx.flip(0)]
    return a


def swap_cols_(a, i, j):
    """Swap columns i and j of ``a`` in place."""
    idx = pair_index(a, i, j)
    a[:, idx] = a[:, idx.flip(0)]
    return a


def swap_rows(a, i, j):
    """A copy of ``a`` with rows i and j swapped (faer ``swap_rows_idx``)."""
    return swap_rows_(a.clone(), i, j)


def swap_cols(a, i, j):
    return swap_cols_(a.clone(), i, j)


def perm_to_matrix(perm, dtype=torch.float32):
    """Dense P with ``P @ a == permute_rows(a, perm)``."""
    n = perm.shape[0]
    out = torch.zeros((n, n), dtype=dtype, device=perm.device)
    out[torch.arange(n, device=perm.device), perm] = 1
    return out


def swaps_to_perm(swaps):
    """Fold the transpositions i ↔ swaps[i], applied in order i = 0, 1, …,
    into one permutation (LAPACK ipiv semantics), on the swaps' device."""
    n = swaps.shape[0]
    perm = identity_perm(n, swaps.device)
    for i in range(n):
        swap_rows_(perm, i, swaps[i])
    return perm


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
