"""Multishift QR with aggressive early deflation (AED): the real or complex
Schur form of a large Hessenberg matrix (counterpart of
``faer_tpu/linalg/schur_multishift.py`` and, on native complex tensors,
of ``faer_tpu/linalg/schur_multishift_cpair.py``).

faer ``multishift_qr`` (``real_schur.rs:2117``) with
``aggressive_early_deflation`` (``real_schur.rs:771``), LAPACK dlaqr0,
dlaqr3 and dlaqr5 for the shift counts, the NIBBLE sweep-skip rule and the
exceptional shifts. Each round:

* zeroes the negligible subdiagonal entries and moves ``hi`` past a
  trailing run of zero couplings;
* AED on the trailing w × w window: its Schur form (one launch of the
  ``real_schur`` kernel, or of ``complex_schur`` for complex input, on the
  card; their plain twins on the CPU), the spike test that deflates a
  trailing run of converged eigenvalues (a real 2×2 block deflates whole;
  a complex T is triangular, each eigenvalue tested alone), the shifts
  from the kept ones, the window made Hessenberg again
  (:func:`_spike_householder`, :func:`_window_rehess`) and written back
  with its row and column stripes;
* unless AED deflated a NIBBLE's worth of the window, one multishift sweep
  (:func:`_sweep`): ns/2 bulges 3 rows apart chased together (two shifts
  a bulge, a conjugate pair or any two complex shifts), every chase
  step one batched gather → rank-1 → scatter of their disjoint 3-row and
  3-column triples inside a W × W window, the window's accumulated U then
  applied to the off-window stripes as three GEMMs.

The driver decides on the host, as the JAX package's ``lax.while_loop``
decides on the device: ``hi`` after the trailing run, and then AED's
deflation count, ``lo`` and whether to sweep, two ``host_read`` calls a
round. The sweep's chase runs as host-issued batched launches, as the JAX
code's ``fori_loop`` does. Every product here is pinned to full FP32
(``precision="highest"``, never the bf16x3 tile kernel): they are
orthogonal-similarity updates applied O(rounds · n/step) times to the same
data, and the error of a lower precision compounds over the sweeps (the
JAX module pins ``HIGHEST`` for this reason, ``:49-55``).

One driver serves both fields: the reflectors conjugate (H = I − τ u uᴴ,
rows take Hᴴ), and ``conj`` and ``.mH`` of a real tensor are the tensor
and its transpose, so a real input runs the real operations, to the bit.
Only the window's Schur form, spike test and shifts branch on the dtype
(:func:`_aed_window_real`, :func:`_aed_window_complex`).
"""
from __future__ import annotations

import math

import torch

from faer_tpu_torch.core import dtypes
from faer_tpu_torch.core.config import host_read
from faer_tpu_torch.core.errors import SpectralInfo
from faer_tpu_torch.linalg.real_schur import real_schur, schur_eigenvalues_pair
from faer_tpu_torch.ops.matmul import matmul as _mm


def matmul(acc, a, b):
    """A product of this module: always full FP32 (module docstring)."""
    return _mm(acc, a, b, precision="highest")


def _params_for(n: int) -> tuple[int, int]:
    """(ns, w): shift count and AED window size (LAPACK ISPEC=15 table)."""
    if n < 590:
        ns = 32
    elif n < 3000:
        ns = 64
    else:
        ns = 128
    return ns, (3 * ns) // 2


def _house3_batch(v1, v2, v3):
    """Batched branchless 3-vector Householder (see real_schur._house3) of
    vectors already scaled to a largest magnitude of 1: u = (1, u2, u3)
    with (I − τ̄ u uᴴ) v = β e₁, β real (zlarfg's convention on complex
    input, ``schur_multishift_cpair._chouse3_batch``; for real input ``ᴴ``
    is ``ᵀ`` and every operation is the real one)."""
    tail2 = dtypes.abs2(v2) + dtypes.abs2(v3)
    nrm = torch.sqrt(dtypes.abs2(v1) + tail2)
    is_id = tail2 == 0
    if v1.is_complex():
        is_id = is_id & (v1.imag == 0)
    beta = torch.where(v1.real >= 0, -nrm, nrm)
    denom = torch.where(is_id, 1.0, v1 - beta)
    u2 = torch.where(is_id, 0.0, v2 / denom)
    u3 = torch.where(is_id, 0.0, v3 / denom)
    tau = torch.where(is_id, 0.0, (beta - v1) / torch.where(is_id, 1.0, beta))
    return tau, u2, u3


# ---------------------------------------------------------------------------
# multishift sweep
# ---------------------------------------------------------------------------

def _sweep(hp, qp, lo: int, hi: int, sb, pb, *, off: int, nb: int, step: int) -> None:
    """One multishift sweep chasing ``nb`` bulges through the active block
    [lo, hi] of the padded Hessenberg ``hp`` (the matrix at offset
    ``off``), Q's padded columns ``qp`` alongside. ``sb``/``pb`` (nb,) are
    each bulge's shift quadratic x² − s·x + p. The exact batched and
    windowed equivalent of the sequential Francis chase (the JAX module's
    docstring). In place."""
    dt, dev = hp.dtype, hp.device
    w_sz = step + 3 * nb + 1
    bidx = torch.arange(nb, device=dev)
    # local row of bulge b at inner step tt: tt + 1 + 3(nb − 1 − b)
    li_base = 1 + 3 * (nb - 1 - bidx)
    r3 = torch.arange(3, device=dev)
    rows3_base = (li_base[:, None] + r3[None, :]).reshape(-1)  # (3·nb,)
    # flat offsets in the window of each bulge's 3 × 3 patch, rows li..li+2
    # and columns li−1..li+1; step tt moves it down the diagonal by w_sz + 1
    patch_base = ((li_base[:, None, None] + r3[None, :, None]) * w_sz
                  + li_base[:, None, None] - 1 + r3[None, None, :]).reshape(nb, 9)
    eye = torch.eye(w_sz, dtype=dt, device=dev)
    zero = torch.zeros(nb, dtype=dt, device=dev)
    nchunks = math.ceil((hi - lo + 3 * nb) / step)
    # every step's bulges at once: their global rows ib = lo + t − 3b, which
    # are live, just introduced, or at the block's last row
    tb = torch.arange(nchunks * step, device=dev)[:, None] - 3 * bidx[None, :]
    ib_all = lo + tb
    active_all = (tb >= 0) & (ib_all <= hi - 1)
    intro_all = ib_all == lo
    last_all = ib_all == hi - 1
    for c in range(nchunks):
        t0 = c * step
        a = off + lo + t0 - 3 * (nb - 1) - 1  # the window's start (padded)
        # the window D over the accumulating U: one right update serves both
        du = torch.cat([hp[a:a + w_sz, a:a + w_sz], eye])
        dflat = du.view(-1)
        for tt in range(step):
            t = t0 + tt
            # reflector sources: the shift polynomial's column at the
            # introduction, the bulge's column after it
            # d[li + i, li − 1 + j] as p{i}{j}; d11 = d[li, li] and so on
            p00, d11, d12, p10, d21, d22, p20, _, d32 = dflat[
                patch_base + tt * (w_sz + 1)].unbind(1)
            intro = intro_all[t]
            v1 = torch.where(intro, d11 * d11 + d12 * d21 - sb * d11 + pb, p00)
            v2 = torch.where(intro, d21 * (d11 + d22 - sb), p10)
            v3 = torch.where(intro, d21 * d32, p20)
            v3 = torch.where(last_all[t], zero, v3)
            # a reflector is invariant under scaling of its vector
            vs = torch.stack([v1, v2, v3])
            scale = vs.abs().amax(0)
            vs = vs / torch.where(scale == 0, 1.0, scale)
            tau, u2, u3 = _house3_batch(*vs.unbind(0))
            tau = torch.where(active_all[t], tau, zero)
            rows3 = rows3_base + tt
            tau3, u23, u33 = tau[:, None, None], u2[:, None, None], u3[:, None, None]
            # left: rows li..li+2 of the window, w = uᴴ R
            rr = du[rows3].reshape(nb, 3, w_sz)
            wv = rr[:, 0:1] + u23.conj() * rr[:, 1:2] + u33.conj() * rr[:, 2:3]
            du[rows3] = (rr - tau3.conj() * torch.cat([wv, u23 * wv, u33 * wv], dim=1)
                         ).reshape(-1, w_sz)
            # right: the same triples of columns of the window and of U
            cc = du[:, rows3].reshape(2 * w_sz, nb, 3)
            wc = cc[:, :, 0] + u2 * cc[:, :, 1] + u3 * cc[:, :, 2]
            du[:, rows3] = (cc - tau[None, :, None] * torch.stack(
                [wc, u2.conj() * wc, u3.conj() * wc], dim=2)).reshape(2 * w_sz, -1)
        d, u = du[:w_sz], du[w_sz:]
        # the far field: full-stripe GEMMs (column stripe, then row stripe),
        # then the interior from the window
        hp[:, a:a + w_sz] = matmul(None, hp[:, a:a + w_sz], u)
        hp[a:a + w_sz, :] = matmul(None, u.mH, hp[a:a + w_sz, :])
        hp[a:a + w_sz, a:a + w_sz] = d
        qp[:, a:a + w_sz] = matmul(None, qp[:, a:a + w_sz], u)


# ---------------------------------------------------------------------------
# aggressive early deflation
# ---------------------------------------------------------------------------

def _spike_householder(w: int, s, k):
    """The full w × w Householder P = I − τ u uᴴ mapping the first ``k``
    entries of ``s`` to ±‖s[0:k)‖·e0 and fixing the entries from k on (the
    identity when k == 0; ``k`` a 0-d tensor). The vector is scaled by its
    largest magnitude first: its squares may underflow (PyTorch keeps
    subnormals, which XLA flushes). For real ``s`` every operation is the
    real reflector's."""
    dt, dev = s.dtype, s.device
    rows = torch.arange(w, device=dev)
    sm = torch.where(rows < k, s, torch.zeros_like(s))
    sc = sm.abs().amax()
    sm = sm / torch.where(sc == 0, torch.ones_like(sc), sc)
    alpha = sm[0]
    tail2 = torch.where(rows >= 1, dtypes.abs2(sm), 0.0).sum()
    nrm = torch.sqrt(dtypes.abs2(alpha) + tail2)
    is_id = tail2 == 0
    if s.is_complex():
        is_id = is_id & (alpha.imag == 0)
    is_id = is_id | (k <= 0)
    beta = torch.where(alpha.real >= 0, -nrm, nrm)
    one = torch.ones_like(alpha)
    denom = torch.where(is_id, one, alpha - beta)
    u = torch.where(rows >= 1, sm / denom, torch.zeros_like(sm))
    u = torch.where(is_id, torch.zeros_like(u), u)
    u[0] = torch.where(is_id, 0.0 * one, one)
    tau = torch.where(is_id, 0.0 * one, (beta - alpha) / torch.where(is_id, one, beta))
    return torch.eye(w, dtype=dt, device=dev) - tau * u[:, None] * u[None, :].conj()


def _window_rehess(t, v, k):
    """Masked Hessenberg reduction of the top-left k × k of the window
    ``t`` (entries from k on fixed; ``k`` a 0-d tensor), the similarity
    accumulated into ``v``: t ← Hᴴ t H, v ← v H with H = I − τ u uᴴ (for
    real input every operation is the real reduction's). New tensors."""
    w = t.shape[0]
    rows = torch.arange(w, device=t.device)
    one = torch.ones((), dtype=t.dtype, device=t.device)
    for j in range(max(w - 2, 0)):
        col = t[:, j]
        below1 = (rows > j + 1) & (rows < k)
        head = col[j + 1]
        tail2 = torch.where(below1, dtypes.abs2(col), 0.0).sum()
        nrm = torch.sqrt(dtypes.abs2(head) + tail2)
        is_id = tail2 == 0
        if t.is_complex():
            is_id = is_id & (head.imag == 0)
        is_id = is_id | (j >= k - 2)
        beta = torch.where(head.real >= 0, -nrm, nrm)
        denom = torch.where(is_id, one, head - beta)
        u = torch.where(below1, col / denom, 0.0)
        u = u + ((rows == j + 1) & ~is_id).to(t.dtype)
        tau = torch.where(is_id, 0.0 * one, (beta - head) / torch.where(is_id, one, beta))
        uc = u.conj()
        wv = matmul(None, uc[None, :], t)[0]
        t = t - tau.conj() * u[:, None] * wv[None, :]
        wu = matmul(None, t, u[:, None])[:, 0]
        t = t - tau * wu[:, None] * uc[None, :]
        vu = matmul(None, v, u[:, None])[:, 0]
        v = v - tau * vu[:, None] * uc[None, :]
    return t, v


def _aed_window_real(t, v, info, beta, smlnum, *, ns: int):
    """The real window's deflation test and shifts: a trailing run of
    converged eigenvalues of the quasi-triangular ``t`` (a 2×2 block
    deflating whole), and the (ns/2,) shift quadratics from the bottom-most
    ns kept eigenvalues. Returns ``(nd, sb, pb)`` on the device."""
    dt, dev = t.dtype, t.device
    eps = dtypes.eps(dt)
    w = t.shape[0]
    er, ei = schur_eigenvalues_pair(t)
    sd = t.diagonal(-1)
    spike = (beta * v[0, :]).abs()
    dmag = t.diagonal().abs()
    f = torch.zeros(1, dtype=torch.bool, device=dev)
    z = torch.zeros(1, dtype=dt, device=dev)
    is_top, is_bot = torch.cat([sd != 0, f]), torch.cat([f, sd != 0])
    pair_spk = torch.where(is_top, torch.maximum(spike, torch.cat([spike[1:], z])),
                           torch.maximum(spike, torch.cat([z, spike[:-1]])))
    m2 = torch.maximum(torch.maximum(dmag[:-1], dmag[1:]),
                       torch.maximum(t.diagonal(1).abs(), sd.abs()))
    mag = torch.where(is_top, torch.cat([m2, dmag[-1:]]),
                      torch.where(is_bot, torch.cat([dmag[:1], m2]), dmag))
    ok1 = spike <= torch.maximum(smlnum, eps * dmag)
    ok2 = pair_spk <= torch.maximum(smlnum, eps * mag)
    ok = torch.where(is_top | is_bot, ok2, ok1) & info.converged
    nd = torch.cumprod(ok.flip(0).to(torch.int32), 0).sum()
    k = w - nd

    # the shifts: the bottom-most ns kept eigenvalues (conjugate pairs stay
    # adjacent; a straddled pair moves the selection up by one)
    start = torch.clamp(k - ns, min=0).reshape(1)
    sd_at = torch.cat([z, sd])  # sd_at[i] = t[i, i − 1]
    start = torch.clamp(start - (sd_at.index_select(0, start) != 0).to(start.dtype), min=0)
    idx = start + torch.arange(ns, device=dev)
    ser = torch.cat([er, er.new_zeros(ns)]).index_select(0, idx)
    sei = torch.cat([ei, ei.new_zeros(ns)]).index_select(0, idx)
    sb = ser[0::2] + ser[1::2]
    pb = ser[0::2] * ser[1::2] - sei[0::2] * sei[1::2]
    return nd, sb, pb


def _aed_window_complex(t, v, info, beta, smlnum, *, ns: int):
    """The complex window's deflation test and shifts
    (``schur_multishift_cpair._aed``, ``:327-346``): T is triangular, so
    each eigenvalue is tested alone, |β|·|V[0, i]| ≤ max(smlnum, ε·|T[i,
    i]|), and the trailing run of passes deflates; the shifts are the
    bottom-most ns kept eigenvalues in pairs, s = s₁ + s₂ and p = s₁·s₂.
    Returns ``(nd, sb, pb)`` on the device."""
    eps = dtypes.eps(t.dtype)
    w = t.shape[0]
    diag = t.diagonal()
    spike = (beta * v[0, :].conj()).abs()
    ok = (spike <= torch.maximum(smlnum, eps * diag.abs())) & info.converged
    nd = torch.cumprod(ok.flip(0).to(torch.int32), 0).sum()
    start = torch.clamp(w - nd - ns, min=0).reshape(1)
    idx = start + torch.arange(ns, device=t.device)
    se = torch.cat([diag, diag.new_zeros(ns)]).index_select(0, idx)
    return nd, se[0::2] + se[1::2], se[0::2] * se[1::2]


def _aed(hp, qp, hi: int, smlnum, *, off: int, w: int, ns: int, lahqr_sweeps: int):
    """Aggressive early deflation on the window [hi − w + 1, hi] of the
    padded ``hp`` (``qp`` alongside, both in place): the window's Schur
    form by one launch of the ``real_schur`` or, for complex ``hp``, the
    ``complex_schur`` kernel (their plain twins on the CPU), the spike
    test, the shifts, the window made Hessenberg again and written back.
    Returns ``(nd, sb, pb)``: the deflation count (a 0-d tensor) and the
    (ns/2,) shift quadratics of the following sweep, all on the device."""
    dt, dev = hp.dtype, hp.device
    ws = off + hi - w + 1
    beta = hp[ws, ws - 1].clone()
    eye = torch.eye(w, dtype=dt, device=dev)
    window = hp[ws:ws + w, ws:ws + w].contiguous()
    if hp.is_complex():
        from faer_tpu_torch.linalg.complex_schur import complex_schur

        t, v, info = complex_schur(window, eye, max_sweeps_factor=lahqr_sweeps)
        nd, sb, pb = _aed_window_complex(t, v, info, beta, smlnum, ns=ns)
    else:
        t, v, info = real_schur(window, eye, max_sweeps_factor=lahqr_sweeps)
        nd, sb, pb = _aed_window_real(t, v, info, beta, smlnum, ns=ns)
    k = w - nd

    # Hessenberg form again on the kept part: the coupling column after the
    # window's similarity is Vᴴ(β e₀) = β·conj(V[0, :])
    spike_vec = beta * v[0, :].conj()
    p1 = _spike_householder(w, spike_vec, k)
    t = matmul(None, matmul(None, p1.mH, t), p1)
    v = matmul(None, v, p1)
    t, v = _window_rehess(t, v, k)

    # write back: the stripes, the interior, the spike column
    hp[:, ws:ws + w] = matmul(None, hp[:, ws:ws + w], v)
    hp[ws:ws + w, :] = matmul(None, v.mH, hp[ws:ws + w, :])
    hp[ws:ws + w, ws:ws + w] = t
    hp[ws:ws + w, ws - 1] = 0.0
    hp[ws, ws - 1] = beta * v[0, 0].conj()
    qp[:, ws:ws + w] = matmul(None, qp[:, ws:ws + w], v)
    return nd, sb, pb


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------

def multishift_real_schur(h, q, *, ns: int | None = None, w: int | None = None,
                          max_rounds: int | None = None, lahqr_sweeps: int = 30):
    """Real Schur form of the upper-Hessenberg ``h`` by multishift QR +
    AED: ``(t, q, info)`` with A = Q T Qᵀ for A = q h qᵀ, T
    quasi-triangular (1×1 and 2×2 diagonal blocks, each 2×2
    standardized); ``info.iterations`` counts the rounds. faer
    ``multishift_qr`` + ``aggressive_early_deflation``
    (``real_schur.rs:2117/:771``)."""
    return _multishift(h, q, ns=ns, w=w, max_rounds=max_rounds, lahqr_sweeps=lahqr_sweeps)


def multishift_complex_schur(h, q, *, ns: int | None = None, w: int | None = None,
                             max_rounds: int | None = None, lahqr_sweeps: int = 30):
    """Complex Schur form of the complex upper-Hessenberg ``h`` by
    multishift QR + AED: ``(t, q, info)`` with A = Q T Qᴴ for A = q h qᴴ, T
    upper triangular; ``info.iterations`` counts the rounds. faer
    ``complex_schur.rs:631`` (the counterpart of
    ``faer_tpu/linalg/schur_multishift_cpair.py:392`` on native complex
    tensors): two complex shifts a 3-row bulge, each AED window's Schur
    form one ``complex_schur`` launch, a per-eigenvalue spike test."""
    return _multishift(h, q, ns=ns, w=w, max_rounds=max_rounds, lahqr_sweeps=lahqr_sweeps)


def _multishift(h, q, *, ns, w, max_rounds, lahqr_sweeps):
    """The driver of both: real or complex by ``h``'s dtype (the AED's
    window Schur, spike test and shifts; every other operation is shared,
    and is the real one on real input)."""
    n = h.shape[0]
    dt, dev = h.dtype, h.device
    rdt = dtypes.real_dtype_of(dt)
    eps = dtypes.eps(dt)
    if ns is None or w is None:
        ns_a, w_a = _params_for(n)
        ns = ns if ns is not None else ns_a
        w = w if w is not None else w_a
    nb = ns // 2
    step = 3 * nb - 1
    if max_rounds is None:
        max_rounds = 30 * (n // ns + 2)
    pad = max(step + 3 * nb + 1, w) + 2
    off = pad
    hp = torch.zeros((n + 2 * pad, n + 2 * pad), dtype=dt, device=dev)
    hp[off:off + n, off:off + n] = h
    qp = torch.zeros((n, n + 2 * pad), dtype=dt, device=dev)
    qp[:, off:off + n] = q
    tiny = torch.tensor(dtypes.min_positive(dt), dtype=rdt, device=dev)
    smlnum = eps * torch.maximum(h.abs().amax(), tiny)
    idxn = torch.arange(n - 1, device=dev)
    jit_b = 1.0 + 0.02 * torch.arange(nb, dtype=rdt, device=dev)
    hi, rounds, stall = n - 1, 0, 0
    while hi >= 1 and rounds < max_rounds:
        # zero the negligible subdiagonal entries (matrix region), move hi
        # past a trailing run of zero couplings
        d = hp.diagonal()[off:off + n]
        sd = hp.diagonal(-1)[off:off + n - 1]
        tol = torch.maximum(eps * (d[:-1].abs() + d[1:].abs()), smlnum)
        sd.masked_fill_(sd.abs() <= tol, 0.0)
        run = torch.cumprod((sd[:hi].flip(0) == 0).to(torch.int32), 0).sum()
        hi -= host_read(run)
        if hi >= 1:
            nd, sb, pb = _aed(hp, qp, hi, smlnum, off=off, w=w, ns=ns,
                              lahqr_sweeps=lahqr_sweeps)
            hi2 = hi - nd
            cand = torch.where((idxn < hi2) & (sd == 0), idxn + 1, 0)
            lo = cand.amax()
            sweep = (nd * 100 < 14 * w) & (hi2 - lo >= 1)
            nd, lo, sweep = host_read(torch.stack([nd, lo, sweep.to(lo.dtype)]))
            hi2 = hi - nd
            stall = 0 if nd > 0 else stall + 1
            if stall % 6 == 5:  # exceptional shifts on long stalls (dlaqr0)
                h11 = hp[off + hi2, off + hi2]
                h21 = hp[off + hi2, off + max(hi2 - 1, 0)].abs()
                lam = 0.75 * h21 + h11
                sb = 2.0 * lam * jit_b
                pb = (lam * jit_b) ** 2
            if sweep:
                _sweep(hp, qp, lo, hi2, sb, pb, off=off, nb=nb, step=step)
            hi = hi2
        rounds += 1
    t = hp[off:off + n, off:off + n]
    qout = qp[:, off:off + n].clone()
    t = torch.triu(t, -1)
    d = t.diagonal()
    sdo = t.diagonal(-1)
    tol = torch.maximum(eps * (d[:-1].abs() + d[1:].abs()), smlnum)
    sdo.masked_fill_(sdo.abs() <= tol, 0.0)
    return t, qout, SpectralInfo(
        converged=torch.tensor(hi < 1, device=dev),
        iterations=torch.tensor(rounds, dtype=torch.int32, device=dev))
