"""Multishift QZ with aggressive early deflation (AED): the generalized
Schur form of a large complex Hessenberg/triangular pencil (counterpart, on
native complex tensors, of ``faer_tpu/linalg/qz_multishift_cpair.py``).

faer ``qz_cplx`` (``qz_cplx/mod.rs:1140``) with the batched execution of
``schur_multishift``: the pencil (H, T), H Hessenberg and T upper
triangular. Each round:

* zeroes the negligible subdiagonal entries of H and moves ``hi`` past a
  trailing run of zero couplings;
* AED on the trailing w × w window: its generalized Schur form by one
  launch of the ``complex_qz`` kernel (its plain twin on the CPU), the
  spike test that deflates a trailing run of converged eigenvalues (each
  tested alone: S and T are triangular), the shifts (the generalized
  eigenvalues S_ii/T_ii of the bottom-most ns kept ones, T's diagonal
  guarded), the spike reflector, the window made Hessenberg–triangular
  again (:func:`_window_rehess`) and written back with its stripes;
* unless AED deflated a NIBBLE's worth of the window, one multishift sweep
  (:func:`_sweep`): ns/2 bulges 3 rows apart chased together, two complex
  shifts a bulge (its first column that of (H T⁻¹ − s₁)(H T⁻¹ − s₂) e₁,
  from the top 3 × 2 of H and 2 × 2 of T, the divisions guarded); each
  chase step one batched left 3-row Householder clearing the bulge column
  of H (on H's and T's rows) and one batched right 3 × 3 unitary of three
  composed Givens rotations restoring T's triangularity (on H's, T's and
  Z's columns), the zeros of each written exactly (the cleared bulge
  column's before the right unitaries: the bulge behind would mix its
  rounding residue into the rows below it and blur the shifts), inside a
  W × W window whose accumulated left and right unitaries then reach the
  off-window stripes as GEMMs.

The window's return to Hessenberg–triangular form has two phases, as in
the JAX package (``_window_rehess_qz_pair``): w − 1 right Householder
reflectors make the kept block of T triangular again (an RQ factorization,
so that row 0, which carries the coupling to the rest of the pencil, is
never touched from the left), then the Givens chain that makes the kept
block of S Hessenberg while T stays triangular. That chain never touches
row 0 and the rows and columns past the kept block k are zero in it, so it
is exactly ``hessenberg_triangular``'s chain on (S[:k, :k], T[:k, :k]):
one launch of the ``complex_hess_tri`` kernel on the window with size k (a
device tensor: no host read), whose Q_k and Z_k then reach S[:k, k:],
T[:k, k:] and the window's accumulated Q and Z as GEMMs. The JAX package
runs it as w²/2 masked rotations of whole rows and columns, which
host-issued would be some 10⁵ launches a round.

The driver decides on the host with two ``host_read`` calls a round, as
``schur_multishift._multishift`` does. The sweep's chase steps are
host-issued batched launches. Infinite eigenvalues have no deflation of
their own, as in the JAX package: the guarded divisions of the shifts and
the window's single-shift ``safe()`` carry them. Every product here is
pinned to full FP32 (``schur_multishift.matmul``).
"""
from __future__ import annotations

import math

import torch

from faer_tpu_torch.core import dtypes
from faer_tpu_torch.core.config import host_read
from faer_tpu_torch.core.errors import SpectralInfo
from faer_tpu_torch.linalg.schur_multishift import (
    _house3_batch,
    _params_for,
    _spike_householder,
    matmul,
)


def _rdiv(z, r):
    """The complex ``z`` over the real ``r`` (broadcast), part by part: a
    complex quotient forms 1/r, which overflows for a subnormal r."""
    return torch.view_as_complex(torch.view_as_real(z) / r[..., None])


def _safe_div(num, den, smlnum):
    """num / den with every den of magnitude below ``smlnum`` taken as
    ``smlnum`` (the infinite-eigenvalue guard of the shifts)."""
    return num / torch.where(den.abs() < smlnum, smlnum.to(den.dtype), den)


def _givens_cols(m, p: int, q: int, r: int) -> None:
    """One batched column rotation of ``m`` (nb, rows, 3) zeroing each
    m[:, r, p] against m[:, r, q]: column p ← c·p − s̄·q, column q ←
    c·q + s·p, with c = |a|/ρ, s = (a/|a|)·b̄/ρ for a = m[:, r, q],
    b = m[:, r, p], ρ = ‖(a, b)‖ (``abs`` and ``hypot``: scaled); the
    identity where both are 0. In place."""
    a, b = m[:, r, q], m[:, r, p]
    aa = a.abs()
    rho = torch.hypot(aa, b.abs())
    some = rho > 0
    rho = torch.where(some, rho, 1.0)
    c = torch.where(some, aa / rho, 1.0)[:, None]
    s = _rdiv(torch.where(aa > 0, _rdiv(a, torch.where(aa > 0, aa, 1.0)), 1.0) * b.conj(),
              rho)[:, None]
    cp, cq = m[:, :, p], m[:, :, q]
    new_p = c * cp - s.conj() * cq
    cq.copy_(c * cq + s * cp)
    cp.copy_(new_p)


def _right_restore_t(t3):
    """Batched 3 × 3 unitaries Z (nb, 3, 3) with t3 · Z upper triangular:
    three column rotations (:func:`_givens_cols`), (2, 0) against column 2,
    (2, 1) against column 2, (1, 0) against column 1
    (``qz_multishift_cpair._right_restore_t``)."""
    nb = t3.shape[0]
    # T's rows, then Z's: one column rotation updates both
    m = torch.cat([t3, torch.eye(3, dtype=t3.dtype, device=t3.device).expand(nb, 3, 3)], dim=1)
    for p, q, r in ((0, 2, 2), (1, 2, 2), (0, 1, 1)):
        _givens_cols(m, p, q, r)
    return m[:, 3:]


# ---------------------------------------------------------------------------
# multishift sweep
# ---------------------------------------------------------------------------

def _sweep(hp, tp, qp, zp, lo: int, hi: int, s1b, s2b, smlnum, *, off: int, nb: int,
           step: int) -> None:
    """One multishift sweep chasing ``nb`` bulges through the active block
    [lo, hi] of the padded pencil (``hp``, ``tp``: the matrices at offset
    ``off``), Q's and Z's padded columns ``qp``, ``zp`` alongside; ``s1b``,
    ``s2b`` (nb,) each bulge's two shifts. The batched and windowed
    equivalent of the sequential chase (``_sweep_qz_pair``). In place.

    A chunk works on one buffer D = [[H, Uqᴴ], [T, ·], [Uz, ·]] (3W × 2W,
    the window's H and T and the accumulating unitaries): a left reflector
    is one gather → rank-1 → scatter of H's and T's rows (which carries Uqᴴ
    with H's), a right 3 × 3 unitary one of the first W columns (H's, T's
    and Uz's), as ``index_select`` / ``index_copy_``."""
    dt, dev = hp.dtype, hp.device
    w_sz = step + 3 * nb + 1
    w2 = 2 * w_sz
    bidx = torch.arange(nb, device=dev)
    # local row of bulge b at inner step tt: tt + 1 + 3(nb − 1 − b)
    li_base = 1 + 3 * (nb - 1 - bidx)
    r3 = torch.arange(3, device=dev)
    rows3_base = (li_base[:, None] + r3[None, :]).reshape(-1)  # (3·nb,)
    rows6_base = torch.cat([rows3_base, rows3_base + w_sz])  # H's rows, then T's
    # flat offsets in D of each bulge's 3 × 3 patch of H, rows li..li+2 and
    # columns li−1..li+1, and of T's block, rows and columns li..li+2; step
    # tt moves them down the diagonal by 2W + 1
    patch_base = ((li_base[:, None, None] + r3[None, :, None]) * w2
                  + li_base[:, None, None] - 1 + r3[None, None, :]).reshape(nb, 9)
    vcol_base = patch_base[:, 0::3].contiguous()  # the bulge's column, (li..li+2, li − 1)
    tblk_base = patch_base + 1 + w_sz * w2
    # the entries a step makes zero, written as exact zeros for every bulge
    # (structurally zero for a bulge outside the block too): rows li + 1 and
    # li + 2 of H's cleared bulge column li − 1 right after the left
    # reflectors, before the right unitary of the bulge behind (3 rows up)
    # mixes that column, whose rounding residue it would otherwise spread
    # into the rows below its own bulge and blur the shifts; T's block below
    # its diagonal after the right unitaries. (step, 2·nb) and (step, 3·nb)
    # offsets in D
    steps = (w2 + 1) * torch.arange(step, device=dev)[:, None]
    zh = vcol_base[:, 1:].reshape(1, -1) + steps
    zt = tblk_base[:, [3, 6, 7]].reshape(1, -1) + steps
    eye = torch.eye(w_sz, dtype=dt, device=dev)
    zero = torch.zeros(nb, dtype=dt, device=dev)
    nchunks = math.ceil((hi - lo + 3 * nb) / step)
    tb = torch.arange(nchunks * step, device=dev)[:, None] - 3 * bidx[None, :]
    ib_all = lo + tb
    active_all = (tb >= 0) & (ib_all <= hi - 1)
    intro_all = ib_all == lo
    last_all = ib_all == hi - 1
    eye3 = torch.eye(3, dtype=dt, device=dev).expand(nb, 3, 3)

    def some_bulge_at(t: int, row: int) -> bool:
        """Whether a bulge is at the block's row lo + ``row`` at step t
        (bulge b is at lo + t − 3b): decided on the host, so that the
        masks of the introduction and of the last row run only at the
        steps they change."""
        d = t - row
        return d >= 0 and d % 3 == 0 and d // 3 < nb

    for c in range(nchunks):
        t0 = c * step
        a = off + lo + t0 - 3 * (nb - 1) - 1  # the window's start (padded)
        du = torch.zeros((3 * w_sz, w2), dtype=dt, device=dev)
        du[:w_sz, :w_sz] = hp[a:a + w_sz, a:a + w_sz]
        du[:w_sz, w_sz:] = eye  # Uqᴴ
        du[w_sz:2 * w_sz, :w_sz] = tp[a:a + w_sz, a:a + w_sz]
        du[2 * w_sz:, :w_sz] = eye  # Uz
        dflat = du.view(-1)
        dleft = du[:, :w_sz]
        for tt in range(step):
            t = t0 + tt
            shift = tt * (w2 + 1)
            vs = dflat[vcol_base + shift]  # (nb, 3): the bulge's column
            if some_bulge_at(t, 0):
                # a bulge enters: the intro column (H T⁻¹ − s₁)(H T⁻¹ − s₂) e₁
                # from the top 3 × 2 of H and 2 × 2 of T
                _, h00, h01, _, h10, h11, _, _, h21 = dflat[patch_base + shift].unbind(1)
                t00, t01, _, _, t11 = dflat[tblk_base + shift][:, :5].unbind(1)
                y0 = _safe_div(h00, t00, smlnum) - s2b
                y1 = _safe_div(h10, t00, smlnum)
                w1 = _safe_div(y1, t11, smlnum)
                w0 = _safe_div(y0 - t01 * w1, t00, smlnum)
                vs = torch.where(intro_all[t][:, None], torch.stack(
                    [h00 * w0 + h01 * w1 - s1b * y0, h10 * w0 + h11 * w1 - s1b * y1,
                     h21 * w1], dim=1), vs)
            if some_bulge_at(t, hi - 1 - lo):
                vs = torch.where(last_all[t][:, None] & (r3 == 2), zero[:, None], vs)
            # a reflector is invariant under scaling of its vector
            scale = vs.abs().amax(1, keepdim=True)
            vs = _rdiv(vs, torch.where(scale == 0, 1.0, scale))
            tau, u2, u3 = _house3_batch(*vs.unbind(1))
            act = active_all[t]
            every = t >= 3 * (nb - 1) and t <= hi - 1 - lo  # every bulge in the block
            if not every:
                tau = torch.where(act, tau, zero)
            tau3, u23, u33 = tau[:, None, None], u2[:, None, None], u3[:, None, None]
            # left: rows li..li+2 of H (with Uqᴴ's) and of T, w = uᴴ R
            rows = rows6_base + tt
            rr = du.index_select(0, rows).view(2, nb, 3, w2)
            wv = rr[:, :, 0:1] + u23.conj() * rr[:, :, 1:2] + u33.conj() * rr[:, :, 2:3]
            du.index_copy_(0, rows, (rr - tau3.conj() * torch.cat(
                [wv, u23 * wv, u33 * wv], dim=2)).view(-1, w2))
            dflat.index_fill_(0, zh[tt], 0.0)
            # right: the 3 × 3 unitary restoring T's triangularity (the
            # identity for an inactive bulge) on columns li..li+2 of H, T, Uz
            t3 = dflat[tblk_base + shift].view(nb, 3, 3)
            if not every:
                t3 = torch.where(act[:, None, None], t3, eye3)
            cols = rows[:3 * nb]
            cc = dleft.index_select(1, cols).view(3 * w_sz, nb, 3).transpose(0, 1)
            dleft.index_copy_(1, cols, torch.bmm(cc, _right_restore_t(t3)).transpose(0, 1)
                              .reshape(3 * w_sz, -1))
            dflat.index_fill_(0, zt[tt], 0.0)
        dh, dtt, uz = du[:w_sz, :w_sz], du[w_sz:2 * w_sz, :w_sz], du[2 * w_sz:, :w_sz]
        uq = du[:w_sz, w_sz:].mH
        # the far field: full-stripe GEMMs (column stripe, then row stripe),
        # then the interior from the window
        for m, d in ((hp, dh), (tp, dtt)):
            m[:, a:a + w_sz] = matmul(None, m[:, a:a + w_sz], uz)
            m[a:a + w_sz, :] = matmul(None, uq.mH, m[a:a + w_sz, :])
            m[a:a + w_sz, a:a + w_sz] = d
        qp[:, a:a + w_sz] = matmul(None, qp[:, a:a + w_sz], uq)
        zp[:, a:a + w_sz] = matmul(None, zp[:, a:a + w_sz], uz)


# ---------------------------------------------------------------------------
# aggressive early deflation
# ---------------------------------------------------------------------------

def _window_rq(s, t, zw, k) -> None:
    """The RQ phase of :func:`_window_rehess`: rows k − 1 down to 1 of the
    window's T, each made zero left of its diagonal by a right Householder
    reflector P = I − τ u uᴴ on columns 0..i (the reflector of
    x = conj(T[i, :i + 1]) pivoted at i, so that T[i, :] P = β e_i), applied
    to S's, T's and Zw's columns; rows from k on are left as they are
    (``k`` a 0-d tensor). In place."""
    w = s.shape[0]
    cols = torch.arange(w, device=s.device)
    one = torch.ones((), dtype=s.dtype, device=s.device)
    for i in range(w - 1, 0, -1):
        x = torch.where(cols <= i, t[i].conj(), 0.0)
        sc = x.abs().amax()
        x = x / torch.where(sc == 0, 1.0, sc)
        alpha = x[i]
        tail2 = torch.where(cols < i, dtypes.abs2(x), 0.0).sum()
        nrm = torch.sqrt(dtypes.abs2(alpha) + tail2)
        is_id = ((tail2 == 0) & (alpha.imag == 0)) | (k <= i)
        beta = torch.where(alpha.real >= 0, -nrm, nrm)
        u = torch.where(cols < i, x / torch.where(is_id, one, alpha - beta), 0.0)
        u = u + (cols == i).to(s.dtype)
        u = torch.where(is_id, 0.0 * one, u)
        tau = torch.where(is_id, 0.0 * one, (beta - alpha) / torch.where(is_id, one, beta))
        uc = u.conj()
        for m in (s, t, zw):
            m -= tau * matmul(None, m, u[:, None]) * uc[None, :]


def _window_rehess(s, t, qw, zw, k):
    """Hessenberg–triangular form again on the top-left k × k of the window
    pencil (``s``, ``t``) after the spike reflector, accumulating into
    ``qw`` (left) and ``zw`` (right); ``k`` a 0-d tensor (module
    docstring): the RQ phase, T's strictly lower part written as exact
    zeros, then one ``complex_hess_tri`` launch on the kept block, carried
    to the rest by GEMMs. New tensors."""
    from faer_tpu_torch.ops.kernels.complex_qz import complex_hess_tri_batched

    w = s.shape[0]
    s, t, zw = s.clone(), t.clone(), zw.clone()
    _window_rq(s, t, zw, k)
    t = torch.triu(t)
    eye = torch.eye(w, dtype=s.dtype, device=s.device)
    sizes = k.to(torch.int32).reshape(1)
    hk, rk, qk, zk = (x[0] for x in complex_hess_tri_batched(
        s[None].contiguous(), t[None].contiguous(), eye[None], eye[None], sizes))
    # Q_k = diag(qk[:k, :k], I): its rows reach S's and T's columns from k
    keep = torch.arange(w, device=s.device)[None, :] < k
    s = torch.where(keep, hk, matmul(None, qk.mH, s))
    t = torch.where(keep, rk, matmul(None, qk.mH, t))
    return s, t, matmul(None, qw, qk), matmul(None, zw, zk)


def _aed(hp, tp, qp, zp, hi: int, smlnum, *, off: int, w: int, ns: int, lahqr_sweeps: int):
    """Aggressive early deflation on the window [hi − w + 1, hi] of the
    padded pencil (``hp``, ``tp``; ``qp``, ``zp`` alongside, all in place):
    the window's generalized Schur form by one ``complex_qz`` launch (its
    plain twin on the CPU), the spike test, the shifts, the window made
    Hessenberg–triangular again and written back. Returns ``(nd, s1b,
    s2b)``: the deflation count (a 0-d tensor) and the (ns/2,) shift pairs
    of the following sweep, on the device."""
    from faer_tpu_torch.linalg.complex_qz import qz_iteration

    dt, dev = hp.dtype, hp.device
    eps = dtypes.eps(dt)
    ws = off + hi - w + 1
    beta = hp[ws, ws - 1].clone()
    eye = torch.eye(w, dtype=dt, device=dev)
    s, t, qw, zw, info = qz_iteration(hp[ws:ws + w, ws:ws + w].contiguous(),
                                      tp[ws:ws + w, ws:ws + w].contiguous(), eye, eye,
                                      max_sweeps_factor=lahqr_sweeps)
    sdiag = s.diagonal()
    spike = beta.abs() * qw[0, :].abs()
    ok = (spike <= torch.maximum(smlnum, eps * sdiag.abs())) & info.converged
    nd = torch.cumprod(ok.flip(0).to(torch.int32), 0).sum()
    k = w - nd

    # the shifts: the generalized eigenvalues of the bottom-most ns kept ones
    lam = _safe_div(sdiag, t.diagonal(), smlnum)
    start = torch.clamp(k - ns, min=0).reshape(1)
    se = torch.cat([lam, lam.new_zeros(ns)]).index_select(
        0, start + torch.arange(ns, device=dev))
    s1b, s2b = se[0::2], se[1::2]

    # Hessenberg–triangular form again on the kept part: the coupling column
    # after the window's transformation is Qwᴴ(β e₀) = β·conj(Qw[0, :])
    p1 = _spike_householder(w, beta * qw[0, :].conj(), k)
    s, t = matmul(None, p1.mH, s), matmul(None, p1.mH, t)
    qw = matmul(None, qw, p1)
    s, t, qw, zw = _window_rehess(s, t, qw, zw, k)

    # write back: the stripes, the interior, the spike column
    for m, d in ((hp, s), (tp, t)):
        m[:, ws:ws + w] = matmul(None, m[:, ws:ws + w], zw)
        m[ws:ws + w, :] = matmul(None, qw.mH, m[ws:ws + w, :])
        m[ws:ws + w, ws:ws + w] = d
    hp[ws:ws + w, ws - 1] = 0.0
    hp[ws, ws - 1] = beta * qw[0, 0].conj()
    qp[:, ws:ws + w] = matmul(None, qp[:, ws:ws + w], qw)
    zp[:, ws:ws + w] = matmul(None, zp[:, ws:ws + w], zw)
    return nd, s1b, s2b


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------

def multishift_qz(h, t, q, z, *, ns: int | None = None, w: int | None = None,
                  max_rounds: int | None = None, lahqr_sweeps: int = 30):
    """The generalized Schur form of the complex Hessenberg/triangular
    pencil (``h``, ``t``) by multishift QZ + AED: ``(s, t, q, z, info)``
    with S and T upper triangular and Q S Zᴴ, Q T Zᴴ those of the input
    (A = Q S Zᴴ, B = Q T Zᴴ when ``q``, ``z`` come from
    ``hessenberg_triangular``); ``info.iterations`` counts the rounds.
    faer ``qz_cplx/mod.rs:1140`` (the counterpart of
    ``faer_tpu/linalg/qz_multishift_cpair.py:555`` on native complex
    tensors): each AED window's QZ one ``complex_qz`` launch and its
    Givens phase one ``complex_hess_tri`` launch."""
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
    # the identity on T's padding keeps the padded pencil regular (the
    # guarded divisions of the intro column read padded diagonal entries)
    tp = torch.eye(n + 2 * pad, dtype=dt, device=dev)
    tp[off:off + n, off:off + n] = t
    qp = torch.zeros((n, n + 2 * pad), dtype=dt, device=dev)
    qp[:, off:off + n] = q
    zp = torch.zeros((n, n + 2 * pad), dtype=dt, device=dev)
    zp[:, off:off + n] = z
    tiny = torch.tensor(dtypes.min_positive(dt), dtype=rdt, device=dev)
    smlnum = eps * torch.maximum(h.abs().amax(), tiny)
    idxn = torch.arange(n - 1, device=dev)
    jit_b = 1.0 + 0.02 * torch.arange(nb, dtype=rdt, device=dev)
    hi, rounds, stall = n - 1, 0, 0
    d = hp.diagonal()[off:off + n]
    sd = hp.diagonal(-1)[off:off + n - 1]
    while hi >= 1 and rounds < max_rounds:
        # zero the negligible subdiagonal entries, move hi past a trailing
        # run of zero couplings
        tol = torch.maximum(eps * (d[:-1].abs() + d[1:].abs()), smlnum)
        sd.masked_fill_(sd.abs() <= tol, 0.0)
        run = torch.cumprod((sd[:hi].flip(0) == 0).to(torch.int32), 0).sum()
        hi -= host_read(run)
        if hi >= 1:
            nd, s1b, s2b = _aed(hp, tp, qp, zp, hi, smlnum, off=off, w=w, ns=ns,
                                lahqr_sweeps=lahqr_sweeps)
            hi2 = hi - nd
            cand = torch.where((idxn < hi2) & (sd == 0), idxn + 1, 0)
            lo = cand.amax()
            sweep = (nd * 100 < 14 * w) & (hi2 - lo >= 1)
            nd, lo, sweep = host_read(torch.stack([nd, lo, sweep.to(lo.dtype)]))
            hi2 = hi - nd
            stall = 0 if nd > 0 else stall + 1
            if stall % 6 == 5:  # exceptional shifts on long stalls
                ii = off + hi2
                lam = _safe_div(hp[ii, ii], tp[ii, ii], smlnum)
                s1b = s2b = lam * jit_b
            if sweep:
                _sweep(hp, tp, qp, zp, lo, hi2, s1b, s2b, smlnum, off=off, nb=nb, step=step)
            hi = hi2
        rounds += 1
    s = torch.triu(hp[off:off + n, off:off + n], -1)
    sdo = s.diagonal(-1)
    tol = torch.maximum(eps * (s.diagonal()[:-1].abs() + s.diagonal()[1:].abs()), smlnum)
    sdo.masked_fill_(sdo.abs() <= tol, 0.0)
    return (s, torch.triu(tp[off:off + n, off:off + n]), qp[:, off:off + n].clone(),
            zp[:, off:off + n].clone(),
            SpectralInfo(converged=torch.tensor(hi < 1, device=dev),
                         iterations=torch.tensor(rounds, dtype=torch.int32, device=dev)))
