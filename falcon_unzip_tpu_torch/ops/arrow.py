"""Alpha/beta-spliced Arrow mutation rescoring on a torch device.

Port of ``falcon_unzip_tpu.ops.arrow``.  For P (read, template) pairs it
runs the pair-HMM forward over rows i = 0..Lq and the backward over rows
Lq..0, keeps the forward values at the <= C candidate columns and the
backward values at the <= 3C columns after them, and splices the
log-likelihood of 9 point mutations per candidate (4 substitutions,
4 insertions, 1 deletion) from them.  Params are per pair (P, 10) or per
read base (tier ids into a (T, 10) table).  The numeric spec is
``oracle.hmm.forward_backward_full(_pb)`` / ``splice_scores(_pb)``.

The row sweeps have two implementations:

* on CUDA tensors, the hand-written kernel of ``csrc/arrow_splice.cu``
  (``_kernels.arrow_sweeps``), one block per (pair, direction), a lane a
  row on antidiagonals, the within-row D recurrence a register chain;
* on CPU tensors, ``arrow_sweeps_plain``, the reference's two row scans
  (``fstep`` / ``bstep``) as Python loops with the Hillis-Steele ladder
  for the within-row scan.

The splice assembly after the sweeps (``splice_from_sweeps``, ~40
elementwise and ``logsumexp`` ops per call, not per row) is torch ops on
either device.  ``ArrowSplicer`` keeps the reference's host packing;
``_shapes`` and ``_pick_chunk`` are verbatim copies.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve
from ..oracle.hmm import NEG, HMMParams
from ..seq import PAD
from . import _kernels
from .pairhmm import params_vector

_NEG = float(NEG)


def _round_up(x: int, q: int = 128) -> int:
    return max(q, -(-x // q) * q)


def _shift_right(V, k: int, fill):
    """out[..., j] = V[..., j-k] (k >= 1), left-filled."""
    pad = torch.full(V.shape[:-1] + (k,), fill, dtype=V.dtype,
                     device=V.device)
    return torch.cat([pad, V[..., :-k]], dim=-1)


def _shift_left(V, k: int, fill):
    """out[..., j] = V[..., j+k] (k >= 1), right-filled."""
    pad = torch.full(V.shape[:-1] + (k,), fill, dtype=V.dtype,
                     device=V.device)
    return torch.cat([V[..., k:], pad], dim=-1)


def _scan_lse_right(u, c, LJ: int):
    """x[j] = logaddexp(u[j], x[j-1] + c) by Hillis-Steele doubling."""
    k = 1
    while k < LJ:
        u = torch.logaddexp(u, _shift_right(u, k, _NEG) + k * c)
        k *= 2
    return u


def _scan_lse_left(u, c, LJ: int):
    """x[j] = logaddexp(u[j], x[j+1] + c) by Hillis-Steele doubling."""
    k = 1
    while k < LJ:
        u = torch.logaddexp(u, _shift_left(u, k, _NEG) + k * c)
        k *= 2
    return u


def _lse3(a, b, c):
    return torch.logaddexp(torch.logaddexp(a, b), c)


def _tier_ids(qtier, T: int):
    """(P, R) tier ids -> (qt, qt_m1) int64, clamped like a gather."""
    qt = qtier.long().clamp(0, T - 1)
    return qt, torch.cat([qt[:, :1], qt[:, :-1]], dim=1)


def arrow_sweeps_plain(q, t, n, m, cand, pvec, qtier=None, tiers=None, *,
                       C: int) -> tuple:
    """Plain torch forward + backward row sweeps (the CPU path; the card's
    reference).  Arguments as in ``arrow_splice_plain``.  Returns
    (afM, afI, afD (P, C, R), bM, bD (P, 3, C, R), ll_cur (P,)).  Rows
    past the longest read are NEG in the reference and are filled, not
    computed."""
    dev = q.device
    P, Lq = q.shape
    LJ = t.shape[1]
    R = Lq + 1
    f32 = torch.float32
    neg = _NEG
    lae = torch.logaddexp
    j_iota = torch.arange(LJ, dtype=torch.int32, device=dev)[None, :]
    n_col = n.to(dev, torch.int32)[:, None]
    m_col = m.to(dev, torch.int32)[:, None]
    if qtier is not None:
        tiers = tiers.to(f32)
        qt, qt_m1 = _tier_ids(qtier, tiers.shape[0])

        def _row(src, i):
            pr = tiers[src[:, i]]                     # (P, 10)
            return [pr[:, k : k + 1] for k in range(10)]

        frow = lambda i: _row(qt_m1, i)               # base i-1 (clip 0)
        brow = lambda i: _row(qt, i)                  # base i
    else:
        const = [pvec[:, k : k + 1].to(f32) for k in range(10)]
        frow = brow = lambda i: const

    jmask = j_iota <= m_col
    tg = _shift_right(t, 1, PAD)                      # tg[:, j] = t[j-1]
    padcol = torch.full((P, 1), PAD, dtype=q.dtype, device=dev)
    qg = torch.cat([padcol, q], dim=1)                # qg[:, i] = q[i-1]
    qpad = torch.cat([q, padcol], dim=1)              # qpad[:, i] = q[i]
    idxF = cand.long().clamp(0, LJ - 1)                             # (P, C)
    idxB = torch.stack([(cand.long() + s).clamp(0, LJ - 1)
                        for s in range(3)], dim=1).reshape(P, 3 * C)
    i_last = min(Lq, int(n.max())) if P else -1
    afM, afI, afD = (torch.full((R, P, C), neg, dtype=f32, device=dev)
                     for _ in range(3))
    bM, bD = (torch.full((R, P, 3 * C), neg, dtype=f32, device=dev)
              for _ in range(2))
    NEGrow = torch.full((P, LJ), neg, dtype=f32, device=dev)

    # ---- forward sweep: rows i = 0..Lq (fstep)
    M1 = I1 = D1 = NEGrow
    for i in range(i_last + 1):
        (em_match, em_mis, em_ins, tMM, tMI, tMD, tIM, tII, tDM,
         tDD) = frow(i)
        qc = qg[:, i : i + 1]                                      # q[i-1]
        em = torch.where((qc == tg) & (qc < 4), em_match, em_mis)
        rowv = i <= n_col
        M = em + _lse3(_shift_right(M1, 1, neg) + tMM,
                       _shift_right(I1, 1, neg) + tIM,
                       _shift_right(D1, 1, neg) + tDM)
        M = torch.where((i >= 1) & (j_iota >= 1) & rowv & jmask, M, neg)
        if i == 0:
            M = torch.where(j_iota == 0, 0.0, M)
        I = em_ins + lae(M1 + tMI, I1 + tII)
        I = torch.where((i >= 1) & rowv & jmask, I, neg)
        dmask = (j_iota >= 1) & rowv & jmask
        u = torch.where(dmask, _shift_right(M, 1, neg) + tMD, neg)
        D = torch.where(dmask, _scan_lse_right(u, tDD, LJ), neg)
        afM[i] = M.gather(1, idxF)
        afI[i] = I.gather(1, idxF)
        afD[i] = D.gather(1, idxF)
        M1, I1, D1 = M, I, D

    # ---- backward sweep: rows i = Lq..0 (bstep)
    BM1 = BI1 = NEGrow
    ll_cur = torch.full((P,), neg, dtype=f32, device=dev)
    for i in range(i_last, -1, -1):
        (em_match, em_mis, em_ins, tMM, tMI, _tMD_i, tIM, tII, tDM,
         _tDD_i) = brow(i)
        (_e0, _e1, _e2, _t3, _t4, tMD, _t6, _t7, _t8, tDD) = frow(i)
        qc = qpad[:, i : i + 1]                                    # q[i]
        emB = torch.where((qc == t) & (qc < 4), em_match, em_mis)
        rin = i <= n_col - 1
        go_m = torch.where(rin & (j_iota <= m_col - 1),
                           emB + _shift_left(BM1, 1, neg), neg)
        go_i = torch.where(rin & jmask, em_ins + BI1, neg)
        term = torch.where((i == n_col) & (j_iota == m_col), 0.0, neg)
        w = lae(tDM + go_m, term)
        BD = torch.where(jmask, _scan_lse_left(w, tDD, LJ), neg)
        BM = lae(_lse3(tMM + go_m, tMI + go_i,
                       tMD + _shift_left(BD, 1, neg)), term)
        BM = torch.where(jmask, BM, neg)
        BI = lae(lae(tIM + go_m, tII + go_i), term)
        BI = torch.where(jmask, BI, neg)
        bM[i] = BM.gather(1, idxB)
        bD[i] = BD.gather(1, idxB)
        if i == 0:
            ll_cur = BM[:, 0].clone()
        BM1, BI1 = BM, BI
    # (R, P, C) -> (P, C, R); (R, P, 3C) -> (P, 3, C, R)
    afM, afI, afD = (x.permute(1, 2, 0).contiguous() for x in (afM, afI, afD))
    bM, bD = (x.permute(1, 2, 0).reshape(P, 3, C, R).contiguous()
              for x in (bM, bD))
    return afM, afI, afD, bM, bD, ll_cur


def arrow_sweeps(q, t, n, m, cand, pvec, qtier=None, tiers=None, *,
                 C: int) -> tuple:
    """Row sweeps: the CUDA kernel for CUDA tensors, the plain torch
    version for CPU tensors."""
    if q.is_cuda:
        return _kernels.arrow_sweeps(q, t, n, m, cand, pvec, qtier, tiers,
                                     C=C)
    return arrow_sweeps_plain(q, t, n, m, cand, pvec, qtier, tiers, C=C)


def splice_from_sweeps(q, t, n, m, cand, pvec, qtier, tiers, sweeps, *,
                       C: int) -> tuple:
    """Splice assembly (arrow.py:220-266) from the sweeps' outputs.
    Returns (ll_cur (P,), ll_mut (P, C, 9))."""
    afM, afI, afD, bM, bD, ll_cur = sweeps
    P, Lq = q.shape
    LJ = t.shape[1]
    dev = q.device
    f32 = torch.float32
    lae = torch.logaddexp
    if qtier is not None:
        tiers = tiers.to(f32)
        qt, qt_m1 = _tier_ids(qtier, tiers.shape[0])

        def p3(k):
            # launch row i crosses by consuming q[i] (M step, tier qt) or
            # by a row-i D step (tier qt_m1)
            src = qt_m1 if k in (5, 9) else qt
            return tiers[:, k][src][:, None, :]                # (P, 1, R)
    else:
        pvec = pvec.to(f32)

        def p3(k):
            return pvec[:, k, None, None]

    axM = _lse3(afM + p3(3), afI + p3(6), afD + p3(8))             # (P, C, R)
    axD = lae(afM + p3(5), afD + p3(9))
    bM_next = _shift_left(bM, 1, _NEG)                        # BM[i+1, col]
    em2_match = p3(0)
    em2_mis = p3(1)

    def cross(em, s):
        """Join launches through one base into backward column p+s."""
        contrib = lae(axM + em + bM_next[:, s], axD + bD[:, s])
        return torch.logsumexp(contrib, dim=-1)                    # (P, C)

    padcol = torch.full((P, 1), PAD, dtype=q.dtype, device=dev)
    qrow = torch.cat([q, padcol], dim=1)[:, None, :]               # (P, 1, R)
    lls = []
    for b in range(4):                                             # subs
        lls.append(cross(torch.where(qrow == b, em2_match, em2_mis), 1))
    for b in range(4):                                             # ins
        lls.append(cross(torch.where(qrow == b, em2_match, em2_mis), 0))
    # del: cross straight into base t[p+1] (landing col p+2) ...
    cand = cand.long()
    tp1 = t.long().gather(1, (cand + 1).clamp(0, LJ - 1))[:, :, None]
    em_del = torch.where((qrow == tp1) & (tp1 < 4), em2_match, em2_mis)
    del_gen = cross(em_del, 2)
    # ... unless p == m-1: column p becomes terminal
    n3 = n.long()[:, None, None].expand(P, C, 1)
    at_n = lambda A: A.gather(-1, n3)[..., 0]
    del_last = _lse3(at_n(afM), at_n(afI), at_n(afD))
    lls.append(torch.where(cand == m.long()[:, None] - 1, del_last, del_gen))
    ll_mut = torch.stack(lls, dim=-1)                              # (P, C, 9)
    ll_mut = torch.where((cand >= 0)[:, :, None], ll_mut, _NEG)
    return ll_cur, ll_mut


def arrow_splice_plain(q, t, n, m, cand, pvec, qtier=None, tiers=None, *,
                       C: int) -> tuple:
    """Torch mirror of ``arrow_splice_core`` (forward + backward + splice).

    q (P, Lq) / t (P, LJ) int8 PAD-padded (column j consumes t[j-1]; the
    true template length m <= LJ - 1); n, m (P,) int32; cand (P, C) int32
    candidate template positions (< m; -1 = unused slot); pvec (P, 10)
    float32 per-pair log-params.  Per-base tier mode: qtier (P, Lq + 1)
    tier ids and tiers (T, 10) float32; pvec is then ignored.  Returns
    (ll_cur (P,), ll_mut (P, C, 9)), variant order [sub 0..3, ins 0..3
    before p, del]; unused slots score NEG."""
    sweeps = arrow_sweeps_plain(q, t, n, m, cand, pvec, qtier, tiers, C=C)
    return splice_from_sweeps(q, t, n, m, cand, pvec, qtier, tiers, sweeps,
                              C=C)


def arrow_splice(q, t, n, m, cand, pvec, qtier=None, tiers=None, *,
                 C: int) -> tuple:
    """``arrow_splice_plain`` with the sweeps on the CUDA kernel for CUDA
    tensors."""
    sweeps = arrow_sweeps(q, t, n, m, cand, pvec, qtier, tiers, C=C)
    return splice_from_sweeps(q, t, n, m, cand, pvec, qtier, tiers, sweeps,
                              C=C)


class ArrowSplicer:
    """Batched splice scorer over ragged (read, template, candidates).

    One call scores P pairs x C candidate columns x 9 mutations plus the
    unmutated loglik, one sweep launch per chunk of pairs.  pvecs:
    optional (P, 10) per-pair log-params (ops.pairhmm.params_vector
    order); default = global HMMParams.  device: the torch device of the
    scoring (None: the enclosing ``device.scope``).
    """

    def __init__(self, max_cand: int = 8, params: HMMParams | None = None,
                 chunk: int = 512, fixed_lq: int | None = None,
                 fixed_lj: int | None = None,
                 tier_params: np.ndarray | None = None, device=None):
        """fixed_lq/fixed_lj: pin the padded read/template shapes (see
        the reference's ArrowSplicer); a pair's score then depends on the
        pair alone.  tier_params: (T, 10) per-tier log-params for the
        qtiers argument of __call__."""
        self.C = max_cand
        self.chunk = chunk
        self.pvec1 = params_vector(params)
        self.fixed_lq = fixed_lq
        self.fixed_lj = fixed_lj
        self.tier_params = (np.asarray(tier_params, np.float32)
                            if tier_params is not None else None)
        self.device = resolve(device)

    def _shapes(self, qs, ts):
        max_q = max((len(q) for q in qs), default=1)
        max_t = max((len(t) for t in ts), default=1)
        if self.fixed_lq is not None:
            assert max_q <= self.fixed_lq and max_t < self.fixed_lj, (
                max_q, max_t, self.fixed_lq, self.fixed_lj)
            return self.fixed_lq, self.fixed_lj
        return _round_up(max_q), _round_up(max_t + 1)

    def _pick_chunk(self, N: int) -> int:
        # power-of-two ladder: small batches don't pad to the full
        # chunk, big batches reuse one compiled program per dispatch
        chunk = 8
        while chunk < min(N, self.chunk):
            chunk *= 2
        return min(chunk, self.chunk)

    def _dispatch(self, qa, ta, nn, mm, ca, pv, Lq: int, LJ: int,
                  qt=None):
        dev = self.device
        dt = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
        return arrow_splice(
            dt(qa), dt(ta), dt(nn), dt(mm), dt(ca), dt(pv),
            None if qt is None else dt(qt),
            None if qt is None else dt(self.tier_params), C=self.C)

    def __call__(self, qs, ts, cands, pvecs=None, qtiers=None):
        """qs/ts: lists of int8 arrays; cands: (N, C) int32 (-1 pad) or
        list of lists; pvecs: optional (N, 10); qtiers: optional list of
        per-pair int8/int32 tier-id arrays (len == len(qs[i])) selecting
        rows of the constructor's tier_params table per READ BASE.
        Returns (ll_cur (N,), ll_mut (N, C, 9))."""
        N = len(qs)
        C = self.C
        cand = np.full((N, C), -1, np.int32)
        if isinstance(cands, np.ndarray):
            cand[:, :cands.shape[1]] = cands[:, :C]
        else:
            for i, cc in enumerate(cands):
                cc = list(cc)[:C]
                cand[i, :len(cc)] = cc
        Lq, LJ = self._shapes(qs, ts)
        chunk = self._pick_chunk(N)
        # every chunk is launched before any result is fetched
        use_tiers = qtiers is not None and self.tier_params is not None
        pend = []
        for lo in range(0, N, chunk):
            hi = min(N, lo + chunk)
            P = chunk                        # fixed: one compile per bucket
            qa = np.full((P, Lq), PAD, np.int8)
            ta = np.full((P, LJ), PAD, np.int8)
            nn = np.zeros(P, np.int32)
            mm = np.zeros(P, np.int32)
            ca = np.full((P, C), -1, np.int32)
            pv = np.tile(self.pvec1, (P, 1)).astype(np.float32)
            qt = np.zeros((P, Lq + 1), np.int8) if use_tiers else None
            for i in range(lo, hi):
                q, t = qs[i], ts[i]
                qa[i - lo, :len(q)] = q
                ta[i - lo, :len(t)] = t
                nn[i - lo] = len(q)
                mm[i - lo] = len(t)
                if use_tiers:
                    qt[i - lo, :len(qtiers[i])] = qtiers[i]
            ca[:hi - lo] = cand[lo:hi]
            if pvecs is not None:
                pv[:hi - lo] = pvecs[lo:hi]
            pend.append(self._dispatch(qa, ta, nn, mm, ca, pv, Lq, LJ,
                                       qt=qt))
        cur_all = torch.cat([c for c, _ in pend]).cpu().numpy()
        mut_all = torch.cat([m for _, m in pend]).cpu().numpy()
        return cur_all[:N].copy(), mut_all[:N].copy()
