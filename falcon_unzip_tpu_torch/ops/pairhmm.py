"""Batched banded pair-HMM forward on a torch device.

Port of ``falcon_unzip_tpu.ops.pairhmm`` and of the TPU kernel
``falcon_unzip_tpu.ops.pallas_pairhmm``: the slope-1/2 antidiagonal band
of ``ops.banded_align`` in the log semiring, three state planes (M/I/D),
float32, the numeric spec (logaddexp nesting, masks) of
``oracle.hmm.forward_full``.  ``params_vector`` is a verbatim copy.  Two
implementations of the same recurrence:

* on CUDA tensors, the hand-written kernel of ``csrc/pairhmm.cu``
  (``_kernels.pairhmm_forward``), which takes P at run time;
* on CPU tensors, ``pairhmm_forward_plain``, a Python loop over
  antidiagonals mirroring ``forward_core``.

Shapes: qg/trg guarded as in ``ops.banded_align.prepare_batch``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve
from ..oracle.hmm import NEG, HMMParams
from . import _kernels
from .banded_align import _as_list, build_schedule, prepare_batch


def pairhmm_forward_plain(qg, trg, n, m, lo_arr, pvec, *, W: int, Lt: int,
                          G: int) -> torch.Tensor:
    """Plain torch banded forward (the CPU path; the card's reference).

    qg (P, LQG) / trg (P, LTG) int8 guarded rows; n, m (P,) true lengths;
    lo_arr (Dmax,) band schedule; pvec the ten log-params.  Returns
    loglik (P,) float32, NEG where the (n, m) cell left the band.  The
    antidiagonals after the last corner are never read, so the loop stops
    there.
    """
    dev = qg.device
    P = qg.shape[0]
    lo_l = _as_list(lo_arr)
    Dmax = len(lo_l)
    f32 = torch.float32
    (em_match, em_mis, em_ins, tMM, tMI, tMD, tIM, tII, tDM,
     tDD) = [float(x) for x in pvec]
    neg = float(NEG)
    lae = torch.logaddexp
    n = n.to(dev, torch.int32)
    m = m.to(dev, torch.int32)
    n_col = n[:, None]
    m_col = m[:, None]
    w_iota = torch.arange(W, dtype=torch.int32, device=dev)[None, :]
    # padded planes: Vp[:, 1 + w] = V[w], NEG guard columns at both ends
    ring = [[torch.full((P, W + 2), neg, dtype=f32, device=dev)
             for _ in range(3)] for _ in range(3)]
    final = torch.full((P,), neg, dtype=f32, device=dev)
    hits: dict[int, list[int]] = {}
    for p, s in enumerate(_as_list(n + m)):
        hits.setdefault(s, []).append(p)
    d_end = min(Dmax - 1, max(hits, default=-1))
    for d in range(d_end + 1):
        lo = lo_l[d]
        s1 = lo - (lo_l[d - 1] if d >= 1 else 0)
        s2 = lo - (lo_l[d - 2] if d >= 2 else 0)
        M1, I1, D1 = ring[(d - 1) % 3]
        M2, I2, D2 = ring[(d - 2) % 3]
        cur = ring[d % 3]
        # diag (i-1, j-1) on d-2 at w + s2 - 1; up (i-1, j) on d-1 at
        # w + s1 - 1; left (i, j-1) on d-1 at w + s1
        Md, Id, Dd = (V[:, s2 : s2 + W] for V in (M2, I2, D2))
        Mu, Iu = (V[:, s1 : s1 + W] for V in (M1, I1))
        Ml, Dl = (V[:, 1 + s1 : 1 + s1 + W] for V in (M1, D1))
        qi = qg[:, lo : lo + W]
        t0 = G + Lt - d + lo
        tj = trg[:, t0 : t0 + W]
        em = torch.where((qi == tj) & (qi < 4), em_match, em_mis).to(f32)
        M = em + lae(lae(Md + tMM, Id + tIM), Dd + tDM)
        I = em_ins + lae(Mu + tMI, Iu + tII)
        D = lae(Ml + tMD, Dl + tDD)
        i = lo + w_iota
        j = d - i
        valid = (i <= n_col) & (j >= 0) & (j <= m_col)
        M = torch.where(valid & (i >= 1) & (j >= 1), M, neg)
        M = torch.where((i == 0) & (j == 0), 0.0, M)
        I = torch.where(valid & (i >= 1), I, neg)
        D = torch.where(valid & (j >= 1), D, neg)
        for V, Vp in zip((M, I, D), cur):
            Vp[:, 1 : W + 1] = V
        if d in hits:
            idx = torch.tensor(hits[d], dtype=torch.long, device=dev)
            wnm = (n[idx] - lo).clamp(0, W - 1).long()
            final[idx] = lae(lae(M[idx, wnm], I[idx, wnm]), D[idx, wnm])
    return final


def pairhmm_forward(qg, trg, n, m, lo_arr, pvec, *, W: int, Lt: int,
                    G: int) -> torch.Tensor:
    """Banded pair-HMM forward: the CUDA kernel for CUDA tensors, the plain
    torch version for CPU tensors.  Arguments as in
    ``pairhmm_forward_plain``."""
    if qg.is_cuda:
        return _kernels.pairhmm_forward(qg, trg, n, m, pvec, W=W, Lt=Lt,
                                        G=G, Dmax=len(lo_arr))
    return pairhmm_forward_plain(qg, trg, n, m, lo_arr, pvec, W=W, Lt=Lt,
                                 G=G)


def params_vector(params: HMMParams | None = None) -> np.ndarray:
    L = (params or HMMParams()).logs()
    return np.array([L["em_match"], L["em_mis"], L["em_ins"],
                     L["tMM"], L["tMI"], L["tMD"],
                     L["tIM"], L["tII"], L["tDM"], L["tDD"]],
                    dtype=np.float32)


class PairHMMScorer:
    """Batched (read, template) log-likelihood scorer over padded arrays,
    with the ``(q, t, n, m) -> ll`` interface of the reference's
    ``PairHMMScorer`` and ``PallasPairHMMScorer``.

    device: the torch device of the forward (None: the enclosing
    ``device.scope``)."""

    def __init__(self, W: int = 64, params: HMMParams | None = None,
                 device=None):
        self.W = W
        self.pvec = params_vector(params)
        self.device = resolve(device)

    def __call__(self, q: np.ndarray, t: np.ndarray,
                 n: np.ndarray, m: np.ndarray) -> np.ndarray:
        P, Lq = q.shape
        Lt = t.shape[1]
        qg, trg, G = prepare_batch(q, t, self.W)
        Dmax, lo = build_schedule(Lq, Lt, self.W)
        dev = self.device
        ll = pairhmm_forward(
            torch.from_numpy(qg).to(dev), torch.from_numpy(trg).to(dev),
            torch.from_numpy(np.asarray(n, np.int32)).to(dev),
            torch.from_numpy(np.asarray(m, np.int32)).to(dev), lo,
            self.pvec, W=self.W, Lt=Lt, G=G)
        return ll.cpu().numpy()
