"""Ablation of the pair-HMM antidiagonal step, part by part.

Port of the TPU diagnostic ``scripts/ablate_pallas.py`` (its kernel
``kern``): the step of the banded pair-HMM forward cut to its three parts,
each switched on or off so that each can be timed alone:

* ``shift``: the d-1 and d-2 M planes shifted one cell along the band (NEG
  at w = 0) when the band did not move (s1 = lo(d) - lo(d-1) = 0);
* ``load``: the bases ``qg[row, lo(d) + w]`` and an emission from them;
* ``lse``: the step's three logaddexps; without it, the same step in max.

Every step folds M into ``out = max(out, M)``; the loop runs all Dmax
antidiagonals.  ``out`` starts at NEG = -1e30; the six state planes start
from ``init``.  The TPU kernel starts them at NEG too (``init`` =
``neg_init``), and then ``out`` is NEG everywhere, since NEG + small
rounds back to NEG: that input times the step but checks nothing.  At
``probe_inputs`` (seeded state planes, rows of N with a few bases) the
shift, the window and the logaddexps each change ``out``, so the
kernel's parity with this plain version is checked there too.

Two implementations of the same steps:

* on CUDA tensors, the hand-written kernel of ``csrc/pairhmm_ablate.cu``
  (``_kernels.pairhmm_ablate``);
* on CPU tensors, ``pairhmm_ablate_plain``, a Python loop over
  antidiagonals on (P, W) planes.
"""
from __future__ import annotations

import numpy as np
import torch

from ..oracle.hmm import NEG
from . import _kernels

FEATURE_SETS = _kernels.ABLATE_SETS


def neg_init(P: int, W: int) -> np.ndarray:
    """The TPU kernel's start: every state plane NEG."""
    return np.full((P, W), NEG, np.float32)


def seeded_init(P: int, W: int, seed: int) -> np.ndarray:
    """(P, W) float32 state planes, seeded, uniform in [-8, 0]."""
    return np.random.default_rng(seed).uniform(-8.0, 0.0, (P, W)).astype(
        np.float32)


def probe_inputs(P: int, LQG: int, W: int, seed: int) -> tuple:
    """(qg, init): rows of N (4) with two seeded bases 0..3 each, so that
    em is -0.1 only where a window reaches one of them, and a seeded
    init, so that the shift carries values across columns."""
    rng = np.random.default_rng(seed)
    qg = np.full((P, LQG), 4, np.int32)
    for row in qg:
        row[rng.choice(LQG, size=2, replace=False)] = rng.integers(0, 4, 2)
    return qg, seeded_init(P, W, seed + 1)


def _lae(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.maximum(a, b) + torch.log1p(torch.exp(-(a - b).abs()))


def pairhmm_ablate_plain(qg: torch.Tensor, init: torch.Tensor, feats, *,
                         Dmax: int) -> torch.Tensor:
    """Plain torch ablation step loop (the CPU path; the card's reference).

    qg (P, LQG) int32 base codes; init (P, W) float32, the state planes'
    start; feats a subset of {"shift", "load", "lse"}.  Returns out (P, W)
    float32."""
    feats = frozenset(feats)
    P, W = init.shape
    f32 = dict(dtype=torch.float32, device=qg.device)
    neg_col = torch.full((P, 1), float(NEG), **f32)
    M1 = I1 = D1 = M2 = I2 = D2 = init.to(**f32)
    out = torch.full((P, W), float(NEG), **f32)

    def shift(V):                       # V[w - 1], NEG at w = 0
        return torch.cat([neg_col, V[:, :-1]], dim=1)

    for d in range(Dmax):
        lo = max(0, (d + 1) // 2 - W // 2)
        s1 = lo - max(0, d // 2 - W // 2)
        if "shift" in feats and s1 == 0:
            Md, Mu = shift(M2), shift(M1)
        else:
            Md, Mu = M2, M1
        if "load" in feats:
            em = torch.where(qg[:, lo : lo + W] < 4, -0.1, -3.0).to(**f32)
        else:
            em = -0.1
        if "lse" in feats:
            M = em + _lae(_lae(Md - 0.1, I2 - 3.0), D2 - 3.0)
            I = _lae(Mu - 3.0, I1 - 1.6)
            D = _lae(M1 - 3.0, D1 - 1.6)
        else:
            M = em + torch.maximum(torch.maximum(Md, I2), D2)
            I = torch.maximum(Mu, I1)
            D = torch.maximum(M1, D1)
        out = torch.maximum(out, M)
        M2, I2, D2 = M1, I1, D1
        M1, I1, D1 = M, I, D
    return out


def pairhmm_ablate(qg: torch.Tensor, init: torch.Tensor, feats, *,
                   Dmax: int) -> torch.Tensor:
    """The ablation step loop: the CUDA kernel for a CUDA tensor, the plain
    torch version for a CPU tensor.  Arguments as in
    ``pairhmm_ablate_plain``."""
    if qg.is_cuda:
        return _kernels.pairhmm_ablate(qg, init, feats, Dmax=Dmax)
    return pairhmm_ablate_plain(qg, init, feats, Dmax=Dmax)
