"""SNP-pair association + read phase votes as torch ops.

Port of ``falcon_unzip_tpu.ops.association``.  The banded co-occurrence
table is a loop of shifted elementwise products over the association
span; the per-read block votes are batched float32 matmuls of small
integers against a block one-hot.  Integer arithmetic throughout (the
float32 products are exact: every partial sum is an integer below
2**24), so results match the reference bit for bit.  ``assign_reads`` is
a verbatim host copy.
"""
from __future__ import annotations

import numpy as np
import torch


def association_band_batch(M: torch.Tensor, *, max_span: int):
    """Batched banded association for G contigs.

    M: (G, n_reads, n_sites) int8.  Returns (score, cov) each
    (G, n_sites, max_span) int32 with
    score[g, s, d] = sum_r M[g,r,s] * M[g,r,s+d+1], cov = count of
    both-observed.
    """
    G, n_reads, n_sites = M.shape
    Mi = M.to(torch.int32)
    Mpad = torch.nn.functional.pad(Mi, (0, max_span + 1))
    score = torch.empty((G, n_sites, max_span), dtype=torch.int32,
                        device=M.device)
    cov = torch.empty_like(score)
    for d in range(1, max_span + 1):
        prod = Mi * Mpad[:, :, d : d + n_sites]
        score[:, :, d - 1] = prod.sum(dim=1)
        cov[:, :, d - 1] = prod.abs().sum(dim=1)
    return score, cov


def read_block_votes_batch(M: torch.Tensor, block_onehot: torch.Tensor,
                           sgn: torch.Tensor):
    """Batched per-read block votes: (G, R, S) x (G, S, B) -> (G, R, B).

    float32 matmuls of small integers, exact as long as no TF32 rounding
    enters: on CUDA the TF32 matmul flag must be off.
    """
    if M.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("read_block_votes_batch needs "
                           "torch.backends.cuda.matmul.allow_tf32 = False")
    Mf = M.to(torch.float32)
    oh = block_onehot.to(torch.float32)
    votes = torch.bmm(Mf * sgn.to(torch.float32)[:, None, :], oh)
    covs = torch.bmm(Mf.abs(), oh)
    return votes.to(torch.int32), covs.to(torch.int32)


def assign_reads(votes: np.ndarray, covs: np.ndarray):
    """Pick each read's block/phase (oracle.phase_reads semantics)."""
    votes = np.asarray(votes)
    covs = np.asarray(covs)
    n_reads, n_blocks = votes.shape
    r_block = np.full(n_reads, -1, np.int64)
    r_phase = np.full(n_reads, -1, np.int8)
    if n_blocks == 0:
        return r_block, r_phase
    best_b = np.argmax(covs, axis=1)               # ties -> smaller block id
    best_cov = covs[np.arange(n_reads), best_b]
    v = votes[np.arange(n_reads), best_b]
    ok = (best_cov > 0) & (v != 0)
    r_block[ok] = best_b[ok]
    r_phase[ok] = np.where(v[ok] > 0, 0, 1)
    return r_block, r_phase
