"""Haplotig dedup vs primary (the nucmer/dedup_h_tigs role).

Role parity: [U] falcon_unzip/mains/dedup_h_tigs.py — runs nucmer +
show-coords of h_ctg against its own p_ctg and drops haplotigs above
identity/coverage thresholds (duplicates of the primary; SURVEY.md §2a).
Re-design: the same seed-chain-extend machinery used everywhere else
(SURVEY.md §2b maps MUMmer onto the shared alignment kernel) — a
haplotig is treated as a long query against the primary set.
"""
from __future__ import annotations

import numpy as np

from ..seq import SeqBatch
from .aligner import AlignerConfig, ReadToContigAligner


def dedup_haplotigs(p_batch: SeqBatch, h_batch: SeqBatch,
                    max_identity: float = 0.99,
                    min_span_frac: float = 0.95) -> list[int]:
    """Indices of haplotigs to KEEP (not near-identical to a primary)."""
    if len(h_batch) == 0:
        return []
    contigs = [p_batch.row(i) for i in range(len(p_batch))]
    al = ReadToContigAligner(contigs, AlignerConfig(
        band=512, min_identity=0.0, max_hits_per_read=1))
    # chunk-sampled identity + union interval: a whole-haplotig
    # traceback DP OOMs past ~30kb (models.aligner.align_long_queries)
    from .aligner import align_long_queries
    aln = align_long_queries(al, h_batch)
    ident = aln.identity()
    drop: set[int] = set()
    for a in range(len(aln)):
        rid = int(aln.read_id[a])
        span = int(aln.t_end[a] - aln.t_start[a])
        if (ident[a] >= max_identity
                and span >= min_span_frac * int(h_batch.lengths[rid])):
            drop.add(rid)
    return [i for i in range(len(h_batch)) if i not in drop]
