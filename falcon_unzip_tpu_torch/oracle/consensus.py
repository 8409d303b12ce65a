"""Numpy oracle for falcon_sense-style tag-vote consensus.

Role parity: [U] falcon-kit falcon.c::get_cns_from_align_tags /
generate_consensus — per template column, alignment tags (t_pos, delta,
base) from every supporting read are tallied and the winning symbol per
(t_pos, delta) column is emitted; insertion columns (delta >= 1) are kept
only while they are supported by a strict majority of the reads covering
that template position.

This is the executable spec for ``falcon_unzip_tpu.ops.consensus``.
"""
from __future__ import annotations

import numpy as np

from .align import GAP, align

MAX_DELTA = 8  # insertion columns tracked per template position


def vote_matrix(tags_list, t_len: int, max_delta: int = MAX_DELTA) -> np.ndarray:
    """Stack per-read tags into a vote tensor (t_len, max_delta+1, 5).

    tags_list: iterable of (n_tags, 3) int arrays (t_pos, delta, base).
    Channel 4 is the deletion (GAP) vote; it only occurs at delta == 0.
    """
    votes = np.zeros((t_len, max_delta + 1, 5), dtype=np.int32)
    for tags in tags_list:
        if tags is None or len(tags) == 0:
            continue
        ok = (
            (tags[:, 0] >= 0) & (tags[:, 0] < t_len)
            & (tags[:, 1] <= max_delta)
        )
        tg = tags[ok]
        np.add.at(votes, (tg[:, 0], tg[:, 1], tg[:, 2]), 1)
    return votes


def consensus_from_votes(
    votes: np.ndarray,
    template: np.ndarray | None = None,
    min_cov: int = 1,
) -> tuple[np.ndarray, np.ndarray]:
    """Vote tensor -> (consensus int8 codes, per-emitted-base coverage).

    Per template position p:
      coverage  = total delta-0 votes at p
      if coverage < min_cov: emit template base (if given) with cov 0
      else: delta-0 winner (argmax over A,C,G,T,GAP; ties -> smaller code);
            emit unless GAP wins; then for delta = 1.. emit the winning
            inserted base while 2 * winner_count > coverage.
    """
    t_len, n_delta, _ = votes.shape
    out: list[int] = []
    cov_out: list[int] = []
    for p in range(t_len):
        cov = int(votes[p, 0].sum())
        if cov < min_cov:
            if template is not None:
                out.append(int(template[p]))
                cov_out.append(0)
            continue
        win = int(np.argmax(votes[p, 0]))
        if win != GAP:
            out.append(win)
            cov_out.append(int(votes[p, 0, win]))
        for dlt in range(1, n_delta):
            col = votes[p, dlt, :4]
            ins = int(np.argmax(col))
            if 2 * int(col[ins]) > cov and col[ins] > 0:
                out.append(ins)
                cov_out.append(int(col[ins]))
            else:
                break
    return np.array(out, dtype=np.int8), np.array(cov_out, dtype=np.int32)


def falcon_sense(
    template: np.ndarray,
    reads: list[np.ndarray],
    W: int = 256,
    min_cov: int = 1,
    keep_template_low_cov: bool = True,
) -> np.ndarray:
    """End-to-end oracle consensus: align each read to template, vote, emit."""
    tags_list = []
    for r in reads:
        res = align(r, template, W=W, mode="global")
        if res is not None:
            tags_list.append(res["tags"])
    votes = vote_matrix(tags_list, len(template))
    cns, _ = consensus_from_votes(
        votes, template if keep_template_low_cov else None, min_cov=min_cov)
    return cns
