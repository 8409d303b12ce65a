"""Align-tag votes -> consensus emission on the host.

Port of the numpy half of ``falcon_unzip_tpu.ops.consensus`` (the
reference module imports JAX for its jit twins).  ``_masks``,
``compact_masks``, ``consensus_from_votes``, ``consensus_with_map`` and
``vote_matrix`` are verbatim copies: per (t_pos, delta) column voting with
majority-gated insertion columns, byte-equal to
``oracle.consensus.consensus_from_votes``.  The device twins
(``consensus_masks_device``, ``votes_scatter``) serve only the sharded
polish of ``parallel/`` and are not ported yet.
"""
from __future__ import annotations

import numpy as np

from ..oracle.align import GAP
from ..oracle.consensus import MAX_DELTA


def _masks(xp, votes, template, min_cov: int, del_min_cov: int = 0):
    """Shared numpy/jnp emit-grid computation.

    votes: (t_len, D, 5) int32.  Returns (emit bool, base, cov) each
    (t_len, D) in emission order along axis 1 (delta 0 first).

    del_min_cov: with a template, a GAP plurality below this coverage
    RESTORES the template base instead of deleting (correlated read
    deletions win narrow votes in low-coverage pockets; see
    models.polisher.PolisherConfig.del_min_cov).  0 = off (the oracle
    semantics).
    """
    t_len, D, _ = votes.shape
    d0 = votes[:, 0, :]
    cov = d0.sum(axis=1)
    lowcov = cov < min_cov
    win = xp.argmax(d0, axis=1)                     # ties -> smaller code
    win_cnt = xp.take_along_axis(d0, win[:, None], axis=1)[:, 0]

    has_template = template is not None
    if has_template:
        tmpl = xp.asarray(template).astype(xp.int32)
        tmpl_ok = (tmpl >= 0) & (tmpl < 4)
        del_guard = (win == GAP) & (cov < del_min_cov) & tmpl_ok
        # weak-plurality guard (on whenever del_min_cov is): a winner
        # carried by < 3 reads with ANY dissent is a coin flip between
        # read errors; the template (itself a consensus) is the better
        # prior.  Unanimous low-coverage columns still emit their vote.
        sub_guard = ((del_min_cov > 0) & (win_cnt < 3)
                     & (win_cnt < cov) & tmpl_ok & (win != GAP))
        emit0 = xp.where(lowcov, True, (win != GAP) | del_guard)
        base0 = xp.where(lowcov | del_guard | sub_guard,
                         tmpl, win).astype(xp.int32)
    else:
        emit0 = xp.where(lowcov, False, win != GAP)
        base0 = win.astype(xp.int32)
    cov0 = xp.where(lowcov, 0, win_cnt).astype(xp.int32)

    if D > 1:
        col = votes[:, 1:, :4]
        ins = xp.argmax(col, axis=2).astype(xp.int32)
        cmax = xp.max(col, axis=2)
        sup = ((2 * cmax > cov[:, None]) & (cmax > 0)
               & (~lowcov[:, None]))
        # the oracle breaks at the first unsupported delta: cumulative AND
        emit_ins = xp.cumprod(sup.astype(xp.int8), axis=1).astype(bool)
        emit = xp.concatenate([emit0[:, None], emit_ins], axis=1)
        base = xp.concatenate([base0[:, None], ins], axis=1)
        covs = xp.concatenate([cov0[:, None], cmax.astype(xp.int32)],
                              axis=1)
    else:
        emit, base, covs = emit0[:, None], base0[:, None], cov0[:, None]
    return emit, base, covs


def compact_masks(emit, base, covs):
    """Masked row-major compaction of the emit grid -> (cns, cov)."""
    emit = np.asarray(emit).reshape(-1)
    base = np.asarray(base).reshape(-1)
    covs = np.asarray(covs).reshape(-1)
    return base[emit].astype(np.int8), covs[emit].astype(np.int32)


def consensus_from_votes(votes, template=None, min_cov: int = 1):
    """Fast drop-in for oracle.consensus.consensus_from_votes (byte-equal).

    votes: (t_len, D, 5) int32 vote tensor; template: optional int8 codes
    emitted at low-coverage positions.  Returns (cns int8, cov int32).
    """
    votes = np.asarray(votes)
    if votes.shape[0] == 0:
        return np.zeros(0, np.int8), np.zeros(0, np.int32)
    emit, base, covs = _masks(np, votes, template, min_cov)
    return compact_masks(emit, base, covs)


def consensus_with_map(votes, template=None, min_cov: int = 1,
                       del_min_cov: int = 0):
    """consensus_from_votes + exact template->consensus coordinate map.

    Returns (cns int8, cov int32, cns_of_t int32 (t_len,)) where
    cns_of_t[p] is the consensus index at which template position p's
    delta-0 column landed (== the number of emitted cells strictly before
    cell (p, 0)).  For columns where the deletion vote won (nothing
    emitted at delta 0), cns_of_t[p] is the junction index where an
    insertion would restore the base — exactly the coordinate Arrow
    mutation testing must probe.  This replaces the round-1
    "template coords clipped to cns" approximation
    (VERDICT.md missing #3).
    """
    votes = np.asarray(votes)
    if votes.shape[0] == 0:
        return (np.zeros(0, np.int8), np.zeros(0, np.int32),
                np.zeros(0, np.int32))
    emit, base, covs = _masks(np, votes, template, min_cov, del_min_cov)
    flat = emit.reshape(-1)
    cum = np.cumsum(flat)
    before = (cum.reshape(emit.shape)[:, 0]
              - emit[:, 0].astype(np.int64)).astype(np.int32)
    cns, cov = compact_masks(emit, base, covs)
    return cns, cov, before


def vote_matrix(tags_list, t_len: int, max_delta: int = MAX_DELTA):
    """Fast vote_matrix: one concatenation + one scatter-add.

    Equal to oracle.consensus.vote_matrix (integer adds are order-free).
    """
    votes = np.zeros((t_len, max_delta + 1, 5), dtype=np.int32)
    live = [t for t in tags_list if t is not None and len(t)]
    if not live:
        return votes
    tg = np.concatenate(live)
    ok = (tg[:, 0] >= 0) & (tg[:, 0] < t_len) & (tg[:, 1] <= max_delta)
    tg = tg[ok]
    np.add.at(votes, (tg[:, 0], tg[:, 1], tg[:, 2]), 1)
    return votes
