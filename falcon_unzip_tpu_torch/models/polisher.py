"""Arrow-style windowed polishing stage (the 4-polish / quiver role).

Port of ``falcon_unzip_tpu.models.polisher``.  Everything but
``Polisher.__init__`` is a verbatim copy: per window the stage (1)
tallies align-tag votes, (2) refines the low-margin columns by Arrow
mutation testing, and (3) stitches the window consensi at a shared k-mer
in the overlap.  ``Polisher.__init__`` gains ``device`` and builds the
port's ``ops.arrow.ArrowSplicer`` on it; an injected ``scorer`` (for
example ``ops.pairhmm.PairHMMScorer``) selects the full re-forward
refinement path instead.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..ops.arrow import ArrowSplicer
from ..ops.consensus import consensus_with_map, vote_matrix
from ..oracle.hmm import NEG as NEG_LL
from ..oracle.hmm import HMMParams, mutations_of
from ..seq import PAD
from .aligner import AlnSet


def _round128(x: int) -> int:
    # quantized to 512 (not 128): scoring-batch shapes stay constant
    # across refinement rounds/windows, so the Pallas pair-HMM compiles
    # once per polish run instead of per max-segment-length drift
    return max(512, -(-x // 512) * 512)


@dataclasses.dataclass
class PolisherConfig:
    window: int = 384            # window length on the template
    overlap: int = 64            # window overlap for stitching
    splice_k: int = 21           # k-mer for overlap splicing
    min_cov: int = 3             # below this, keep template bases
    del_min_cov: int = 5         # a GAP plurality below this coverage
                                 # keeps the template base instead of
                                 # deleting: read deletions are the
                                 # CORRELATED error mode (homopolymer
                                 # contexts align identically), so two
                                 # of them out-vote one correct read in
                                 # the low-coverage pockets left where
                                 # raw reads split between a primary
                                 # and its haplotig — measured as the
                                 # dominant residual error at 1 Mb.
                                 # Substitution/insertion pluralities
                                 # need two IDENTICAL wrong bases and
                                 # stay trusted at min_cov.
    arrow_rounds: int = 12       # max mutation rounds (0 = vote only);
                                 # windows stop early at convergence
    arrow_candidates: int = 4    # low-margin columns tested per round
                                 # (the device C axis; the full queue is
                                 # cycled through in chunks of this size)
    arrow_min_cov: int = 5       # full-span reads required before mutation
                                 # testing fires (below it, 2-3 correlated
                                 # read errors can outvote the truth —
                                 # GenomicConsensus gates arrow the same way)
    margin_frac: float = 0.7     # vote winner fraction below which to test
    het_skip_frac: float = 0.35  # balanced-biallelic gate: a column whose
                                 # SECOND delta-0 allele carries >= this
                                 # fraction of coverage is a het site
                                 # whose opposite-phase reads survived
                                 # routing, not a consensus error — keep
                                 # the template's (block-consistent)
                                 # allele instead of letting Arrow coin-
                                 # flip it (0 disables)
    het_min_count: int = 3       # absolute floor on the second allele's
                                 # count before a column classifies as
                                 # het-like: at minimum coverage a 3/2
                                 # error split would otherwise pass the
                                 # fraction gate and mask a real error
                                 # from mutation testing
    hmm_band: int = 48
    use_pallas: bool | None = None   # None = auto (TPU + aligned band)
    score_batch: int = 8192          # max (variant, read) pairs per dispatch
                                     # (legacy re-forward path only)
    splice_chunk: int = 512          # (read, template) pairs per splice
                                     # dispatch (ops.arrow)
    splice_len_cap: int = 0          # pinned splice shapes (0 = auto:
                                     # window + 256 rounded up); segments
                                     # or consensi beyond the cap are
                                     # deterministically excluded from
                                     # mutation testing so scores never
                                     # depend on batch composition
    params: HMMParams = dataclasses.field(default_factory=HMMParams)

    def len_cap(self) -> int:
        if self.splice_len_cap:
            return self.splice_len_cap
        return -(-(self.window + 256) // 128) * 128


@dataclasses.dataclass
class _WinState:
    """Mutable per-window refinement state (see Polisher._refine_windows)."""

    cns: np.ndarray                  # current consensus (int8 codes)
    votes: np.ndarray                # (t_win, D, 5) vote tensor
    segs: list
    active: bool
    cand: list = dataclasses.field(default_factory=list)
    #   low-margin candidate QUEUE in CONSENSUS coordinates, shifted as
    #   accepted indel mutations move downstream bases; refinement cycles
    #   through it arrow_candidates at a time, so windows with more error
    #   columns than one chunk still converge (VERDICT.md weak #4)
    cursor: int = 0                  # round-robin position in cand
    stale: int = 0                   # consecutive no-accept rounds
    qv: dict = dataclasses.field(default_factory=dict)
    #   likelihood-margin QV per tested column (cns coords), overwritten
    #   as later rounds retest — rounds-exhausted windows keep their
    #   last-round margins instead of losing them (VERDICT.md weak #4)
    qv_pos: list = dataclasses.field(default_factory=list)
    qv_val: list = dataclasses.field(default_factory=list)
    seg_pvecs: np.ndarray | None = None
    #   optional per-seg (n_segs, 10) log-params for base-quality-aware
    #   scoring (SURVEY.md §2b variantCaller row)
    seg_qtiers: list | None = None
    #   optional per-seg int8 tier-id arrays (one id per segment base)
    #   for PER-BASE quality conditioning — the finer-grained tier that
    #   supersedes seg_pvecs when the reads carry a phred track


@dataclasses.dataclass
class PolishedContig:
    name: str
    seq: np.ndarray
    qv: np.ndarray               # per-base phred-like int8


def window_read_segments(aln: AlnSet, rec_idx: np.ndarray, lo: int, hi: int,
                         full_span_only: bool = False):
    """Extract per-read base segments covering template window [lo, hi).

    Returns list of (local_rec, segment int8 array, covers_full bool).
    """
    out = []
    for local, a in enumerate(rec_idx):
        tags = aln.tags[a]
        if tags is None or len(tags) == 0:
            continue
        sel = (tags[:, 0] >= lo) & (tags[:, 0] < hi) & (tags[:, 2] < 4)
        if not sel.any():
            continue
        seg = tags[sel, 2].astype(np.int8)
        tmin = int(tags[sel, 0].min())
        tmax = int(tags[sel, 0].max())
        covers = (tmin <= lo + 2) and (tmax >= hi - 3)
        if full_span_only and not covers:
            continue
        out.append((local, seg, covers))
    return out


def window_votes(aln: AlnSet, rec_idx: np.ndarray, lo: int, hi: int):
    """Vote tensor for template window [lo, hi) from align tags."""
    tags_list = []
    for a in rec_idx:
        tags = aln.tags[a]
        if tags is None or len(tags) == 0:
            continue
        sel = (tags[:, 0] >= lo) & (tags[:, 0] < hi)
        if sel.any():
            t = tags[sel].copy()
            t[:, 0] -= lo
            tags_list.append(t)
    return vote_matrix(tags_list, hi - lo)


# representative phreds of the per-base quality tiers and the phred
# boundaries between them; row 0 of tier_table is the GLOBAL params
# (reads without a quality track land there)
TIER_PHRED = (4.0, 8.0, 12.0, 18.0, 30.0)
TIER_EDGES = (6.0, 10.0, 15.0, 22.0)
LOWQ_TIER = 2      # tier ids <= this (phred < 10) count as low-quality
#                    for hotspot-suspect column probing (_candidates)


def tier_table(base_params=None) -> np.ndarray:
    """(1 + len(TIER_PHRED), 10) per-tier HMM log-params: row 0 global,
    rows 1.. the base-quality tiers (params_for_read_qv at each
    representative phred) — the ops.arrow per-base tier_params table."""
    from ..oracle.hmm import params_for_read_qv
    from ..ops.pairhmm import params_vector
    rows = [params_vector(base_params)]
    rows += [params_vector(params_for_read_qv(q, base_params))
             for q in TIER_PHRED]
    return np.stack(rows).astype(np.float32)


def phred_to_tiers(qv: np.ndarray) -> np.ndarray:
    """uint8 phred track -> int8 tier ids (1..T; see tier_table)."""
    return (np.searchsorted(np.asarray(TIER_EDGES, np.float32),
                            qv.astype(np.float32), side="right")
            + 1).astype(np.int8)


class Polisher:
    def __init__(self, cfg: PolisherConfig | None = None, scorer=None,
                 vote_ops=None, splicer=None, read_pvecs=None,
                 read_qtiers=None, device=None):
        """scorer: optional pair-HMM scorer with the (q, t, n, m) -> ll
        interface (``ops.pairhmm.PairHMMScorer``); injecting one selects
        the full re-forward refinement path.

        splicer: optional ``ops.arrow.ArrowSplicer``-compatible override.
        Default: an ArrowSplicer on ``device`` (None: the enclosing
        ``device.scope``) with the pinned splice shapes of
        ``PolisherConfig.len_cap``.

        vote_ops: optional window-sharded vote builder (the reference's
        ``parallel.sharding.ShardedWindowVotes`` interface); None builds
        the votes on the host with ``vote_matrix``.

        read_pvecs: optional (n_reads, 10) float32 per-READ HMM
        log-params (``ops.pairhmm.params_vector`` order), attached to
        each window segment by its read id.

        read_qtiers: optional list (indexed by read id) of per-read int8
        TIER-ID tracks in forward read orientation (see
        ``phred_to_tiers``) for per-base quality conditioning.  Takes
        precedence over read_pvecs; the default splicer is then built
        with the matching ``tier_table()``."""
        self.cfg = cfg or PolisherConfig()
        self._vote_ops = vote_ops
        self._read_pvecs = read_pvecs
        self._read_qtiers = read_qtiers
        self._scorer = scorer
        if scorer is not None:
            self._splicer = None
            return
        if splicer is not None:
            self._splicer = splicer
        else:
            cap = self.cfg.len_cap()
            self._splicer = ArrowSplicer(
                max_cand=self.cfg.arrow_candidates,
                params=self.cfg.params, chunk=self.cfg.splice_chunk,
                fixed_lq=cap, fixed_lj=cap,
                tier_params=(tier_table(self.cfg.params)
                             if read_qtiers is not None else None),
                device=device)

    # -- window consensus --------------------------------------------------

    def _vote_consensus(self, votes, template_win):
        cns, cov, cns_of_t = consensus_with_map(
            votes, template_win, min_cov=self.cfg.min_cov,
            del_min_cov=self.cfg.del_min_cov)
        cfg = self.cfg
        if cfg.het_skip_frac > 0 and len(cns):
            # balanced-biallelic columns are residual het mixtures
            # (phase-routing misses), not consensus errors: a plurality
            # vote there is a coin flip between haplotypes, so restore
            # the template's (block-consistent) allele when it is one
            # of the two top alleles
            d0 = votes[:, 0, :]
            tot = d0.sum(axis=1)
            second = np.sort(d0, axis=1)[:, -2]
            hetlike = np.nonzero((tot >= cfg.min_cov)
                                 & (second >= cfg.het_min_count)
                                 & (second >= cfg.het_skip_frac * tot))[0]
            ins_pos: list[int] = []
            ins_base: list[int] = []
            ins_t: list[int] = []
            for t in hetlike:
                tb = int(template_win[t])
                c = int(cns_of_t[t])
                if not (0 <= tb < 4 and d0[t, tb] >= second[t]):
                    continue
                if int(np.argmax(d0[t])) != 4:     # delta-0 winner emitted
                    if 0 <= c < len(cns):
                        cns[c] = tb
                elif 0 <= c <= len(cns):
                    # deletion won the balanced column: nothing was
                    # emitted at delta 0, and cns_of_t[t] is the junction
                    # of the NEXT emitted cell — overwriting cns[c] would
                    # corrupt the adjacent base, so restore the template
                    # allele by insertion at the junction instead
                    ins_pos.append(c)
                    ins_base.append(tb)
                    ins_t.append(int(t))
            if ins_pos:
                # hetlike ascends, so ins_pos (a cumulative count) is
                # already non-decreasing; insert k lands at ins_pos[k]+k
                ins_arr = np.asarray(ins_pos)
                cns = np.insert(cns, ins_arr,
                                np.asarray(ins_base, cns.dtype))
                # shift the coordinate map past the inserted bases so
                # downstream candidate mapping stays exact; each restored
                # column then points at its own inserted base
                cns_of_t = cns_of_t + np.searchsorted(
                    ins_arr, cns_of_t, side="right").astype(
                        cns_of_t.dtype)
                for k, t in enumerate(ins_t):
                    cns_of_t[t] = ins_arr[k] + k
        return cns, cov, cns_of_t

    def _candidates(self, cns: np.ndarray, votes: np.ndarray,
                    cns_of_t: np.ndarray,
                    lowq: np.ndarray | None = None) -> list[int]:
        """Low-margin columns in EXACT consensus coordinates.

        Low-margin template positions (vote winner below margin_frac of
        the coverage) are mapped through the emit-grid coordinate map
        (ops.consensus.consensus_with_map), so indel-shifted windows are
        probed at the right consensus base ([U] Arrow tests mutations on
        its current template, SURVEY.md §3.4)."""
        cfg = self.cfg
        d0 = votes[:, 0, :]
        tot = d0.sum(axis=1)
        win = d0.max(axis=1)
        low = (tot >= cfg.min_cov) & (win < cfg.margin_frac * tot)
        if lowq is not None:
            # tier-aware probing: a column whose coverage is dominated
            # by LOW-QUALITY bases can be confidently WRONG (e.g. a
            # strand-correlated error hotspot where the noisy strand
            # outvotes the clean one), so probe it even at high margin —
            # the per-base-conditioned splice then lets the clean
            # evidence win (measured: fixes hotspot residuals the
            # margin rule never tests)
            ltot = lowq[:, 0, :].sum(axis=1)
            low |= (tot >= cfg.min_cov) & (2 * ltot >= tot)
        if cfg.het_skip_frac > 0:
            # balanced biallelic column = residual het mixture (phase
            # routing miss), not an error; suppress mutation testing so
            # the template's block-consistent allele survives (only
            # above the absolute het_min_count floor — at minimum
            # coverage a 3/2 error split is noise, not a het site)
            second = np.sort(d0, axis=1)[:, -2]
            low &= ~((second >= cfg.het_min_count)
                     & (second >= cfg.het_skip_frac * tot))
        pos = np.nonzero(low)[0]
        order = np.argsort((win / np.maximum(tot, 1))[pos], kind="stable")
        out: list[int] = []
        seen: set[int] = set()
        for p in pos[order]:
            c = min(int(cns_of_t[p]), len(cns) - 1)
            if c >= 0 and c not in seen:
                seen.add(c)
                out.append(c)
        return out

    # -- contig polish -----------------------------------------------------

    def _prep_windows(self, template: np.ndarray, aln: AlnSet,
                      ctg_id: int,
                      seg_exclude: np.ndarray | None = None
                      ) -> list["_WinState"]:
        """Vote consensus + read segments for every window of a contig.

        The contig-wide vote tensor is scatter-added ONCE and sliced per
        window (votes are positionwise, so the slice equals the
        per-window rebuild bit-for-bit); segments slice each record's
        t_pos-sorted tags with searchsorted instead of re-masking every
        tag array for every window.
        """
        cfg = self.cfg
        rec_idx = np.nonzero(aln.ctg == ctg_id)[0]
        t_len = len(template)
        step = cfg.window - cfg.overlap

        if (self._vote_ops is not None
                and self._vote_ops.supports(t_len, cfg.window)):
            # window-sharded device path: each mesh 'window' shard
            # scatter-adds its template segment, the ppermute halo ships
            # boundary columns, and each polish window slices from the
            # block of the shard owning its start (bit-identical votes)
            live = [aln.tags[a] for a in rec_idx
                    if aln.tags[a] is not None and len(aln.tags[a])]
            tg = (np.concatenate(live) if live
                  else np.zeros((0, 3), np.int32))
            blocks, seg = self._vote_ops.blocks(
                tg[:, 0], tg[:, 1], tg[:, 2], t_len=t_len,
                window=cfg.window)

            def vslice(lo, hi):
                s = lo // seg
                off = lo - s * seg
                return blocks[s, off : off + (hi - lo)]
        else:
            votes_full = vote_matrix([aln.tags[a] for a in rec_idx], t_len)

            def vslice(lo, hi):
                return votes_full[lo:hi]

        rec_start = aln.t_start[rec_idx]
        rec_end = aln.t_end[rec_idx]

        # per-base tier mode: map every tag of every record back to a
        # read coordinate (q_start + read-consuming count; deletion tags
        # inherit the preceding read base) and look up its quality tier.
        # tag_tier feeds (a) per-segment tier tracks for the splice
        # kernel and (b) the LOW-QUALITY vote tensor that flags
        # hotspot-suspect columns for probing (_candidates lowq).
        tier_mode = self._read_qtiers is not None
        tag_tier: dict[int, np.ndarray] = {}
        lvslice = None
        if tier_mode:
            low_tags: list[np.ndarray] = []
            for local, a in enumerate(rec_idx):
                tags_a = aln.tags[a]
                if tags_a is None or len(tags_a) == 0:
                    continue
                rid = int(aln.read_id[a])
                tr = (self._read_qtiers[rid]
                      if rid < len(self._read_qtiers) else None)
                if tr is None or not len(tr):
                    continue
                tr = np.asarray(tr, np.int8)
                if aln.strand[a]:
                    tr = tr[::-1]
                cum = np.cumsum(tags_a[:, 2] < 4, dtype=np.int64) - 1
                rpos = int(aln.q_start[a]) + cum
                tt = tr[np.clip(rpos, 0, len(tr) - 1)]
                tag_tier[local] = tt
                sel = tt <= LOWQ_TIER
                if sel.any():
                    low_tags.append(tags_a[sel])
            lowq_full = vote_matrix(low_tags, t_len)

            def lvslice(lo, hi):
                return lowq_full[lo:hi]

        states: list[_WinState] = []
        lo = 0
        while lo < t_len:
            hi = min(t_len, lo + cfg.window)
            votes = vslice(lo, hi)
            cns, _cov, cns_of_t = self._vote_consensus(votes,
                                                       template[lo:hi])
            segs = []
            seg_rids = []
            seg_qtiers = [] if tier_mode else None
            # full-span records only: same predicate window_read_segments
            # applies on non-gap tag extrema (tmin == t_start,
            # tmax == t_end - 1 for records starting/ending on matches)
            cand = np.nonzero((rec_start < hi) & (rec_end > lo))[0]
            for local in cand:
                if (seg_exclude is not None
                        and seg_exclude[rec_idx[local]]):
                    # phase-masked record: votes only (het columns
                    # already stripped), no Arrow segment
                    continue
                tags = aln.tags[rec_idx[local]]
                if tags is None or len(tags) == 0:
                    continue
                i0, i1 = np.searchsorted(tags[:, 0], (lo, hi))
                st = tags[i0:i1]
                m = st[:, 2] < 4
                if not m.any():
                    continue
                inw = st[m]
                if (int(inw[0, 0]) <= lo + 2 and int(inw[-1, 0]) >= hi - 3
                        and len(inw) <= self.cfg.len_cap()):
                    # segments beyond the pinned splice shape are
                    # excluded from scoring (deterministic cap, see
                    # PolisherConfig.splice_len_cap)
                    segs.append(inw[:, 2].astype(np.int8))
                    seg_rids.append(int(aln.read_id[rec_idx[local]]))
                    if tier_mode:
                        tt = tag_tier.get(local)
                        seg_qtiers.append(
                            tt[i0:i1][m] if tt is not None
                            else np.zeros(int(m.sum()), np.int8))
            active = (cfg.arrow_rounds > 0 and len(cns) > 0
                      and len(segs) >= max(cfg.min_cov, cfg.arrow_min_cov))
            cand = (self._candidates(
                cns, votes, cns_of_t,
                lowq=lvslice(lo, hi) if lvslice is not None else None)
                    if active else [])
            seg_pvecs = None
            if self._read_pvecs is not None and segs:
                seg_pvecs = np.asarray(self._read_pvecs)[seg_rids]
            states.append(_WinState(cns=cns, votes=votes, segs=segs,
                                    active=active and bool(cand),
                                    cand=cand, seg_pvecs=seg_pvecs,
                                    seg_qtiers=seg_qtiers))
            if hi >= t_len:
                break
            lo += step
        return states

    def _refine_windows(self, states: list["_WinState"]) -> None:
        """Greedy mutation testing to convergence, batched ACROSS windows.

        Per window this is the oracle's Arrow outer loop
        (oracle.hmm.polish_window_oracle) with the reference's
        alpha/beta-splice scoring (SURVEY.md §3.4, ConsensusCore2):
        each round computes forward+backward ONCE per (read, window
        consensus) and scores every candidate mutation by an O(rows)
        splice (ops.arrow) instead of a full re-forward per
        (variant x read) — the device dispatch is shared across all
        windows of all contigs.  The candidate queue is cycled
        arrow_candidates at a time; a window converges when a full
        cycle accepts nothing.  Accepted indels shift queue and QV
        coordinates; accepted columns (and their neighbors) are
        retested against the NEW template next round.  Every tested
        column keeps its latest likelihood-margin phred QV, including
        in rounds-exhausted windows.
        """
        if self._splicer is None:
            return self._refine_windows_reforward(states)
        cfg = self.cfg
        C = cfg.arrow_candidates
        ln10_over_10 = np.log(10.0) / 10.0
        for _ in range(cfg.arrow_rounds):
            qs: list[np.ndarray] = []
            ts: list[np.ndarray] = []
            cands: list[list[int]] = []
            pair_w: list[int] = []
            pvecs: list[np.ndarray] = []
            any_pvec = False
            qtiers: list = []
            any_qt = False
            win_cols: dict[int, list[int]] = {}
            for k, st in enumerate(states):
                if not st.active:
                    continue
                st.cand = [p for p in st.cand if 0 <= p < len(st.cns)]
                if (not st.cand or not len(st.cns)
                        or len(st.cns) >= self.cfg.len_cap()):
                    st.active = False
                    continue
                nq = len(st.cand)
                start = st.cursor % nq
                cols = [st.cand[(start + ii) % nq]
                        for ii in range(min(C, nq))]
                win_cols[k] = cols
                for si, seg in enumerate(st.segs):
                    qs.append(seg)
                    ts.append(st.cns)
                    cands.append(cols)
                    pair_w.append(k)
                    if st.seg_pvecs is not None:
                        pvecs.append(st.seg_pvecs[si])
                        any_pvec = True
                    else:
                        pvecs.append(None)
                    if st.seg_qtiers is not None:
                        qtiers.append(st.seg_qtiers[si])
                        any_qt = True
                    else:
                        qtiers.append(None)
            if not qs:
                break
            pv = None
            if any_pvec:
                from ..ops.pairhmm import params_vector
                default = params_vector(cfg.params)
                pv = np.stack([p if p is not None else default
                               for p in pvecs])
            if any_qt:
                qt = [q if q is not None
                      else np.zeros(len(qs[i]), np.int8)
                      for i, q in enumerate(qtiers)]
                ll_cur, ll_mut = self._splicer(qs, ts, cands, pvecs=pv,
                                               qtiers=qt)
            else:
                ll_cur, ll_mut = self._splicer(qs, ts, cands, pvecs=pv)
            # pair_w is built in ascending-window order, so each window's
            # pairs are one CONTIGUOUS slice: searchsorted bounds replace
            # the per-window boolean scan (which was O(windows x pairs) —
            # quadratic at 10 Mb scale) with identical float semantics
            # (same values, same order, same pairwise reduction)
            pair_w_a = np.asarray(pair_w)
            for k, cols in win_cols.items():
                st = states[k]
                lo_p, hi_p = np.searchsorted(pair_w_a, (k, k + 1))
                tot_cur = float(ll_cur[lo_p:hi_p].sum())
                tot_mut = ll_mut[lo_p:hi_p].sum(axis=0)    # (C, 9)
                best = None                                # (ll, ci, v)
                for ci, p in enumerate(cols):
                    cur_base = int(st.cns[p])
                    col_best = float(NEG_LL)
                    for v in range(9):
                        if v < 4 and v == cur_base:        # identity sub
                            continue
                        val = float(tot_mut[ci, v])
                        col_best = max(col_best, val)
                        if val > tot_cur + 1e-3 and (
                                best is None or val > best[0]):
                            best = (val, ci, v)
                    margin = tot_cur - col_best
                    st.qv[p] = int(np.clip(margin / ln10_over_10, 2, 60))
                if best is None:
                    st.cursor += len(cols)
                    st.stale += 1
                    if st.stale * C >= len(st.cand):       # full dry cycle
                        st.active = False
                    continue
                _ll, ci, v = best
                p = cols[ci]
                st.stale = 0
                if v < 4:                                  # substitution
                    st.cns = st.cns.copy()
                    st.cns[p] = v
                elif v < 8:                                # insertion
                    st.cns = np.insert(st.cns, p, v - 4)
                    st.cand = [x + 1 if x >= p else x for x in st.cand]
                    st.qv = {(x + 1 if x >= p else x): q
                             for x, q in st.qv.items()}
                else:                                      # deletion
                    st.cns = np.delete(st.cns, p)
                    st.cand = [x - 1 if x > p else x for x in st.cand]
                    st.qv = {(x - 1 if x > p else x): q
                             for x, q in st.qv.items()}
                # an accepted indel re-frames neighboring columns: make
                # sure they are (re)probed against the new template
                for x in (p - 1, p, p + 1):
                    if 0 <= x < len(st.cns) and x not in st.cand:
                        st.cand.append(x)
                seen: set[int] = set()
                st.cand = [x for x in st.cand
                           if not (x in seen or seen.add(x))]
        for st in states:
            if st.qv:
                st.qv_pos = list(st.qv.keys())
                st.qv_val = list(st.qv.values())

    def _refine_windows_reforward(self, states: list["_WinState"]) -> None:
        """Legacy full-re-forward refinement (used only when a raw
        (q, t, n, m) scorer is injected, e.g. oracle-equivalence tests):
        scores the current consensus plus every mutated template with a
        complete banded forward per (variant x read) pair."""
        cfg = self.cfg
        ln10_over_10 = np.log(10.0) / 10.0
        for _ in range(cfg.arrow_rounds):
            qs: list[np.ndarray] = []
            ts: list[np.ndarray] = []
            pair_w: list[int] = []
            pair_v: list[int] = []
            win_variants: dict[int, list] = {}  # k -> [(name, seq), ...]
            for k, st in enumerate(states):
                if not st.active:
                    continue
                st.cand = [p for p in st.cand if 0 <= p < len(st.cns)]
                if not st.cand:
                    st.active = False
                    continue
                variants = [("cur", st.cns)]
                # legacy cost model: only the first chunk of the queue
                for p in st.cand[:cfg.arrow_candidates]:
                    variants.extend(mutations_of(st.cns, p))
                win_variants[k] = variants
                for vi, (_nm, v) in enumerate(variants):
                    for seg in st.segs:
                        qs.append(seg)
                        ts.append(v)
                        pair_w.append(k)
                        pair_v.append(vi)
            if not qs:
                break
            lls = self._score_pairs(qs, ts)
            pair_w_a = np.asarray(pair_w)
            pair_v_a = np.asarray(pair_v)
            for k, variants in win_variants.items():
                st = states[k]
                sel = pair_w_a == k
                tot = np.zeros(len(variants), np.float32)
                np.add.at(tot, pair_v_a[sel], lls[sel])
                best = int(np.argmax(tot))
                if best == 0 or tot[best] <= tot[0] + 1e-3:
                    st.active = False
                    # converged: margin of the kept base vs the best
                    # rejected mutation at each candidate column -> QV
                    vpos = [-1] + [int(nm[3:].split(":")[0])
                                   for nm, _ in variants[1:]]
                    for p in st.cand:
                        alts = [tot[vi] for vi, vp in enumerate(vpos)
                                if vp == p]
                        if not alts:
                            continue
                        margin = float(tot[0] - max(alts))
                        st.qv_pos.append(p)
                        st.qv_val.append(
                            int(np.clip(margin / ln10_over_10, 2, 60)))
                    continue
                name, seq = variants[best]
                st.cns = seq
                p = int(name.split(":")[0][3:])
                if name.startswith("del"):
                    st.cand = [q - 1 if q > p else q for q in st.cand]
                    st.qv_pos = [q - 1 if q > p else q for q in st.qv_pos]
                elif name.startswith("ins"):
                    st.cand = [q + 1 if q >= p else q for q in st.cand]
                    st.qv_pos = [q + 1 if q >= p else q for q in st.qv_pos]
                seen: set[int] = set()
                st.cand = [q for q in st.cand
                           if not (q in seen or seen.add(q))]
        # windows that ran out of rounds while active get no QV override

    def _score_pairs(self, qs: list[np.ndarray],
                     ts: list[np.ndarray]) -> np.ndarray:
        """Batched pair log-likelihoods, chunked to bound device memory."""
        cap = self.cfg.score_batch
        out = np.zeros(len(qs), np.float32)
        Lq = _round128(max(len(q) for q in qs))
        Lt = _round128(max(len(t) for t in ts))
        for lo in range(0, len(qs), cap):
            hi = min(len(qs), lo + cap)
            P = hi - lo
            qa = np.full((P, Lq), PAD, np.int8)
            ta = np.full((P, Lt), PAD, np.int8)
            nn = np.zeros(P, np.int32)
            mm = np.zeros(P, np.int32)
            for i in range(P):
                q, t = qs[lo + i], ts[lo + i]
                qa[i, : len(q)] = q
                ta[i, : len(t)] = t
                nn[i] = len(q)
                mm[i] = len(t)
            out[lo:hi] = self._scorer(qa, ta, nn, mm)
        return out

    def _stitch_contig(self, name: str,
                       states: list["_WinState"]) -> PolishedContig:
        pieces = [st.cns for st in states]
        qvs = []
        for st in states:
            q = _qv_from_votes(st.votes, st.cns, self.cfg.min_cov)
            # likelihood-margin overrides at mutation-tested columns
            for p, v in zip(st.qv_pos, st.qv_val):
                if 0 <= p < len(q):
                    q[p] = v
            qvs.append(q)
        seq, qv = _stitch(pieces, qvs, self.cfg.overlap, self.cfg.splice_k)
        return PolishedContig(name=name, seq=seq, qv=qv)

    def polish_contig(self, name: str, template: np.ndarray, aln: AlnSet,
                      ctg_id: int) -> PolishedContig:
        states = self._prep_windows(template, aln, ctg_id)
        self._refine_windows(states)
        return self._stitch_contig(name, states)

    def polish_all(self, contigs: list[tuple[str, np.ndarray]],
                   aln: AlnSet, ids: list[int] | None = None,
                   seg_exclude: np.ndarray | None = None
                   ) -> list[PolishedContig]:
        """Polish every contig with refinement batched across ALL windows
        of ALL contigs (one scoring batch per round, chunked).

        ids: explicit AlnSet contig ids for each entry (the contig-owner
        dataflow polishes a SUBSET of global contigs; default = position).
        seg_exclude: optional per-record bool — record votes but sits
        out Arrow segment scoring (phase-masked opposite-phase reads)."""
        if ids is None:
            ids = list(range(len(contigs)))
        per_ctg = [self._prep_windows(seq, aln, ci, seg_exclude)
                   for ci, (_nm, seq) in zip(ids, contigs)]
        flat = [st for states in per_ctg for st in states]
        self._refine_windows(flat)
        return [self._stitch_contig(nm, states)
                for (nm, _), states in zip(contigs, per_ctg)]


QV_CAP = 54     # calibrated systematic-error floor (phred): residual
                # consensus errors (splice joins, correlated read errors,
                # het routing misses) are invisible to column vote counts;
                # after the low-coverage deletion/weak-plurality guards
                # the 1 Mb reliability run (scripts/qv_calibrate.py)
                # observes ZERO errors above emitted QV 50 (>= QV 56 at
                # the sample size), so vote evidence alone may claim up
                # to 54 (likelihood-margin overrides may exceed it)


_QV_TABLE = None
_QV_TABLE_N = 60


def _qv_table() -> np.ndarray:
    """Exact consensus-error phred per (coverage n, losing votes w).

    eps = (w + 0.15) / (n + 30.15): per-read column error rate under a
    Beta(0.15, 30) prior (mean ~0.5%; refitted on the 1 Mb reliability
    run AFTER the deletion/weak-plurality guards — consensus got ~8
    phred better and the earlier 1% prior left every bin 7-15 phred
    pessimistic, scripts/qv_calibrate.py).  The consensus is wrong
    when at least half the reads mis-vote: P_err = exact binomial tail
    P[Binom(n, eps) >= ceil(n/2)] — the Chernoff bound used first was
    ~6 phred loose at the n ~ 5-9 coverages phase routing leaves in
    het regions."""
    global _QV_TABLE
    if _QV_TABLE is None:
        N = _QV_TABLE_N
        from math import lgamma
        n_ = np.arange(N + 1, dtype=np.float64)[:, None]
        k_ = np.arange(N + 1, dtype=np.float64)[None, :]
        lg = np.vectorize(lgamma)
        lbin = lg(n_ + 1) - lg(np.maximum(k_, 0) + 1) \
            - lg(np.maximum(n_ - k_, 0) + 1)
        tab = np.zeros((N + 1, N + 1), np.int8)
        for n in range(N + 1):
            for w in range(n + 1):
                eps = (w + 0.15) / (n + 30.15)
                k = np.arange((n + 1) // 2, n + 1, dtype=np.float64)
                if len(k) == 0 or n == 0:
                    tab[n, w] = 2
                    continue
                logp = (lbin[n, k.astype(int)] + k * np.log(eps)
                        + (n - k) * np.log1p(-eps))
                p = float(np.exp(logp).sum())
                tab[n, w] = int(np.clip(
                    -10.0 * np.log10(max(p, 1e-9)), 2, QV_CAP))
        _QV_TABLE = tab
    return _QV_TABLE


QV_TEMPLATE = 40    # columns below min_cov keep the TEMPLATE base,
                    # whose error rate is the unzip consensus quality —
                    # measured 6.9e-5 (QV ~41.6) on the 1 Mb
                    # reliability run, floored conservatively


def _qv_from_votes(votes: np.ndarray, cns: np.ndarray,
                   min_cov: int = 3) -> np.ndarray:
    """Per-base phred quality from a consensus-error model.

    Exact binomial majority-wrong probability per column (see
    _qv_table); columns below min_cov emit the template base and get
    the measured template floor instead of a coin-flip score.  The
    round-3 emitter reported the PER-READ error rate
    (-10 log10(1-frac)) as if it were the consensus error, overstating
    total predicted errors ~800x against simulated truth (VERDICT r3
    weak #4; measured by scripts/qv_calibrate.py).  Capped at QV_CAP;
    coordinate shifts from indels are second-order for QV reporting."""
    d0 = votes[:, 0, :]
    tot = d0.sum(axis=1)
    win = d0.max(axis=1)
    n = np.clip(tot, 0, _QV_TABLE_N)
    w = np.clip(tot - win, 0, _QV_TABLE_N)
    # coverage beyond the table caps at the table edge (already QV_CAP)
    w = np.minimum(w, n)
    q = _qv_table()[n, w]
    q = np.where(tot < min_cov, np.int8(QV_TEMPLATE), q)
    if len(q) >= len(cns):
        return q[: len(cns)]
    return np.pad(q, (0, len(cns) - len(q)), constant_values=20)


def _stitch(pieces, qvs, overlap: int, k: int):
    """Splice adjacent window consensi at a shared k-mer in the overlap."""
    if not pieces:
        return np.zeros(0, np.int8), np.zeros(0, np.int8)
    seq = pieces[0]
    qv = qvs[0]
    for nxt, nqv in zip(pieces[1:], qvs[1:]):
        tail = seq[-(overlap + k):].tobytes()
        spliced = False
        head_len = min(len(nxt), overlap + k)
        head = nxt[:head_len].tobytes()
        for s in range(0, max(1, head_len - k)):
            kmer = head[s : s + k]
            if len(kmer) < k:
                break
            p = tail.find(kmer)
            if p >= 0:
                tail_start = len(seq) - min(len(seq), overlap + k)
                cut_seq = tail_start + p
                seq = np.concatenate([seq[:cut_seq], nxt[s:]])
                qv = np.concatenate([qv[:cut_seq], nqv[s:]])
                spliced = True
                break
        if not spliced:
            seq = np.concatenate([seq, nxt[overlap:]])
            qv = np.concatenate([qv, nqv[overlap:]])
    return seq, qv
