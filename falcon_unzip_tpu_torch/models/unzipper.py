"""Phase-aware overlap filtering + haplotig extraction ("the unzip").

Role parity:
- [U] falcon_unzip/mains/ovlp_filter_with_phase.py — drop overlaps that
  join opposite phases of the same phase block (SURVEY.md §2a).
- [U] falcon_unzip/mains/phased_ovlp_to_graph.py — phase-carrying string
  graph (graph.string_graph here).
- [U] falcon_unzip/mains/graphs_to_h_tigs_2.py + proto/* — walk the graph,
  classify collapsed vs diverged (bubble) regions, emit primary contigs
  and haplotigs with placements (SURVEY.md §3.3).

Re-design: overlaps and phases are columnar arrays; the filter is a
vectorized mask; the graph walk is host-side (tiny) and emits contig
paths whose sequence stitching is plain array concatenation of extension
slices.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..seq import SeqBatch, revcomp
from ..graph.string_graph import (StringGraph, mirror, node, node_orient,
                                  node_read)
from .overlapper import OverlapSet


# ---------------------------------------------------------------------------
# Phase-aware overlap filter
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class OvlpFilterConfig:
    min_overlap: int = 500
    min_identity: float = 0.70
    fuzz: int = 60
    # standard falcon coverage filters ([U] ovlp_filter_with_phase carries
    # falcon's max_diff/max_cov/min_cov/bestn — SURVEY.md §2a row).  A read
    # whose end coverage violates these loses ALL its overlaps (repeat /
    # chimera suppression); bestn keeps the longest n overlaps per
    # (read, end).  0 disables the corresponding filter.
    max_diff: int = 100          # |left_cov - right_cov| above this -> drop
    max_cov: int = 300           # end coverage above this -> repeat, drop
    min_cov: int = 1             # end coverage below this -> chimera, drop
    bestn: int = 10              # longest-n overlaps kept per (read, end)


def _end_flags(ovl: OverlapSet, fuzz: int):
    """Forward-strand end-coverage flags per overlap for reads a and b.

    b's match-orientation coordinates flip ends when strand == 1.
    Returns (a_left, a_right, b_left, b_right) bool arrays.
    """
    a_left = ovl.a_start < fuzz
    a_right = ovl.a_end > ovl.a_len - fuzz
    bm_left = ovl.b_start < fuzz
    bm_right = ovl.b_end > ovl.b_len - fuzz
    rc = ovl.strand == 1
    b_left = np.where(rc, bm_right, bm_left)
    b_right = np.where(rc, bm_left, bm_right)
    return a_left, a_right, b_left, b_right


def coverage_filter_mask(ovl: OverlapSet,
                         cfg: OvlpFilterConfig | None = None) -> np.ndarray:
    """Quality + coverage-statistics overlap mask (vectorized).

    Role parity: [U] falcon-kit fc_ovlp_filter stages carried into
    ovlp_filter_with_phase — (1) quality (min_overlap / min_identity),
    (2) per-read end-coverage stats gating the READ (max_cov repeat
    filter, min_cov chimera filter, max_diff left/right asymmetry),
    (3) bestn longest overlaps per (read, end), union over both reads.
    """
    cfg = cfg or OvlpFilterConfig()
    n_reads = int(max(ovl.a_id.max(initial=-1),
                      ovl.b_id.max(initial=-1))) + 1
    span = ovl.a_end - ovl.a_start
    keep = (span >= cfg.min_overlap) & (ovl.identity() >= cfg.min_identity)
    if n_reads == 0 or not keep.any():
        return keep

    a_l, a_r, b_l, b_r = _end_flags(ovl, cfg.fuzz)
    left = np.zeros(n_reads, np.int32)
    right = np.zeros(n_reads, np.int32)
    np.add.at(left, ovl.a_id[keep & a_l], 1)
    np.add.at(right, ovl.a_id[keep & a_r], 1)
    np.add.at(left, ovl.b_id[keep & b_l], 1)
    np.add.at(right, ovl.b_id[keep & b_r], 1)

    touched = np.zeros(n_reads, bool)
    touched[ovl.a_id[keep]] = True
    touched[ovl.b_id[keep]] = True
    bad = np.zeros(n_reads, bool)
    if cfg.max_cov > 0:
        bad |= (left > cfg.max_cov) | (right > cfg.max_cov)
    if cfg.max_diff > 0:
        bad |= np.abs(left - right) > cfg.max_diff
    if cfg.min_cov > 0:
        bad |= np.minimum(left, right) < cfg.min_cov
    bad &= touched
    keep &= ~(bad[ovl.a_id] | bad[ovl.b_id])

    if cfg.bestn > 0 and keep.any():
        # rank each (read, end) entry by span desc (ties: smaller overlap
        # index); an overlap survives if ANY of its end entries ranks
        # within bestn for its read
        idx = np.arange(len(ovl))
        ids, sides, oidx = [], [], []
        for rid, flag, side in ((ovl.a_id, a_l, 0), (ovl.a_id, a_r, 1),
                                (ovl.b_id, b_l, 0), (ovl.b_id, b_r, 1)):
            sel = keep & flag
            ids.append(rid[sel])
            sides.append(np.full(int(sel.sum()), side, np.int8))
            oidx.append(idx[sel])
        ids = np.concatenate(ids)
        sides = np.concatenate(sides)
        oidx = np.concatenate(oidx)
        if len(ids):
            order = np.lexsort((oidx, -span[oidx],
                                sides.astype(np.int32),
                                ids.astype(np.int64)))
            g = ids.astype(np.int64)[order] * 2 + sides[order]
            new_grp = np.ones(len(g), bool)
            new_grp[1:] = g[1:] != g[:-1]
            grp_start = np.maximum.accumulate(
                np.where(new_grp, np.arange(len(g)), 0))
            rank = np.arange(len(g)) - grp_start
            ok = np.zeros(len(ovl), bool)
            ok[oidx[order][rank < cfg.bestn]] = True
            keep &= ok
    return keep


def phase_filter_mask(ovl: OverlapSet, read_ctg: np.ndarray,
                      read_block: np.ndarray, read_phase: np.ndarray,
                      cfg: OvlpFilterConfig | None = None) -> np.ndarray:
    """keep[o] mask: quality + coverage filters + phase-consistency.

    read_ctg/read_block/read_phase: per-read arrays (-1 = unphased).
    An overlap is dropped iff both reads are phased in the SAME contig and
    block but with DIFFERENT phases — the core unzip constraint
    ([U] ovlp_filter_with_phase behavior, SURVEY.md §3.1 step 3) — or if
    it fails the standard falcon coverage filters (coverage_filter_mask).
    """
    cfg = cfg or OvlpFilterConfig()
    a, b = ovl.a_id, ovl.b_id
    keep = coverage_filter_mask(ovl, cfg)
    same_block = ((read_ctg[a] >= 0)
                  & (read_ctg[a] == read_ctg[b])
                  & (read_block[a] >= 0)
                  & (read_block[a] == read_block[b]))
    opposite = same_block & (read_phase[a] != read_phase[b]) \
        & (read_phase[a] >= 0) & (read_phase[b] >= 0)
    return keep & ~opposite


# ---------------------------------------------------------------------------
# Unzip: primary contigs + haplotigs from the phased graph
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Haplotig:
    name: str
    seq: np.ndarray
    primary: str
    p_start: int          # placement on the primary contig
    p_end: int
    reads: list[int]
    phase: int            # majority phase of the arm (-1 unknown)


@dataclasses.dataclass
class UnzipResult:
    p_ctg: list[tuple[str, np.ndarray, list[int]]]   # (name, seq, read path)
    h_ctg: list[Haplotig]
    graph: "StringGraph | None" = None   # reduced phased string graph
    p_paths: list[list[int]] | None = None  # node paths aligned with p_ctg
    #   (ctg_paths-role intermediates; node = read*2 + orient)


def _majority(votes: list[int]) -> int:
    if not votes:
        return -1
    return 1 if 2 * sum(votes) > len(votes) else 0


@dataclasses.dataclass
class UnzipConfig:
    fuzz: int = 60
    reduction_fuzz: int = 100
    max_bubble_steps: int = 64
    drop_chimers: bool = True    # graph-level chimer read removal
    convergence_depth: int = 3   # BFS levels past arm ends when joining
    assoc_frac: float = 0.6      # demote a walk to associated haplotig
                                 # when >= this fraction of its phase
                                 # blocks OPPOSE an existing primary's
                                 # claim ([U] graphs_to_h_tigs_2 emits
                                 # such paths as a_ctg-derived h_ctg;
                                 # majority-with-margin — 0.5 would
                                 # demote on a coin flip, 1.0 only on
                                 # total opposition; adversarial tests
                                 # cover both regimes)
    # ---- draft-guided walk (round 5: Mb-draft contiguity) ----------
    # The reference INHERITS primary contiguity from the FALCON draft:
    # [U] graphs_to_h_tigs_2 follows the existing p_ctg tiling path and
    # only extracts haplotigs from bubbles (SURVEY.md §3.3) — it never
    # re-derives the primary from the overlap graph, so a thin-coverage
    # spot cannot fragment a primary.  When read placements on the
    # draft + the draft sequences are available, our walk does the
    # equivalent: dead ends are rescued by jumping to the next placed
    # read (exact k-mer splice when the reads overlap on the draft;
    # draft-sequence fill across genuine coverage gaps), and walks
    # whose draft span is already covered by an accepted primary are
    # demoted to associated haplotigs instead of re-emitting sequence.
    max_join_gap: int = 100_000   # bridge draft gaps up to this (bp)
    demote_covered_frac: float = 0.70  # walk span already covered by
                                       # accepted primaries => demote
    rescue_anchor_k: int = 32     # splice anchor k-mer length


def place_haplotigs(p_ctg, h_ctg: list["Haplotig"], *, band: int = 512,
                    min_identity: float = 0.55, anchor_k: int = 13):
    """Re-align every haplotig onto its OWN primary contig for placement.

    Role parity: [U] graphs_to_h_tigs_2 step 3 — "align h_tig back to
    p_ctg (SAM -> proto.sam2m4 m4 coords) -> placement interval"
    (SURVEY.md §3.3).  Replaces the bubble-walk / read-span placement
    estimate: each haplotig's p_start/p_end is OVERWRITTEN in place with
    its aligned interval, and the alignments are returned as m4 records
    for the placement file.  Haplotigs that fail to align keep their
    walk-time estimate (still emitted, flagged by absence from the m4).

    p_ctg: [(name, seq, reads)]; h_ctg: Haplotig list (mutated in place).
    """
    from ..seq import SeqBatch
    from ..coords import M4Record
    from .aligner import (AlignerConfig, LongAln, ReadToContigAligner,
                          align_long_queries)

    p_idx = {pname: i for i, (pname, _sq, _r) in enumerate(p_ctg)}
    p_seqs = [pseq for _nm, pseq, _r in p_ctg]
    hs = [h for h in h_ctg if len(h.seq) and h.primary in p_idx]
    if not hs:
        return []
    acfg = AlignerConfig(band=band, min_identity=min_identity,
                         anchor_k=anchor_k,
                         # haplotigs are long: one placement per chunk,
                         # generous repeat filter
                         max_hits=256)
    # ONE index over all primaries, one chunk-sampled batch for all
    # haplotigs (per-primary index builds dominated the old wall-clock);
    # target_ctg pins each haplotig to its OWN primary
    al = ReadToContigAligner(p_seqs, acfg)
    batch = SeqBatch.from_strs([h.seq for h in hs])
    own = np.array([p_idx[h.primary] for h in hs], np.int64)
    # chunk-sampled: whole-haplotig traceback DP is O(Dmax*PB*W)
    # device memory and OOMs past ~30kb (see align_long_queries)
    aln = align_long_queries(al, batch, target_ctg=own)
    placed = {int(aln.read_id[a]) for a in range(len(aln))}
    missing = [qi for qi in range(len(hs)) if qi not in placed]
    if missing:
        # chunks that seeded best on a FOREIGN primary (homologous
        # repeat): retry against an index restricted to the own
        # primary.  ONE index + one batch per primary, not per
        # haplotig — Mb primaries make each index build expensive and
        # n50-shape runs hit this path 100+ times (VERDICT r4 weak #3:
        # 361.9 s vs 30.2 s uniform)
        parts: list[LongAln] = [aln]
        by_prim: dict[int, list[int]] = {}
        for qi in missing:
            by_prim.setdefault(int(own[qi]), []).append(qi)
        for pi, qis in sorted(by_prim.items()):
            sub_al = ReadToContigAligner([p_seqs[pi]], acfg)
            sub = align_long_queries(
                sub_al, SeqBatch.from_strs([hs[qi].seq for qi in qis]))
            if len(sub):
                remap = np.asarray(qis, np.int32)
                sub.read_id[:] = remap[sub.read_id]
                sub.ctg[:] = pi
                parts.append(sub)
        aln = LongAln(**{f.name: np.concatenate(
            [getattr(p, f.name) for p in parts])
            for f in dataclasses.fields(LongAln)})
    ident = aln.identity()
    rows = []
    for a in range(len(aln)):
        if ident[a] < min_identity:
            continue
        qi = int(aln.read_id[a])
        h = hs[qi]
        pname = h.primary
        h.p_start = int(aln.t_start[a])
        h.p_end = int(aln.t_end[a])
        rows.append((p_idx[pname], qi, M4Record(
            q_name=h.name, t_name=pname,
            score=-int(aln.span[a] - aln.dist[a]),
            identity=float(100.0 * ident[a]),
            q_strand=0, q_start=0, q_end=int(aln.q_len[a]),
            q_len=int(aln.q_len[a]),
            t_strand=int(aln.strand[a]),
            t_start=int(aln.t_start[a]), t_end=int(aln.t_end[a]),
            t_len=len(p_seqs[p_idx[pname]]))))
    # the pre-r3 per-primary loop emitted records grouped by primary in
    # p_ctg order; keep that (stable) order for the m4 file
    rows.sort(key=lambda r: (r[0], r[1]))
    return [m4 for _p, _q, m4 in rows]


class Unzipper:
    """Graph walk emitting p_ctg/h_ctg (graphs_to_h_tigs_2 role)."""

    def __init__(self, reads: SeqBatch, read_block: np.ndarray,
                 read_phase: np.ndarray, read_ctg: np.ndarray | None = None,
                 placements: tuple[np.ndarray, np.ndarray] | None = None,
                 cfg: UnzipConfig | None = None,
                 placement_ctg: np.ndarray | None = None,
                 placement_strand: np.ndarray | None = None,
                 draft_seqs: list[np.ndarray] | None = None):
        """placements: optional per-read (t_start, t_end) on the draft
        contig (from the read->draft aligner) used for haplotig placement
        coordinates; read_ctg keys phase blocks per draft contig.

        placement_ctg/placement_strand/draft_seqs enable the
        DRAFT-GUIDED walk (UnzipConfig notes): per-read draft contig id
        + mapping strand, and the draft contig sequences themselves for
        gap fill.  Without them the walk is pure graph-driven (de novo
        draft mode)."""
        self.reads = reads
        self.read_block = read_block
        self.read_phase = read_phase
        self.read_ctg = (read_ctg if read_ctg is not None
                         else np.zeros(len(read_block), np.int64))
        self.placements = placements
        self.placement_ctg = placement_ctg
        self.placement_strand = placement_strand
        self.draft_seqs = draft_seqs
        self.cfg = cfg or UnzipConfig()
        self._guided = (placements is not None
                        and placement_ctg is not None
                        and placement_strand is not None
                        and draft_seqs is not None)
        if self._guided:
            ts, te = placements
            # per-contig read lists sorted by draft start, for start
            # picking and O(log n) gap-rescue window lookups
            self._by_ctg: dict[int, np.ndarray] = {}
            placed = np.nonzero((ts >= 0) & (placement_ctg >= 0))[0]
            for c in np.unique(placement_ctg[placed]):
                rs = placed[placement_ctg[placed] == c]
                self._by_ctg[int(c)] = rs[np.argsort(ts[rs], kind="stable")]

    def _block_key(self, r: int):
        b = int(self.read_block[r])
        if b < 0:
            return None
        return (int(self.read_ctg[r]), b)

    def _seq(self, n: int) -> np.ndarray:
        r = self.reads.row(node_read(n))
        return r if node_orient(n) == 0 else revcomp(r)

    def _ext(self, g: StringGraph, u: int, v: int) -> np.ndarray:
        e = g.edges[u][v]
        return self._seq(v)[e.ext_start:]

    def _arm_phase(self, nodes: list[int]) -> int:
        votes = [int(self.read_phase[node_read(n)]) for n in nodes
                 if self.read_phase[node_read(n)] >= 0]
        if not votes:
            return -1
        c1 = sum(votes)
        return 1 if 2 * c1 > len(votes) else 0

    def _walk_simple(self, g: StringGraph, start: int, visited: set[int],
                     max_steps: int) -> list[int]:
        """Follow unique out-edges from start until junction/visited/end."""
        path = [start]
        while len(path) <= max_steps:
            cur = path[-1]
            outs = g.edges.get(cur, {})
            if len(outs) != 1:
                break
            nxt = next(iter(outs))
            if node_read(nxt) in visited:
                break
            path.append(nxt)
        return path

    def unzip(self, ovl: OverlapSet, keep_mask: np.ndarray) -> UnzipResult:
        cfg = self.cfg
        lens = self.reads.lengths
        if cfg.drop_chimers and len(ovl):
            chim = StringGraph.find_chimers(ovl, keep_mask, fuzz=cfg.fuzz)
            if chim.any():
                keep_mask = (keep_mask & ~chim[ovl.a_id]
                             & ~chim[ovl.b_id])
        g = StringGraph.from_overlaps(ovl, lens, fuzz=cfg.fuzz,
                                      keep_mask=keep_mask)
        g.transitive_reduction(fuzz=cfg.reduction_fuzz)
        g.remove_spurs()

        visited: set[int] = set()   # read ids consumed by some contig
        p_out: list[tuple[str, np.ndarray, list[int]]] = []
        h_out: list[Haplotig] = []
        walk_paths: dict[str, list[int]] = {}   # walk name -> node path
        self._primary_done: set[int] = set()    # draft ctgs with a
        #   completed guided primary walk (only that walk gap-rescues)
        self._cursor = {c: 0 for c in getattr(self, "_by_ctg", {})}
        self.n_rescues = 0          # placement jumps (spliced)
        self.n_fills = 0            # of which draft-sequence fills

        while True:
            start = self._pick_start(g, visited)
            if start is None:
                break
            name = f"{len(p_out):06d}F"
            seq_parts = [self._seq(start)]
            path = [start]
            visited.add(node_read(start))
            pos = len(seq_parts[0])
            cur = start
            w_ctg, hi = self._walk_anchor(start)
            rescue_ok = w_ctg >= 0 and w_ctg not in self._primary_done
            if rescue_ok:
                # reference parity: the p_ctg spans the WHOLE draft
                # (it is the tiling path) — keep the draft's head when
                # the leftmost placed read starts inside it
                ts0 = int(self.placements[0][node_read(start)])
                draft = self.draft_seqs[w_ctg]
                if ts0 > 0:
                    cut = self._draft_anchor(seq_parts[0][:400], draft,
                                             ts0, side="start")
                    cut = ts0 if cut is None else cut
                    if cut > 0:
                        seq_parts.insert(
                            0, draft[:cut].astype(np.int8))
                        pos += cut
                        self.n_fills += 1

            while True:
                outs = {v: e for v, e in g.edges.get(cur, {}).items()
                        if node_read(v) not in visited}
                if not outs:
                    resc = (self._gap_rescue(g, visited, w_ctg, hi,
                                             seq_parts)
                            if rescue_ok else None)
                    if resc is None:
                        break
                    nxt, ext = resc
                    self.n_rescues += 1
                    seq_parts.append(ext)
                    pos += len(ext)
                    path.append(nxt)
                    visited.add(node_read(nxt))
                    cur = nxt
                    hi = self._adv_hi(hi, w_ctg, node_read(nxt))
                    continue
                if len(outs) == 1:
                    nxt = next(iter(outs))
                    if rescue_ok and self._discont(node_read(nxt),
                                                  w_ctg, hi):
                        # repeat-copy shortcut edge: prefer a placed
                        # continuation (rescue) over teleporting
                        resc = self._gap_rescue(g, visited, w_ctg, hi,
                                                seq_parts)
                        if resc is not None:
                            nxt, ext = resc
                            self.n_rescues += 1
                            seq_parts.append(ext)
                            pos += len(ext)
                            path.append(nxt)
                            visited.add(node_read(nxt))
                            cur = nxt
                            hi = self._adv_hi(hi, w_ctg, node_read(nxt))
                            continue
                    seq_parts.append(self._ext(g, cur, nxt))
                    pos += len(seq_parts[-1])
                    path.append(nxt)
                    visited.add(node_read(nxt))
                    cur = nxt
                    hi = self._adv_hi(hi, w_ctg, node_read(nxt))
                    continue
                # branch: try to resolve as a bubble
                arms = []
                for v in sorted(outs):
                    arm = self._walk_simple(g, v, visited,
                                            cfg.max_bubble_steps)
                    arms.append(arm)
                conv = self._convergence(g, arms)
                if conv is not None and rescue_ok:
                    disc = [self._discont(node_read(a[0]), w_ctg, hi)
                            for a in arms]
                    if any(disc) and not all(disc):
                        # repeat masquerading as a het bubble: the
                        # "arms" are the two copies of a duplication,
                        # placed at distant draft loci.  Follow a
                        # continuous arm; leave the far copy's reads
                        # unconsumed (they assemble at their own locus)
                        conv = None
                if conv is None:
                    # unresolvable branch: in guided mode prefer the arm
                    # that CONTINUES the draft — a repeat-copy shortcut
                    # edge teleports the walk across the draft and
                    # silently skips everything in between (measured:
                    # 7 kb interior skip on a 60 kb segdup sim); among
                    # continuing arms, longest total extension wins.
                    # Other arms are left for later walks.
                    def _arm_cont(i: int) -> int:
                        return int(self._discont(node_read(arms[i][0]),
                                                 w_ctg, hi))

                    if (rescue_ok
                            and all(_arm_cont(i) for i in
                                    range(len(arms)))):
                        # every arm teleports: dead end on the draft —
                        # rescue to the placed continuation instead
                        resc = self._gap_rescue(g, visited, w_ctg, hi,
                                                seq_parts)
                        if resc is not None:
                            nxt, ext = resc
                            self.n_rescues += 1
                            seq_parts.append(ext)
                            pos += len(ext)
                            path.append(nxt)
                            visited.add(node_read(nxt))
                            cur = nxt
                            hi = self._adv_hi(hi, w_ctg, node_read(nxt))
                            continue
                    best = min(
                        range(len(arms)),
                        key=lambda i: (_arm_cont(i),
                                       -sum(len(self._ext(g, *p)) for p in
                                            zip([cur] + arms[i], arms[i])),
                                       i))
                    nxt = arms[best][0]
                    seq_parts.append(self._ext(g, cur, nxt))
                    pos += len(seq_parts[-1])
                    path.append(nxt)
                    visited.add(node_read(nxt))
                    cur = nxt
                    hi = self._adv_hi(hi, w_ctg, node_read(nxt))
                    continue
                # bubble: arms re-converge at `conv`
                arm_paths = [a[: a.index(conv)] if conv in a else a
                             for a in arms]
                phases = [self._arm_phase(a) for a in arm_paths]
                # primary arm: majority phase 0 preferred, then longer arm
                order = sorted(
                    range(len(arm_paths)),
                    key=lambda i: (0 if phases[i] == 0 else
                                   (1 if phases[i] == -1 else 2),
                                   -len(arm_paths[i])))
                prim = order[0]
                bubble_start = pos
                # lay primary arm
                pcur = cur
                for nn in arm_paths[prim]:
                    seq_parts.append(self._ext(g, pcur, nn))
                    pos += len(seq_parts[-1])
                    path.append(nn)
                    visited.add(node_read(nn))
                    hi = self._adv_hi(hi, w_ctg, node_read(nn))
                    pcur = nn
                # alternative arms -> haplotigs
                for ai in order[1:]:
                    apath = arm_paths[ai]
                    if not apath:
                        continue
                    parts = []
                    acur = cur
                    for nn in apath:
                        parts.append(self._ext(g, acur, nn))
                        visited.add(node_read(nn))
                        acur = nn
                    hseq = (np.concatenate(parts) if parts
                            else np.zeros(0, np.int8))
                    h_out.append(Haplotig(
                        name=f"{name}_{len(h_out)+1:03d}",
                        seq=hseq, primary=name,
                        p_start=bubble_start, p_end=pos,
                        reads=[node_read(nn) for nn in apath],
                        phase=phases[ai]))
                # continue from the convergence node.  conv may sit
                # several edges past the primary arm's end
                # (_convergence BFS looks convergence_depth levels out,
                # e.g. nested bubbles in repeats) — walk the actual
                # edge path to it instead of assuming a direct edge
                # (round-5 fix: KeyError crash on repeat-rich graphs)
                if node_read(conv) in visited:
                    break
                hop = self._path_to(g, pcur, conv,
                                    cfg.convergence_depth + 2)
                if hop is None or any(node_read(nn) in visited
                                      for nn in hop[:-1]):
                    break
                for nn in hop:
                    seq_parts.append(self._ext(g, pcur, nn))
                    pos += len(seq_parts[-1])
                    path.append(nn)
                    visited.add(node_read(nn))
                    hi = self._adv_hi(hi, w_ctg, node_read(nn))
                    pcur = nn
                cur = conv

            if rescue_ok:
                self._primary_done.add(w_ctg)
                # ... and the draft's tail past the last covered read
                # (nothing left to rescue on this draft, or the walk
                # broke on a visited node — the reference's p_ctg keeps
                # the remaining tiling path either way)
                draft = self.draft_seqs[w_ctg]
                if 0 <= hi < len(draft):
                    cut = self._draft_anchor(
                        self._walk_tail(seq_parts, 400), draft, hi,
                        side="end")
                    cut = hi if cut is None else cut
                    if cut < len(draft):
                        seq_parts.append(draft[cut:].astype(np.int8))
                        pos += len(draft) - cut
                        self.n_fills += 1
            p_out.append((name, np.concatenate(seq_parts),
                          [node_read(n) for n in path]))
            walk_paths[name] = path

        result = self._classify(p_out, h_out, walk_paths)
        result.graph = g
        return result

    def _classify(self, contigs, bubble_h,
                  walk_paths: dict[str, list[int]] | None = None
                  ) -> UnzipResult:
        """Demote walks that re-assemble the opposite phase of an existing
        primary's blocks into haplotigs (the 'associated contig' rule:
        [U] graphs_to_h_tigs_2 emits such paths as h_ctg, and
        [U] dedup_h_tigs drops duplicates — here the phase-block claim map
        makes the duplication explicit without a re-alignment pass)."""
        order = sorted(range(len(contigs)), key=lambda i: -len(contigs[i][1]))
        claimed: dict[tuple[int, int], tuple[int, int]] = {}  # key->(phase,pi)
        primaries: list[tuple[str, np.ndarray, list[int]]] = []
        p_paths: list[list[int]] = []
        extra_h: list[Haplotig] = []
        name_of: dict[int, str] = {}
        # draft-span accounting (round 5): accepted primaries' placement
        # intervals per draft contig; a later walk whose span is already
        # >= demote_covered_frac covered duplicates assembled sequence
        # (VERDICT r4 weak #2: 10.77 Mb of primaries from a 10 Mb
        # genome) and is demoted even when its phase votes are empty
        # (homozygous-region duplicate walks carry no votes)
        cov: dict[int, list[tuple[int, int, int]]] = {}  # c->[(lo,hi,i)]

        def _span(rds):
            if not self._guided:
                return None
            ts, te = self.placements
            placed = [r for r in rds if ts[r] >= 0]
            if not placed:
                return None
            cs = [int(self.placement_ctg[r]) for r in placed]
            c = max(set(cs), key=cs.count)
            on_c = [r for r in placed if int(self.placement_ctg[r]) == c]
            return (c, min(int(ts[r]) for r in on_c),
                    max(int(te[r]) for r in on_c))

        for i in order:
            _, seq, rds = contigs[i]
            votes: dict[tuple[int, int], list[int]] = {}
            for r in rds:
                key = self._block_key(r)
                p = int(self.read_phase[r])
                if key is not None and p >= 0:
                    votes.setdefault(key, []).append(p)
            bp = {k: (1 if 2 * sum(v) > len(v) else 0)
                  for k, v in votes.items()}
            opp = [k for k, p in bp.items()
                   if k in claimed and claimed[k][0] != p]
            opp_based = bp and len(opp) >= self.cfg.assoc_frac * len(bp)
            span = _span(rds)
            dup_owner = None
            if span is not None and not opp_based:
                c, lo, hi = span
                segs = sorted((max(lo, a), min(hi, b), pi)
                              for a, b, pi in cov.get(c, ())
                              if min(hi, b) > max(lo, a))
                covered, last, best_ov = 0, lo, 0
                for a, b, pi in segs:
                    covered += max(0, b - max(a, last))
                    last = max(last, b)
                    if b - a > best_ov:
                        best_ov, dup_owner = b - a, pi
                if (hi <= lo or covered < self.cfg.demote_covered_frac
                        * (hi - lo)):
                    dup_owner = None
            if opp_based or dup_owner is not None:
                if opp_based:
                    # owner = the primary claiming the MOST opposed
                    # blocks (ties -> the longer primary, processed
                    # earlier): deterministic, evidence-weighted
                    cnt: dict[int, int] = {}
                    for k in opp:
                        cnt[claimed[k][1]] = cnt.get(claimed[k][1], 0) + 1
                    owner = min(cnt, key=lambda pi: (-cnt[pi], pi))
                else:
                    owner = dup_owner
                pname = name_of[owner]
                p_start, p_end = self._read_span(rds)
                extra_h.append(Haplotig(
                    name="", seq=seq, primary=pname,
                    p_start=p_start, p_end=p_end, reads=rds,
                    phase=_majority([p for ps in votes.values()
                                     for p in ps])))
            else:
                pname = f"{len(primaries):06d}F"
                name_of[i] = pname
                primaries.append((pname, seq, rds))
                p_paths.append(walk_paths.get(contigs[i][0], [])
                               if walk_paths else [])
                for k, p in bp.items():
                    claimed.setdefault(k, (p, i))
                if span is not None:
                    c, lo, hi = span
                    cov.setdefault(c, []).append((lo, hi, i))

        # bubble haplotigs keep their walk-time placement; renumber all
        # haplotigs per primary in emission order
        renamed: list[Haplotig] = []
        counters: dict[str, int] = {}
        old_to_new = {contigs[i][0]: nm for i, nm in name_of.items()}
        for h in bubble_h:
            pname = old_to_new.get(h.primary)
            if pname is None:
                continue  # parent walk was demoted; its bubbles are covered
            counters[pname] = counters.get(pname, 0) + 1
            renamed.append(dataclasses.replace(
                h, name=f"{pname}_{counters[pname]:03d}", primary=pname))
        for h in extra_h:
            counters[h.primary] = counters.get(h.primary, 0) + 1
            renamed.append(dataclasses.replace(
                h, name=f"{h.primary}_{counters[h.primary]:03d}"))
        return UnzipResult(p_ctg=primaries, h_ctg=renamed,
                           p_paths=p_paths)

    def _read_span(self, rds: list[int]) -> tuple[int, int]:
        if self.placements is None:
            return 0, 0
        t_start, t_end = self.placements
        ss = [int(t_start[r]) for r in rds if t_start[r] >= 0]
        ee = [int(t_end[r]) for r in rds if t_end[r] >= 0]
        if not ss:
            return 0, 0
        return min(ss), max(ee)

    def _path_to(self, g: StringGraph, src: int, dst: int,
                 depth: int) -> list[int] | None:
        """Deterministic BFS edge path src -> dst (exclusive of src,
        inclusive of dst), at most `depth` hops; None if unreachable."""
        if dst in g.edges.get(src, {}):
            return [dst]
        parent = {src: None}
        frontier = [src]
        for _ in range(depth):
            nxt = []
            for u in frontier:
                for v in sorted(g.edges.get(u, {})):
                    if v not in parent:
                        parent[v] = u
                        if v == dst:
                            out = [v]
                            while parent[out[-1]] != src:
                                out.append(parent[out[-1]])
                            return out[::-1]
                        nxt.append(v)
            frontier = nxt
        return None

    def _convergence(self, g: StringGraph, arms: list[list[int]]):
        """First node shared by all arms, else None.

        Each arm's reachable set is extended a bounded BFS
        (cfg.convergence_depth levels) past the arm end, so bubbles whose
        arms stop short of the join — nested bubbles, arms truncated at a
        junction — still converge (round-1 looked only 1 step past the
        end; VERDICT.md weak #5).  Deterministic: the returned node is
        the earliest common node along arm 0's walk order, then its BFS
        levels in sorted node order.
        """
        depth = self.cfg.convergence_depth
        sets: list[set[int]] = []
        orders: list[list[int]] = []
        for a in arms:
            s = set(a)
            order = list(a)
            frontier = [a[-1]]
            for _ in range(depth):
                nxt = []
                for u in frontier:
                    for v in sorted(g.edges.get(u, {})):
                        if v not in s:
                            s.add(v)
                            nxt.append(v)
                            order.append(v)
                frontier = nxt
            sets.append(s)
            orders.append(order)
        common = set.intersection(*sets) if sets else set()
        if not common:
            return None
        for n in orders[0]:
            if n in common:
                return n
        return None

    # ---- draft-guided walk helpers (round 5, see UnzipConfig) --------

    def _walk_anchor(self, start: int) -> tuple[int, int]:
        """(draft ctg, rightmost consumed draft coord) for a new walk."""
        self._w_blkph: tuple | None = None   # tip (block, phase) state
        if not self._guided:
            return -1, -1
        r = node_read(start)
        self._adv_hi(-1, 0, r)               # seed the phase state
        ts, te = self.placements
        if ts[r] < 0:
            return -1, -1
        return int(self.placement_ctg[r]), int(te[r])

    def _discont(self, r: int, w_ctg: int, hi: int) -> bool:
        """True when read r's placement TELEPORTS the guided walk.

        A string-graph edge between two copies of a segmental
        duplication is locally valid (the copies overlap at ~97%
        identity) but jumps the walk to a distant draft locus,
        silently skipping everything in between (measured: repeat
        regions missing from the 60 kb segdup sim's primary).  The
        reference cannot teleport — its primary IS the draft tiling
        path — so the guided walk refuses placed edges that land far
        from the current draft cursor; unplaced reads (bubble
        interiors, junk) stay neutral."""
        if not self._guided or w_ctg < 0:
            return False
        ts, te = self.placements
        if ts[r] < 0:
            return False
        if int(self.placement_ctg[r]) != w_ctg:
            return True
        # only FAR jumps count: reads inside a duplication multi-map
        # between copies, so their single placement can legitimately
        # sit a few kb off — flagging those would refuse correct edges
        far = max(20_000, 2 * self.cfg.max_join_gap)
        return (int(ts[r]) > hi + far
                or int(te[r]) < hi - far)

    def _adv_hi(self, hi: int, w_ctg: int, r: int) -> int:
        """Advance the walk's rightmost draft coordinate past read r,
        tracking the tip's (phase block, phase) for rescue routing."""
        if not self._guided or w_ctg < 0:
            return hi
        key = self._block_key(r)
        ph = int(self.read_phase[r])
        if key is not None and ph >= 0:
            self._w_blkph = (key, ph)
        ts, te = self.placements
        if ts[r] >= 0 and int(self.placement_ctg[r]) == w_ctg:
            return max(hi, int(te[r]))
        return hi

    def _gap_rescue(self, g: StringGraph, visited: set[int], w_ctg: int,
                    hi: int, seq_parts: list[np.ndarray]):
        """Continue a dead-ended primary walk via draft placements.

        The reference never fragments here because [U]
        graphs_to_h_tigs_2 follows the existing p_ctg tiling path
        (SURVEY.md §3.3); the graph-driven equivalent is: jump to the
        next unvisited read placed on this draft contig (within
        max_join_gap of the walk tip) and splice — exact unique-anchor
        splice when the reads overlap on the draft, draft-sequence fill
        across a genuine coverage gap.  Returns (node, extension) or
        None when no placed read continues the contig.
        """
        if not self._guided or w_ctg < 0 or hi < 0:
            return None
        ts, te = self.placements
        rs = self._by_ctg.get(w_ctg)
        if rs is None:
            return None
        hi_i = int(np.searchsorted(ts[rs], hi + self.cfg.max_join_gap,
                                   side="right"))
        best, best_key = None, None
        tip = self._w_blkph
        for r in rs[:hi_i]:
            r = int(r)
            if r in visited or g.contained[r] or int(te[r]) <= hi:
                continue
            # phase routing: stay on the walk tip's haplotype WITHIN a
            # phase block (same block + same phase first, opposite
            # phase of the SAME block last — a mid-block switch would
            # fabricate a haplotype mosaic the reference never emits);
            # across blocks / unphased reads are neutral
            bk = self._block_key(r)
            ph = int(self.read_phase[r])
            if tip is not None and bk == tip[0] and ph >= 0:
                pref = 0 if ph == tip[1] else 2
            else:
                pref = 1
            key = (pref, int(ts[r]), -int(te[r]), r)
            if best_key is None or key < best_key:
                best_key, best = key, r
        if best is None:
            # dead zone longer than max_join_gap: the reference keeps
            # the draft's own sequence through it (the p_ctg IS the
            # tiling path, SURVEY.md §3.3) — jump to the NEXT placed
            # read at ANY distance; the fill path bridges the gap with
            # draft sequence
            for r in rs[hi_i:]:
                r = int(r)
                if (r in visited or g.contained[r]
                        or int(te[r]) <= hi):
                    continue
                best = r
                break
        if best is None:
            return None
        n = node(best, int(self.placement_strand[best]))
        return n, self._splice_ext(seq_parts, best, hi)

    def _walk_tail(self, seq_parts: list[np.ndarray], want: int):
        parts, got = [], 0
        for p in reversed(seq_parts):
            parts.append(p)
            got += len(p)
            if got >= want:
                break
        tail = np.concatenate(parts[::-1]) if parts else np.zeros(0, np.int8)
        return tail[-want:] if len(tail) > want else tail

    def _splice_ext(self, seq_parts: list[np.ndarray], r: int,
                    hi: int) -> np.ndarray:
        """Extension sequence continuing the walk into rescue read r."""
        ts, te = self.placements
        n = node(r, int(self.placement_strand[r]))
        R = self._seq(n)
        t_s = int(ts[r])
        if t_s >= hi:
            # genuine coverage gap: fill from the draft (the reference
            # keeps the draft's own sequence through unphaseable or
            # uncovered stretches rather than breaking the contig).
            # Both fill junctions are anchored exactly where possible:
            # placement coordinates carry a few bases of alignment
            # fuzz, and an unanchored cut loses/duplicates that many
            # bases at every fill.
            self.n_fills += 1
            draft = self.draft_seqs[int(self.placement_ctg[r])]
            tail = self._walk_tail(seq_parts, 400)
            lo_cut = self._draft_anchor(tail, draft,
                                        hi, side="end") or hi
            hd_cut = self._draft_anchor(R[:400], draft,
                                        t_s, side="start")
            if hd_cut is not None:
                fill = draft[lo_cut:hd_cut]
                return np.concatenate([fill.astype(R.dtype), R])
            fill = draft[lo_cut:t_s]
            return np.concatenate([fill.astype(R.dtype), R])
        # reads overlap on the draft: exact splice at a shared anchor
        # k-mer near the walk tip (preads are near-error-free; anchors
        # stepping back dodge het sites in the tip window).  Round-5
        # fix (qv_attrib on E2E_r05_n50: 458 of 472 residual errors were
        # runs of MISSING bases at walk junctions): a globally-unique
        # anchor can still be the WRONG occurrence inside a repeat, and
        # junctions cluster exactly there — so the anchor is now chosen
        # POSITION-CONSISTENTLY (nearest occurrence to the placement
        # expectation, all occurrences considered) and must be CONFIRMED
        # by a second, disjoint anchor mapping with the same offset
        # before the cut is trusted.
        k = self.cfg.rescue_anchor_k
        tail = self._walk_tail(seq_parts, 2 * (hi - t_s) + 2000)
        tb, Rb = tail.tobytes(), R.tobytes()

        def occurrences(pat: bytes) -> list[int]:
            out, j = [], Rb.find(pat)
            while j >= 0 and len(out) < 32:
                out.append(j)
                j = Rb.find(pat, j + 1)
            return out

        if len(tb) >= 2 * k:
            # expected cut in R of the walk-tip END, from placements:
            # tip maps to draft hi, R starts at draft t_s
            j_exp = hi - t_s
            for back in range(0, min(len(tb) - 2 * k, 1024) + 1, 16):
                a = tb[len(tb) - k - back: len(tb) - back or None]
                occ = occurrences(a)
                if not occ:
                    continue
                # cut implied by each occurrence; prefer nearest to the
                # placement expectation
                cuts = sorted(occ, key=lambda j: abs(j + k + back - j_exp))
                j = cuts[0]
                # confirm with a disjoint anchor k further back: it must
                # land exactly k earlier (same offset delta)
                a2 = tb[len(tb) - 2 * k - back: len(tb) - k - back]
                occ2 = occurrences(a2)
                if (j - k) in occ2:
                    return R[min(len(R), j + k + back):]
        # no confirmed anchor (opposite-haplotype junction, repeat, het
        # cluster): banded-align the walk tip onto R's head to find the
        # junction — and pin the cut at the END of the LAST EXACT match
        # run of the traceback (a free-end edit path can place the
        # final bases a few positions off inside repeats; an exact
        # >=16-run is positionally unambiguous).  Draft-coordinate cut
        # only if even that fails.
        q = tail[-400:]
        cap = min(len(R), (hi - t_s) + 600)
        if len(q) >= 64 and cap >= 64:
            from ..oracle.align import banded_dp, traceback_banded
            dist, end, bp, lo_arr = banded_dp(q, R[:cap], W=128,
                                              mode="tglocal")
            if dist <= 0.25 * len(q):
                moves = traceback_banded(bp, lo_arr, end)
                from ..ops.banded_align import (MOVE_DIAG, MOVE_LEFT,
                                                MOVE_UP)
                mv = np.asarray(moves)
                ct = (mv == MOVE_DIAG) | (mv == MOVE_LEFT)
                cq = (mv == MOVE_DIAG) | (mv == MOVE_UP)
                jj = int(end[1]) - int(ct.sum()) + np.cumsum(ct)  # R pos
                ii = len(q) - int(cq.sum()) + np.cumsum(cq)       # q pos
                eq = ((mv == MOVE_DIAG)
                      & (q[np.clip(ii - 1, 0, len(q) - 1)]
                         == R[np.clip(jj - 1, 0, cap - 1)]))
                # last index where an exact 16-run ends
                run, cut = 0, -1
                for x in range(len(mv)):
                    run = run + 1 if eq[x] else 0
                    if run >= 16:
                        cut = x
                if cut >= 0:
                    # continue from R after that run, replaying the
                    # walk-tip bases past the run (they are walk
                    # sequence, already emitted)
                    q_after = len(q) - int(ii[cut])
                    r_after = int(jj[cut]) + q_after
                    return R[min(len(R), r_after):]
                return R[int(end[1]):]
        return R[min(len(R), max(0, hi - t_s)):]

    def _draft_anchor(self, seg: np.ndarray, draft: np.ndarray,
                      guess: int, side: str, k: int = 32,
                      win: int = 600) -> int | None:
        """Anchor a junction on the draft near coordinate `guess`.

        side="end":   seg is a walk TAIL — returns the draft coordinate
                      just PAST seg's last base (fill starts there).
        side="start": seg is a continuation HEAD — returns the draft
                      coordinate of seg's first base (fill ends there).
        Anchors step back/forward past het mismatches; the nearest
        in-window occurrence to `guess` wins.  None when no anchor fits.
        """
        sb = seg.tobytes()
        lo = max(0, guess - win)
        db = draft[lo : guess + win].tobytes()
        if len(sb) < k or len(db) < k:
            return None
        for back in range(0, min(len(sb) - k, 160) + 1, 16):
            if side == "end":
                a = sb[len(sb) - k - back : len(sb) - back or None]
            else:
                a = sb[back : back + k]
            best = None
            j = db.find(a)
            while j >= 0:
                cand = (lo + j + k + back if side == "end"
                        else lo + j - back)
                if best is None or abs(cand - guess) < abs(best - guess):
                    best = cand
                j = db.find(a, j + 1)
            if best is not None:
                return max(0, min(len(draft), best))
        return None

    def _pick_start(self, g: StringGraph, visited: set[int]):
        """Deterministic start node for the next walk.

        Draft-guided mode: the leftmost unvisited placed read per draft
        contig, oriented to walk rightward on the draft (its placement
        strand) — the first walk per contig tiles it end to end with
        gap rescue; later (leftover, opposite-haplotype) walks need an
        out-edge.  Unplaced reads, and the de novo mode, use the graph
        heuristic: unvisited source node with the longest read.
        """
        if self._guided:
            for c in sorted(self._by_ctg):
                rs = self._by_ctg[c]
                i = self._cursor[c]
                while i < len(rs) and (int(rs[i]) in visited
                                       or g.contained[rs[i]]):
                    i += 1               # permanently consumed: skip
                self._cursor[c] = i
                for j in range(i, len(rs)):
                    r = int(rs[j])
                    if r in visited or g.contained[r]:
                        continue
                    u = node(r, int(self.placement_strand[r]))
                    if c not in self._primary_done:
                        return u
                    if g.edges.get(u):
                        return u
                    if g.edges.get(mirror(u)):
                        return mirror(u)
        best = None
        best_key = None
        for u in g.active_nodes():
            r = node_read(u)
            if r in visited or g.contained[r]:
                continue
            if not g.edges.get(u):
                continue
            indeg = sum(1 for p in g.in_nodes.get(u, ())
                        if node_read(p) not in visited)
            key = (0 if indeg == 0 else 1, -int(self.reads.lengths[r]), u)
            if best_key is None or key < best_key:
                best_key = key
                best = u
        return best
