"""Alignment coordinate toolkit (the reference proto/ coordinate-math role).

Role parity: [U] falcon_unzip/proto/cigartools.py (CIGAR walking,
ref/query span math), [U] falcon_unzip/proto/sam2m4.py (SAM alignment →
m4 placement records for haplotig placement), and the coordinate
accumulation of [U] falcon_unzip/proto/tiling_path.py (SURVEY.md §2a
"Haplotig extraction v2" row, §3.3 step 3).  These are the pieces the
upstream repo unit-tests (SURVEY.md §4).

Re-design: everything is expressed against the framework's two native
alignment encodings —

  * CIGAR words ``(length, op_index)`` with ops "MIDNSHP=X" (the BAM/
    io.bamlite convention), used at the ingest/emit edges, and
  * **align-tags** ``(t_pos, delta, base)`` int32 rows (the falcon_sense
    convention produced by ops.banded_align.moves_to_tags_vec), used by
    the on-device pileup/consensus path.

The converters are exact inverses, so BAM alignments from any external
mapper can feed the device pileup (``bam_to_alnset``) and device
alignments can be exported as valid BAM records (``tags_to_cigar``).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .oracle.align import GAP
from .ops.banded_align import (MOVE_DIAG, MOVE_LEFT, MOVE_UP,
                               moves_to_tags_vec)

CIGAR_OPS = "MIDNSHP=X"
_OP_IDX = {c: i for i, c in enumerate(CIGAR_OPS)}
# per-op (consumes_query, consumes_target) in BAM semantics
_CONSUMES = np.array([[1, 1],   # M
                      [1, 0],   # I
                      [0, 1],   # D
                      [0, 1],   # N
                      [1, 0],   # S
                      [0, 0],   # H
                      [0, 0],   # P
                      [1, 1],   # =
                      [1, 1]],  # X
                     dtype=np.int64)


# ---------------------------------------------------------------------------
# CIGAR primitives (cigartools role)
# ---------------------------------------------------------------------------

def parse_cigar(s: str) -> list[tuple[int, int]]:
    """'12M3I4D' -> [(12, 0), (3, 1), (4, 2)]."""
    if s in ("", "*"):
        return []
    out, n = [], 0
    for ch in s:
        if ch.isdigit():
            n = n * 10 + ord(ch) - 48
        else:
            out.append((n, _OP_IDX[ch]))
            n = 0
    if n:
        raise ValueError(f"trailing length in CIGAR {s!r}")
    return out


def format_cigar(cigar: list[tuple[int, int]]) -> str:
    return "".join(f"{ln}{CIGAR_OPS[op]}" for ln, op in cigar) or "*"


def cigar_spans(cigar: list[tuple[int, int]]) -> tuple[int, int]:
    """(query bases consumed, target bases consumed) incl. soft clips."""
    q = t = 0
    for ln, op in cigar:
        cq, ct = _CONSUMES[op]
        q += ln * cq
        t += ln * ct
    return q, t


def clip_lengths(cigar: list[tuple[int, int]]) -> tuple[int, int]:
    """(leading, trailing) soft+hard clip lengths."""
    lead = tail = 0
    for ln, op in cigar:
        if op in (4, 5):
            lead += ln
        else:
            break
    for ln, op in reversed(cigar):
        if op in (4, 5):
            tail += ln
        else:
            break
    return lead, tail


def ref_to_query(cigar: list[tuple[int, int]], t_start: int
                 ) -> tuple[np.ndarray, np.ndarray]:
    """Per aligned target position: (t_positions, q_offsets).

    q_offsets index into the FULL query (soft clips included); deleted
    target positions map to the q offset of the next consumed base
    (the standard left-anchored liftover used for placement math).
    """
    t_positions, q_offsets = [], []
    q = t = 0
    for ln, op in cigar:
        cq, ct = _CONSUMES[op]
        if ct and cq:          # M/=/X
            t_positions.extend(range(t_start + t, t_start + t + ln))
            q_offsets.extend(range(q, q + ln))
        elif ct:               # D/N
            t_positions.extend(range(t_start + t, t_start + t + ln))
            q_offsets.extend([q] * ln)
        q += ln * cq
        t += ln * ct
    return (np.asarray(t_positions, dtype=np.int64),
            np.asarray(q_offsets, dtype=np.int64))


# ---------------------------------------------------------------------------
# CIGAR <-> align-tags (the device pileup encoding)
# ---------------------------------------------------------------------------

def cigar_to_moves(cigar: list[tuple[int, int]]) -> np.ndarray:
    """Expand aligned ops to the DP move alphabet (clips dropped)."""
    chunks = []
    for ln, op in cigar:
        if op in (0, 7, 8):
            chunks.append(np.full(ln, MOVE_DIAG, np.int8))
        elif op == 1:
            chunks.append(np.full(ln, MOVE_UP, np.int8))
        elif op in (2, 3):
            chunks.append(np.full(ln, MOVE_LEFT, np.int8))
        # S/H/P consume no aligned cell
    if not chunks:
        return np.zeros(0, np.int8)
    return np.concatenate(chunks)


def cigar_to_tags(cigar: list[tuple[int, int]], seq: np.ndarray,
                  t_start: int) -> np.ndarray:
    """BAM record -> (n, 3) align-tags in contig coordinates.

    ``seq`` is the full record sequence (int8 codes); leading soft clip
    is skipped so tag bases line up with aligned query bases.  Exact
    inverse of tags_to_cigar for records without N/P ops.
    """
    lead, _ = clip_lengths(cigar)
    moves = cigar_to_moves(cigar)
    q_aligned = np.asarray(seq, dtype=np.int8)[lead:]
    return moves_to_tags_vec(q_aligned, moves, t_offset=t_start)


def tags_to_cigar(tags: np.ndarray) -> tuple[list[tuple[int, int]], int]:
    """(n, 3) align-tags -> (CIGAR words, t_start).

    Tag rows are per DP move: delta>0 -> I, base==GAP -> D, else M.
    Returns match/ins/del runs only (add clips at the BAM writer).
    """
    tags = np.asarray(tags)
    if len(tags) == 0:
        return [], 0
    is_ins = tags[:, 1] > 0
    is_del = (~is_ins) & (tags[:, 2] == GAP)
    ops = np.where(is_ins, 1, np.where(is_del, 2, 0)).astype(np.int64)
    # collapse runs
    brk = np.flatnonzero(np.diff(ops)) + 1
    starts = np.concatenate([[0], brk])
    ends = np.concatenate([brk, [len(ops)]])
    cigar = [(int(e - s), int(ops[s])) for s, e in zip(starts, ends)]
    return cigar, int(tags[0, 0])


def tags_query(tags: np.ndarray) -> np.ndarray:
    """Recover the aligned query bases from align-tags."""
    tags = np.asarray(tags)
    if len(tags) == 0:
        return np.zeros(0, np.int8)
    keep = (tags[:, 1] > 0) | (tags[:, 2] != GAP)
    return tags[keep, 2].astype(np.int8)


# ---------------------------------------------------------------------------
# m4 placement records (sam2m4 role)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class M4Record:
    """One m4 alignment line (blasr -m 4 / sam2m4 convention)."""

    q_name: str
    t_name: str
    score: int
    identity: float      # percent
    q_strand: int        # always 0
    q_start: int
    q_end: int
    q_len: int
    t_strand: int        # 0/1; t coords in FORWARD target orientation
    t_start: int
    t_end: int
    t_len: int

    def line(self) -> str:
        return (f"{self.q_name} {self.t_name} {self.score} "
                f"{self.identity:.2f} {self.q_strand} {self.q_start} "
                f"{self.q_end} {self.q_len} {self.t_strand} {self.t_start} "
                f"{self.t_end} {self.t_len}")


def aln_to_m4(aln, read_names: list[str], ctg_names: list[str],
              ctg_lens: list[int]) -> list[M4Record]:
    """Columnar AlnSet -> m4 records (models.aligner.AlnSet layout)."""
    out = []
    ident = aln.identity()
    for a in range(len(aln)):
        c = int(aln.ctg[a])
        q_span = int(np.sum((aln.tags[a][:, 1] > 0) |
                            (aln.tags[a][:, 2] != GAP))) if aln.tags else \
            int(aln.q_len[a])
        out.append(M4Record(
            q_name=read_names[int(aln.read_id[a])], t_name=ctg_names[c],
            score=-int(q_span - aln.dist[a]),
            identity=float(100.0 * ident[a]),
            q_strand=0, q_start=0, q_end=q_span,
            q_len=int(aln.q_len[a]),
            t_strand=int(aln.strand[a]), t_start=int(aln.t_start[a]),
            t_end=int(aln.t_end[a]), t_len=int(ctg_lens[c])))
    return out


def sam_to_m4(rec, refs: list[tuple[str, int]]) -> M4Record | None:
    """BamRecord -> M4Record (None for unmapped), the sam2m4 role."""
    if rec.is_unmapped or rec.ref_id < 0:
        return None
    t_name, t_len = refs[rec.ref_id]
    q_span, t_span = cigar_spans(rec.cigar)
    lead, tail = clip_lengths(rec.cigar)
    n_err = sum(ln for ln, op in rec.cigar if op in (1, 2, 8))
    aligned = sum(ln for ln, op in rec.cigar if op in (0, 7, 8))
    denom = max(aligned + n_err, 1)
    return M4Record(
        q_name=rec.name, t_name=t_name, score=-aligned,
        identity=100.0 * max(denom - n_err, 0) / denom,
        q_strand=0, q_start=lead, q_end=q_span - tail, q_len=q_span,
        t_strand=1 if rec.is_reverse else 0, t_start=rec.pos,
        t_end=rec.pos + t_span, t_len=t_len)


def write_m4(path: str, records: list[M4Record]) -> None:
    with open(path, "w") as fh:
        for r in records:
            fh.write(r.line() + "\n")


def read_m4(path: str) -> list[M4Record]:
    out = []
    with open(path) as fh:
        for line in fh:
            f = line.split()
            if not f:
                continue
            out.append(M4Record(
                q_name=f[0], t_name=f[1], score=int(f[2]),
                identity=float(f[3]), q_strand=int(f[4]),
                q_start=int(f[5]), q_end=int(f[6]), q_len=int(f[7]),
                t_strand=int(f[8]), t_start=int(f[9]), t_end=int(f[10]),
                t_len=int(f[11])))
    return out


# ---------------------------------------------------------------------------
# BAM ingest -> columnar AlnSet (external-mapper interop)
# ---------------------------------------------------------------------------

def bam_to_alnset(bam, min_mapq: int = 0):
    """BamFile/BamColumns -> models.aligner.AlnSet.

    Lets BAM produced by any external mapper (the reference's blasr
    output) feed the device pileup/phasing path directly.  ``dist`` is
    the CIGAR-visible error count (I+D+X); with M ops mismatches are
    not distinguishable without MD/NM aux tags, which BAM-lite skips.
    """
    from .models.aligner import AlnSet
    from .io.native import BamColumns
    if isinstance(bam, BamColumns):
        bam = bam.to_bamfile()
    read_id, ctg, strand, t_s, t_e, q_len, dist, tags, q_s = \
        [], [], [], [], [], [], [], [], []
    for i, rec in enumerate(bam.records):
        if rec.is_unmapped or rec.ref_id < 0 or rec.mapq < min_mapq:
            continue
        _, t_span = cigar_spans(rec.cigar)
        read_id.append(i)
        ctg.append(rec.ref_id)
        strand.append(1 if rec.is_reverse else 0)
        t_s.append(rec.pos)
        t_e.append(rec.pos + t_span)
        q_len.append(len(rec.seq))
        dist.append(sum(ln for ln, op in rec.cigar if op in (1, 2, 8)))
        # leading soft clip = aligned-orientation read offset of the
        # first aligned base (BAM stores seq in ref orientation)
        q_s.append(rec.cigar[0][0] if rec.cigar
                   and rec.cigar[0][1] == 4 else 0)
        tags.append(cigar_to_tags(rec.cigar, rec.seq, rec.pos))
    return AlnSet(read_id=np.asarray(read_id, np.int32),
                  ctg=np.asarray(ctg, np.int32),
                  strand=np.asarray(strand, np.int8),
                  t_start=np.asarray(t_s, np.int64),
                  t_end=np.asarray(t_e, np.int64),
                  q_len=np.asarray(q_len, np.int32),
                  dist=np.asarray(dist, np.int32), tags=tags,
                  q_start=np.asarray(q_s, np.int32))


# ---------------------------------------------------------------------------
# Tiling path coordinates (tiling_path role)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TilingEdge:
    """One contig-path edge: node v -> w contributes w's extension seq."""

    v: int
    w: int
    span: int            # bases this edge appends to the contig


@dataclasses.dataclass
class TilingPath:
    """A contig as an ordered edge list with cumulative coordinates.

    coords[i] = contig offset where edge i's contribution starts;
    total = contig length.  Mirrors the reference's tiling-path files
    (ctg_paths / p_ctg_tiling_path) used to segment primary contigs
    into collapsed vs bubble regions (SURVEY.md §3.3 step 1).
    """

    edges: list[TilingEdge]

    @property
    def coords(self) -> np.ndarray:
        spans = np.asarray([e.span for e in self.edges], dtype=np.int64)
        return np.concatenate([[0], np.cumsum(spans)])[:-1]

    @property
    def total(self) -> int:
        return int(sum(e.span for e in self.edges))

    def edge_at(self, pos: int) -> int:
        """Index of the edge covering contig offset pos."""
        coords = self.coords
        i = int(np.searchsorted(coords, pos, side="right")) - 1
        if i < 0 or pos >= self.total:
            raise IndexError(f"pos {pos} outside contig of len {self.total}")
        return i

    def subpath(self, start: int, end: int) -> "TilingPath":
        """Edges covering contig interval [start, end)."""
        i, j = self.edge_at(start), self.edge_at(max(end - 1, start))
        return TilingPath(edges=self.edges[i : j + 1])
