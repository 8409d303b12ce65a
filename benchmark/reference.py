"""The plain reference that decides ``correct``: what the program produced,
scored against the simulated truth, in numpy alone.

Nothing here imports the program or takes anything it made but the
outputs being judged.  Four scorers:

- ``score_assembly``: each polished primary and haplotig, whole, in
  whichever orientation places more of it, aligned to the truth through
  its anchors (``anchored``: its disjoint k-mers that occur at one place
  in the haplotypes, chained in order), the stretches between anchors by
  banded edit distance.  Mosaic-aware by pieces: the contig is cut into
  ``piece`` bases of its own, and each piece is scored against the one
  haplotype that it matches best (an anchor holding the other
  haplotype's alleles costs their SNPs), so a primary may switch
  haplotype between phase blocks while every base error, indel and
  allele mixed within a piece counts.  A contig that places nowhere
  counts every base as an error.  The errors are summed over all
  contigs, never averaged.
- ``score_alleles``: each het SNP that the outputs show, through their
  haplotype-specific anchors, and whether both of its alleles are shown:
  a diploid assembly carries one in a primary and the other in a
  haplotig, so a haplotig that copies its primary's alleles, or no
  haplotig at all, leaves the SNP's other allele missing.
- ``score_phasing``: each phased read's haplotype of origin against the
  phase it was given, per (contig, block) under the better of the two ways
  to name the block's phases; a read phased on a contig it does not come
  from counts as wrong, and so does a read that spans two het sites or
  more and is not phased.
- ``score_pieces``: each consensus against its truth slice, end to end,
  through its anchors as above; a missing answer counts its whole slice.
"""
from __future__ import annotations

import numpy as np

INF = 1 << 28
NO_CODE = np.uint64(0xFFFFFFFFFFFFFFFF)


def _codes(seq: np.ndarray, k: int) -> np.ndarray:
    """uint64 code of every k-mer of seq (k <= 32); all ones where it holds a
    base outside ACGT."""
    seq = np.asarray(seq, np.int64)
    n = len(seq) - k + 1
    if n <= 0:
        return np.zeros(0, np.uint64)
    code = np.zeros(n, np.uint64)
    bad = np.zeros(n, bool)
    for j in range(k):
        b = seq[j : j + n]
        bad |= (b < 0) | (b > 3)
        code = (code << np.uint64(2)) | np.clip(b, 0, 3).astype(np.uint64)
    code[bad] = NO_CODE
    return code


class TruthIndex:
    """The haplotypes of one genome, contig by contig (hap0 and hap1 of a
    contig have equal lengths and coordinates), joined with spacers
    (``starts``: each contig's place), and their k-mers that occur at one
    place only, each labelled with the haplotype that holds it: 0, 1, or 2
    for both."""

    def __init__(self, hap0: list, hap1: list, k: int = 32):
        gap = np.full(k, -1, np.int8)
        self.k = k
        self.h = [np.concatenate([x for c in haps for x in (c, gap)])
                  for haps in (hap0, hap1)]
        self.starts = np.cumsum([0] + [len(c) + k for c in hap0])[:-1]
        c0, c1 = (_codes(h, k) for h in self.h)
        codes = np.concatenate([c0, c1])
        pos = np.tile(np.arange(len(c0)), 2)
        hap = np.repeat(np.array([0, 1], np.int8), len(c0))
        keep = codes != NO_CODE
        codes, pos, hap = codes[keep], pos[keep], hap[keep]
        order = np.lexsort((hap, pos, codes))
        codes, pos, hap = codes[order], pos[order], hap[order]
        same = (codes[1:] == codes[:-1]) & (pos[1:] == pos[:-1])
        first = np.r_[True, ~same]
        lab = np.where(np.r_[same, False], 2, hap).astype(np.int8)
        codes, pos, lab = codes[first], pos[first], lab[first]
        uniq = np.r_[codes[1:] != codes[:-1], True] & np.r_[
            True, codes[1:] != codes[:-1]]
        self.codes, self.pos, self.lab = codes[uniq], pos[uniq], lab[uniq]

    def hits(self, seq: np.ndarray) -> tuple:
        """(offsets in seq, places on the truth, labels) of seq's disjoint
        k-mers that occur at one place, in seq's order."""
        offs = np.arange(0, len(seq) - self.k + 1, self.k)
        if not len(offs):
            return offs, offs, offs.astype(np.int8)
        c = _codes(seq, self.k)[offs]
        at = np.minimum(np.searchsorted(self.codes, c), len(self.codes) - 1)
        hit = self.codes[at] == c
        return offs[hit], self.pos[at[hit]], self.lab[at[hit]]

    def orient(self, seq: np.ndarray) -> np.ndarray:
        """seq or its reverse complement, whichever places more k-mers."""
        seq = np.asarray(seq, np.int8)
        rc = (3 - seq[::-1]).astype(np.int8)
        return seq if len(self.hits(seq)[0]) >= len(self.hits(rc)[0]) else rc


def banded(queries: list, targets: list, band: int = 64, alts=None,
           free_ends: bool = False) -> np.ndarray:
    """Unit-cost edit distance of each query against its target, over the
    cells within ``band`` of the diagonal from (0, 0) to (n, m): global, or
    with ``free_ends`` the query whole against any stretch of the target.
    alts: a second target of each, equal in length, whose base at a column
    matches too (the other haplotype's alleles).  A path that would leave
    the band is not found, which can only raise a distance."""
    B = len(queries)
    if B == 0:
        return np.zeros(0, np.int64)
    n = np.array([len(q) for q in queries], np.int64)
    m = np.array([len(t) for t in targets], np.int64)
    if (n == 0).any():
        raise ValueError("empty query")
    Lq, Lt = int(n.max()), int(m.max())
    Q = np.full((B, Lq + 1), -2, np.int8)
    T = np.full((B, Lt + 2), -1, np.int8)
    A = np.full((B, Lt + 2), -1, np.int8)
    for b in range(B):
        Q[b, : n[b]] = queries[b]
        T[b, 1 : m[b] + 1] = targets[b]        # T[j] is the j-th base
        A[b, 1 : m[b] + 1] = (targets if alts is None else alts)[b]
    W = 2 * band + 1
    k = np.arange(W, dtype=np.int64)
    rows = np.arange(B)[:, None]

    def center(i):
        return (np.minimum(i, n) * m + n // 2) // n

    c = center(0)
    j = c[:, None] - band + k
    D = np.where((j >= 0) & (j <= m[:, None]), 0 if free_ends else j, INF)
    best = np.zeros(B, np.int64)
    pad = np.full((B, 1), INF, np.int64)
    for i in range(1, Lq + 1):
        cn = center(i)
        j = cn[:, None] - band + k
        prev = np.concatenate([pad, D, pad, pad, pad], 1)
        kp = k[None, :] + (cn - c)[:, None] + 1     # j in the padded prev
        up = np.take_along_axis(prev, np.minimum(kp, W + 3), 1) + 1
        col = np.clip(j, 0, Lt + 1)
        q = Q[:, i - 1 : i]
        diag = np.take_along_axis(prev, np.minimum(kp - 1, W + 3), 1) + (
            (T[rows, col] != q) & (A[rows, col] != q))
        t = np.minimum(up, diag)
        t = np.where(j == 0, i, t)
        t = np.where((j >= 0) & (j <= m[:, None]), t, INF)
        # an insertion run within the row: D[k] = min_{k' <= k} t[k'] + k - k'
        D = np.minimum(np.minimum.accumulate(t - k, axis=1) + k, INF)
        c = cn
        if free_ends:
            last = D.min(1)
        else:
            last = D[rows[:, 0], np.clip(band + m - cn, 0, W - 1)]  # col m
        best = np.where(n == i, last, best)
    return best


def chain(idx: TruthIndex, seq: np.ndarray, max_shift: int = 5000) -> list:
    """seq's anchors [(offset, place, label)]: its disjoint k-mers held by
    one place, each kept if it lies after the last kept one on the truth,
    its shift from it within max_shift."""
    keep = []
    for o, p, lab in zip(*idx.hits(seq)):
        if keep:
            o0, p0, _ = keep[-1]
            if p <= p0 or abs((p - p0) - (o - o0)) > max_shift:
                continue
        keep.append((int(o), int(p), int(lab)))
    return keep


def _band(q: np.ndarray, t: np.ndarray) -> int:
    """A band wide enough for the length difference of q and t."""
    return 32 << max(0, int(abs(len(q) - len(t)) + 16).bit_length() - 5)


def anchored(items: list, idx: TruthIndex, margin: int = 32,
             piece: int | None = None) -> list:
    """Edit distance of each (seq, span) through its anchors: the k-mers of
    the chain match exactly, the stretches between consecutive anchors are
    aligned globally, and the ends before the first and after the last
    anchor against the truth up to ``span`` (lo, hi) globally, or with span
    None against ``margin`` more truth with its far end free (either
    haplotype's base matching at a column).  Without ``piece``, either
    haplotype's base matches at every column of a stretch.  With it, each
    anchor and the stretch after it belong to the piece of seq that holds
    the anchor (offset // piece), and each piece counts against the one
    haplotype it matches best.  None for a seq with no anchor."""
    k = idx.k
    h0, h1 = idx.h
    out = [0] * len(items)
    cost: dict = {}                          # (item, piece) -> [hap0, hap1]
    segs = []                                # (query, target, alt, sink)
    loose, l_owner = [], []                  # free-ended stretches

    def add(i, pc, c, hap=None):
        if pc is None:
            out[i] += c
        else:
            acc = cost.setdefault((i, pc), [0, 0])
            for x in ((0, 1) if hap is None else (hap,)):
                acc[x] += c

    for i, (seq, span) in enumerate(items):
        ch = chain(idx, seq)
        if not ch:
            out[i] = None
            continue
        (of, pf, _), (ol, pl, _) = ch[0], ch[-1]
        parts = [(seq[o0 + k : o1], p0 + k, p1, o0)
                 for (o0, p0, _), (o1, p1, _) in zip(ch, ch[1:])]
        head, tail = seq[:of], seq[ol + k :]
        if piece:
            for o, p, lab in ch:             # the other haplotype's alleles
                if lab < 2:
                    add(i, o // piece,
                        int(np.count_nonzero(h0[p : p + k] != h1[p : p + k])),
                        1 - lab)
        if span is None:
            if len(head):
                loose.append((head, max(pf - len(head) - margin, 0), pf))
                l_owner.append(i)
            if len(tail):
                loose.append((tail, pl + k, pl + k + len(tail) + margin))
                l_owner.append(i)
        else:
            parts += [(head, span[0], pf, None), (tail, pl + k, span[1], None)]
        for q, a, b, o in parts:
            pc = o // piece if piece and o is not None else None
            if b < a:                  # anchors overlapping on the truth
                add(i, pc, len(q) + a - b)
            elif not len(q) or a == b:
                add(i, pc, len(q) + b - a)
            elif pc is None:
                if len(q) != b - a or not np.all(
                        (q == h0[a:b]) | (q == h1[a:b])):
                    segs.append((q, h0[a:b], h1[a:b], (i, None, None)))
            else:
                for x, h in enumerate(idx.h):
                    if len(q) != b - a or not np.array_equal(q, h[a:b]):
                        segs.append((q, h[a:b], h[a:b], (i, pc, x)))
    by_band: dict = {}
    for x in segs:
        by_band.setdefault(_band(x[0], x[1]), []).append(x)
    for band, group in by_band.items():
        d = banded([x[0] for x in group], [x[1] for x in group], band,
                   [x[2] for x in group])
        for (*_, (i, pc, hap)), v in zip(group, d):
            add(i, pc, int(v), hap)
    if loose:
        d = banded([q for q, _, _ in loose], [h0[a:b] for _, a, b in loose],
                   margin + 16, [h1[a:b] for _, a, b in loose],
                   free_ends=True)
        for i, v in zip(l_owner, d):
            out[i] += int(v)
    for (i, _), (c0, c1) in cost.items():
        if out[i] is not None:
            out[i] += min(c0, c1)
    return out


def score_assembly(contigs: list, hap0: list, hap1: list,
                   piece: int = 500) -> dict:
    """{"bases", "errors", "unplaced", "each": each contig's errors} of
    contigs (int8 codes) against the genome whose haplotypes are hap0 /
    hap1 (lists by contig), each piece of ``piece`` bases against its best
    haplotype."""
    idx = TruthIndex(hap0, hap1)
    items = [(idx.orient(s), None) for s in contigs]
    dist = anchored(items, idx, piece=piece)
    each = [len(s) if d is None else d for (s, _), d in zip(items, dist)]
    return {"bases": int(sum(len(s) for s, _ in items)),
            "errors": int(sum(each)),
            "unplaced": sum(d is None for d in dist), "each": each}


def score_alleles(contigs: list, hap0: list, hap1: list, snps: list) -> dict:
    """{"shown": het SNPs that some contig shows an allele of, "missing":
    those of them whose other allele no contig shows}.  A contig shows the
    alleles at the SNPs of each of its disjoint k-mers that only one
    haplotype holds (``TruthIndex`` labels 0 and 1).  snps: each contig's
    het SNP positions."""
    idx = TruthIndex(hap0, hap1)
    pos = np.concatenate([np.asarray(s, np.int64) + st
                          for s, st in zip(snps, idx.starts)])
    seen = np.zeros((len(pos), 2), bool)
    for s in contigs:
        _, p, lab = idx.hits(idx.orient(s))
        p, lab = p[lab < 2], lab[lab < 2]
        lo = np.searchsorted(pos, p)
        n = np.searchsorted(pos, p + idx.k) - lo
        first = np.repeat(lo - np.cumsum(n) + n, n)
        seen[first + np.arange(n.sum()), np.repeat(lab, n)] = True
    shown = seen.any(1)
    return {"shown": int(shown.sum()),
            "missing": int((shown & ~seen.all(1)).sum())}


def score_phasing(rows: list, origin: dict, phaseable: set) -> dict:
    """rows: (contig, block, phase, read name) of each phased read; origin:
    read name -> (contig, haplotype); phaseable: the reads that span two het
    sites or more.  {"reads": phaseable or phased, "wrong": phased against
    their origin, "unphased": phaseable but not phased}."""
    blocks: dict = {}
    wrong = 0
    for ctg, blk, phs, name in rows:
        o_ctg, hap = origin[name]
        if o_ctg != ctg:
            wrong += 1
            continue
        agree = blocks.setdefault((ctg, blk), [0, 0])
        agree[int(phs == hap)] += 1
    wrong += sum(min(a) for a in blocks.values())
    phased = {name for *_, name in rows}
    return {"reads": len(phaseable | phased), "wrong": int(wrong),
            "unphased": len(phaseable - phased)}


def score_pieces(answers: list, truths: list) -> dict:
    """{"bases", "errors", "missing"}: each answer (int8 codes, or None when
    it never came) against its own truth slice, end to end (slices may
    overlap on the genome, so each has an index of its own); an answer
    that does not place on its slice counts the whole slice and its own
    bases."""
    errors = missing = 0
    for a, t in zip(answers, truths):
        a = np.asarray(a if a is not None else [], np.int8)
        if not len(a):
            missing += 1
            errors += len(t)
            continue
        d = anchored([(a, (0, len(t)))], TruthIndex([t], [t]))[0]
        errors += len(t) + len(a) if d is None else d
    return {"bases": int(sum(len(t) for t in truths)), "errors": int(errors),
            "missing": missing}


def phred(errors: int, bases: int) -> float:
    """Phred of errors over bases, with errors counted as at least one."""
    return float(-10.0 * np.log10(max(errors, 1) / max(bases, 1)))
