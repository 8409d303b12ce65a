"""K-mer index over contigs: vectorized build + query (host, numpy).

Role parity: blasr's suffix-array seed anchoring and minimap2's minimizer
index ([U] SURVEY.md §2b).  Re-design: a sorted (kmer_code, position)
table with searchsorted queries — fully vectorized numpy, no per-base
Python loops; the downstream chain/extend stages consume flat anchor
arrays.  Device-side query (jnp searchsorted over a replicated/sharded
index) shares the same table layout (SURVEY.md §7 P2).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..seq import PAD, revcomp


def kmer_codes(seq: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """All k-mer codes of an int8 sequence.

    Returns (codes int64 (n-k+1,), valid bool) — invalid where any base >= 4.
    """
    seq = np.asarray(seq, dtype=np.int64)
    n = len(seq)
    if n < k:
        return np.zeros(0, np.int64), np.zeros(0, bool)
    pw = 4 ** np.arange(k - 1, -1, -1, dtype=np.int64)
    win = np.lib.stride_tricks.sliding_window_view(seq, k)
    codes = win @ pw
    valid = (win < 4).all(axis=1)
    return codes, valid


# direct-address LUT cap: 4^k int32 entries (k=13 -> 268 MB) — above this
# the index falls back to searchsorted
_LUT_MAX_CODES = 1 << 28


@dataclasses.dataclass
class KmerIndex:
    """Sorted k-mer table over a set of contigs."""

    k: int
    codes: np.ndarray       # sorted k-mer codes (int64)
    pos: np.ndarray         # global position of each code (int64)
    ctg_id: np.ndarray      # contig of each code (int32)
    ctg_starts: np.ndarray  # global start of each contig (int64, n_ctg+1)
    max_hits: int = 64      # repeat filter: ignore kmers more frequent
    lut: np.ndarray | None = None   # (4^k + 1,) int64 row starts, O(1) lookup

    @staticmethod
    def build(contigs: list[np.ndarray], k: int = 13,
              max_hits: int = 64) -> "KmerIndex":
        all_codes, all_pos, all_ctg = [], [], []
        starts = np.zeros(len(contigs) + 1, dtype=np.int64)
        off = 0
        for ci, c in enumerate(contigs):
            codes, valid = kmer_codes(c, k)
            idx = np.nonzero(valid)[0]
            all_codes.append(codes[idx])
            all_pos.append(idx.astype(np.int64))
            all_ctg.append(np.full(len(idx), ci, dtype=np.int32))
            starts[ci] = off
            off += len(c)
        starts[len(contigs)] = off
        codes = np.concatenate(all_codes) if all_codes else np.zeros(0, np.int64)
        pos = np.concatenate(all_pos) if all_pos else np.zeros(0, np.int64)
        ctg = np.concatenate(all_ctg) if all_ctg else np.zeros(0, np.int32)
        order = np.argsort(codes, kind="stable")
        codes = codes[order]
        # direct-address LUT: lut[c] = first row with code c (cumsum of
        # per-code counts) -> each query lookup is two O(1) loads instead
        # of a binary search over the table (the searchsorted calls were
        # the single largest HOST cost of the overlap stage at 1Mb scale)
        lut = None
        n_codes = 4 ** k
        if n_codes <= _LUT_MAX_CODES:
            lut = np.zeros(n_codes + 1, np.int64)
            np.cumsum(np.bincount(codes, minlength=n_codes), out=lut[1:])
        return KmerIndex(k=k, codes=codes, pos=pos[order],
                         ctg_id=ctg[order], ctg_starts=starts,
                         max_hits=max_hits, lut=lut)

    def ranges(self, codes: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """[lo, hi) table rows per query code (LUT or searchsorted)."""
        if self.lut is not None:
            return self.lut[codes], self.lut[codes + 1]
        return (np.searchsorted(self.codes, codes, side="left"),
                np.searchsorted(self.codes, codes, side="right"))

    def query(self, read: np.ndarray):
        """Anchors of a read against the index (forward strand of read).

        Returns (q_pos, t_pos, t_ctg) int64/int32 arrays of matches.
        """
        codes, valid = kmer_codes(read, self.k)
        qpos_all = np.nonzero(valid)[0]
        codes = codes[qpos_all]
        lo, hi = self.ranges(codes)
        cnt = hi - lo
        keep = (cnt > 0) & (cnt <= self.max_hits)
        lo, hi, qp = lo[keep], hi[keep], qpos_all[keep]
        total = int((hi - lo).sum())
        if total == 0:
            z = np.zeros(0, np.int64)
            return z, z, np.zeros(0, np.int32)
        # expand ranges: for each kept kmer, indices lo..hi
        reps = hi - lo
        out_idx = np.repeat(lo, reps) + (
            np.arange(total) - np.repeat(np.cumsum(reps) - reps, reps))
        q_pos = np.repeat(qp, reps)
        return q_pos, self.pos[out_idx], self.ctg_id[out_idx]


@dataclasses.dataclass
class SeedHit:
    """Chained seed placement of a read on a contig."""

    ctg: int
    strand: int          # 0 = forward, 1 = reverse-complement
    diag: int            # approx t_pos - q_pos
    t_lo: int            # approx target window
    t_hi: int
    score: int           # number of supporting anchors


def chain_diag_bins(q_pos, t_pos, t_ctg, read_len: int, k: int,
                    bin_width: int = 64, min_anchors: int = 4,
                    max_hits_per_read: int = 4) -> list[SeedHit]:
    """Diagonal-binning chainer (minimap2-rough style).

    Anchors vote into (ctg, (t_pos - q_pos) // bin_width) bins; winning
    bins (plus neighbors) define the placement window.  O(anchors) and
    fully vectorized.
    """
    if len(q_pos) == 0:
        return []
    diag = t_pos - q_pos
    key = t_ctg.astype(np.int64) * (1 << 40) + ((diag + (1 << 30)) // bin_width)
    uniq, inv, counts = np.unique(key, return_inverse=True, return_counts=True)
    # merge votes from neighboring bins
    order = np.argsort(uniq)
    merged = counts.copy()
    same_ctg = (uniq[1:] >> 40) == (uniq[:-1] >> 40)
    adjacent = (uniq[1:] - uniq[:-1]) == 1
    nb = same_ctg & adjacent
    merged[1:][nb] += counts[:-1][nb]
    merged[:-1][nb] += counts[1:][nb]
    hits: list[SeedHit] = []
    used_diag: list[tuple[int, int]] = []
    for bi in np.argsort(-merged)[: max_hits_per_read * 4]:
        if merged[bi] < min_anchors:
            break
        ctg = int(uniq[bi] >> 40)
        dbin = int(uniq[bi] & ((1 << 40) - 1)) - ((1 << 30) // bin_width)
        d0 = dbin * bin_width
        if any(c == ctg and abs(d0 - d) <= 2 * bin_width for c, d in used_diag):
            continue
        sel = (inv == bi)
        dg = diag[sel]
        # extrapolate the read span from the anchor diagonals:
        # read pos 0 maps near t = diag, read end near t = diag + read_len
        t_lo = int(dg.min())
        t_hi = int(dg.max() + read_len + k)
        hits.append(SeedHit(ctg=ctg, strand=0, diag=d0,
                            t_lo=t_lo, t_hi=t_hi, score=int(merged[bi])))
        used_diag.append((ctg, d0))
        if len(hits) >= max_hits_per_read:
            break
    return hits


def seed_read(index: KmerIndex, read: np.ndarray, read_len: int | None = None,
              **chain_kw) -> list[SeedHit]:
    """Seed+chain a read on both strands. t_lo/t_hi are contig-local."""
    if read_len is None:
        read_len = len(read)
    out = []
    for strand, r in ((0, read), (1, revcomp(read))):
        q_pos, t_pos, t_ctg = index.query(r)
        # contig-local coordinates
        t_local = t_pos
        hits = chain_diag_bins(q_pos, t_local, t_ctg, read_len, index.k,
                               **chain_kw)
        for h in hits:
            h.strand = strand
        out.extend(hits)
    out.sort(key=lambda h: -h.score)
    return out


def chain_best_per_target(q_pos, t_pos, t_ctg, *, bin_width: int = 64,
                          min_anchors: int = 4):
    """Best diagonal bin per TARGET read, fully vectorized.

    Equivalent to calling chain_diag_bins(...) with max_hits_per_read=1
    once per unique target (the overlapper's candidate pattern), but in
    one numpy pass over all anchors: group anchors into (ctg, diag bin)
    keys, merge neighbor-bin votes, then take each ctg's highest-vote
    bin (ties -> smaller bin key, matching chain_diag_bins' stable
    argsort order).  Returns (ctgs int64[], t_lo int64[]) where t_lo is
    the minimum anchor diagonal within the winning bin.
    """
    if len(q_pos) == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    diag = t_pos.astype(np.int64) - q_pos.astype(np.int64)
    key = t_ctg.astype(np.int64) * (1 << 40) + \
        ((diag + (1 << 30)) // bin_width)
    uniq, inv, counts = np.unique(key, return_inverse=True,
                                  return_counts=True)
    merged = counts.copy()
    same_ctg = (uniq[1:] >> 40) == (uniq[:-1] >> 40)
    adjacent = (uniq[1:] - uniq[:-1]) == 1
    nb = same_ctg & adjacent
    merged[1:][nb] += counts[:-1][nb]
    merged[:-1][nb] += counts[1:][nb]

    # min anchor diagonal per bin
    bin_min_diag = np.full(len(uniq), np.iinfo(np.int64).max, np.int64)
    np.minimum.at(bin_min_diag, inv, diag)

    # winner per ctg: sort by (-votes, key), first occurrence per ctg
    order = np.lexsort((uniq, -merged))
    ctg_of = (uniq >> 40)[order]
    first = np.unique(ctg_of, return_index=True)[1]
    win = order[first]
    ok = merged[win] >= min_anchors
    win = win[ok]
    return (uniq[win] >> 40), bin_min_diag[win]


def query_flat(index: "KmerIndex", seqs: list[np.ndarray]):
    """Anchors of MANY reads in one vectorized pass.

    Reads are concatenated with one PAD separator (k-mers spanning a
    boundary contain the PAD and drop as invalid), so kmer_codes +
    searchsorted + range expansion run once for the whole batch.

    Returns (read_id, q_pos, t_pos, t_ctg) flat arrays.
    """
    lens = np.array([len(s) for s in seqs], np.int64)
    offs = np.zeros(len(seqs) + 1, np.int64)
    np.cumsum(lens + 1, out=offs[1:])
    flat = np.full(int(offs[-1]), PAD, np.int8)
    for i, s in enumerate(seqs):
        flat[offs[i] : offs[i] + len(s)] = s
    codes, valid = kmer_codes(flat, index.k)
    gq_all = np.nonzero(valid)[0]
    codes = codes[gq_all]
    lo, hi = index.ranges(codes)
    cnt = hi - lo
    keep = (cnt > 0) & (cnt <= index.max_hits)
    lo, hi, gq = lo[keep], hi[keep], gq_all[keep]
    reps = hi - lo
    total = int(reps.sum())
    if total == 0:
        z = np.zeros(0, np.int64)
        return z.astype(np.int32), z, z, np.zeros(0, np.int32)
    out_idx = np.repeat(lo, reps) + (
        np.arange(total) - np.repeat(np.cumsum(reps) - reps, reps))
    gq_rep = np.repeat(gq, reps)
    read_id = (np.searchsorted(offs, gq_rep, side="right") - 1).astype(
        np.int32)
    q_pos = gq_rep - offs[read_id]
    return read_id, q_pos, index.pos[out_idx], index.ctg_id[out_idx]


def chain_best_per_read(read_id, q_pos, t_pos, t_ctg, n_targets: int, *,
                        bin_width: int = 64, min_anchors: int = 4):
    """Winning (ctg, diag-bin) per READ over a flat anchor batch.

    Matches chain_diag_bins(max_hits_per_read=1) per read: bins keyed by
    (ctg, diag // bin_width), neighbor-bin votes merged, winner = highest
    merged votes with ties to the smaller (ctg, bin) key.  Returns
    (read_ids, ctgs, score, d_min, d_max) where d_min/d_max are the
    min/max anchor diagonal WITHIN the winning bin (not its neighbors) —
    the same t_lo / t_hi - read_len - k window chain_diag_bins derives.
    """
    z = np.zeros(0, np.int64)
    if len(q_pos) == 0:
        return z, z, z, z, z
    pair = read_id.astype(np.int64) * n_targets + t_ctg.astype(np.int64)
    assert pair.max(initial=0) < (1 << 31), "block the read axis"
    diag = t_pos.astype(np.int64) - q_pos.astype(np.int64)
    bins = (diag + (1 << 30)) // bin_width
    key = pair * (1 << 32) + bins
    uniq, inv, counts = np.unique(key, return_inverse=True,
                                  return_counts=True)
    merged = counts.copy()
    same = (uniq[1:] >> 32) == (uniq[:-1] >> 32)
    adjacent = (uniq[1:] - uniq[:-1]) == 1
    nb = same & adjacent
    merged[1:][nb] += counts[:-1][nb]
    merged[:-1][nb] += counts[1:][nb]
    bin_min = np.full(len(uniq), np.iinfo(np.int64).max, np.int64)
    bin_max = np.full(len(uniq), np.iinfo(np.int64).min, np.int64)
    np.minimum.at(bin_min, inv, diag)
    np.maximum.at(bin_max, inv, diag)
    order = np.lexsort((uniq, -merged))
    read_of = (uniq >> 32)[order] // n_targets
    first = np.unique(read_of, return_index=True)[1]
    win = order[first]
    win = win[merged[win] >= min_anchors]
    pair_w = uniq[win] >> 32
    return (pair_w // n_targets, pair_w % n_targets, merged[win],
            bin_min[win], bin_max[win])


def thread_map(fn, tasks: list[tuple]):
    """Ordered thread map over independent numpy passes.

    The heavy kernels inside (np.unique / lexsort / searchsorted /
    fancy gathers) release the GIL, so the host cores overlap; results
    come back in task order so downstream output stays byte-identical
    to the serial loop (round-5 host-dominator work: seed_s + cand_s
    were ~460 s of single-core numpy at 10 Mb, VERDICT r4 weak #1).
    """
    import os
    workers = min(4, os.cpu_count() or 1)
    if len(tasks) <= 1 or workers <= 1:
        return [fn(*t) for t in tasks]
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(max_workers=workers) as ex:
        return list(ex.map(lambda t: fn(*t), tasks))


def seed_batch(index: "KmerIndex", seqs: list[np.ndarray], *,
               min_anchors: int = 4, bin_width: int = 64):
    """Best single placement per read across BOTH strands, one numpy pass
    per (strand, block) instead of a per-read seed_read loop.

    Selection matches seed_read(..., max_hits_per_read=1): per strand the
    chain_diag_bins winner, then the higher-score strand (ties -> fwd).
    Returns columnar int64 arrays (strand, ctg, score, d_min, d_max) of
    length len(seqs); score == -1 marks unseeded reads.  (strand, block)
    passes are independent and run on a thread pool; updates are applied
    in task order, so the result is byte-identical to the serial loop.
    """
    n = len(seqs)
    n_t = len(index.ctg_starts) - 1
    best = {k: np.full(n, -1, np.int64)
            for k in ("strand", "ctg", "score", "d_min", "d_max")}
    block = max(1, min(n, 4096, (1 << 31) // max(n_t, 1) - 1))
    rcs = None

    def _one(strand: int, a0: int):
        ss = seqs if strand == 0 else rcs
        rid, qp, tp, tc = query_flat(index, ss[a0 : a0 + block])
        return chain_best_per_read(rid, qp, tp, tc, n_t,
                                   bin_width=bin_width,
                                   min_anchors=min_anchors)

    tasks = []
    for strand in (0, 1):
        if strand == 1:
            rcs = [revcomp(s) for s in seqs]
        tasks += [(strand, a0) for a0 in range(0, n, block)]
    for (strand, a0), (r, c, sc, dmin, dmax) in zip(
            tasks, thread_map(_one, tasks)):
        r = r + a0
        upd = sc > best["score"][r]             # strict: fwd wins ties
        ru = r[upd]
        best["strand"][ru] = strand
        best["ctg"][ru] = c[upd]
        best["score"][ru] = sc[upd]
        best["d_min"][ru] = dmin[upd]
        best["d_max"][ru] = dmax[upd]
    return (best["strand"], best["ctg"], best["score"],
            best["d_min"], best["d_max"])


def chain_best_per_pair(read_id, q_pos, t_pos, t_ctg, n_targets: int, *,
                        bin_width: int = 64, min_anchors: int = 4,
                        min_span: int = 0):
    """Best diagonal bin per (read, target) pair over a flat anchor batch.

    The (read, target)-pair generalization of chain_best_per_target:
    identical per-pair semantics, one numpy pass for the whole batch.
    Returns (read_ids, target_ids, t_lo) arrays.  Keys use
    pair_id * 2^32 + bin, so read_id * n_targets must stay below 2^31
    (callers block the read axis for larger batches).

    min_span: minimum q_pos SPREAD of the winning bin's anchors.  A
    single random ~(k+3)-mer exact match between unrelated reads emits
    min_anchors CONSECUTIVE anchors on one diagonal — at 10 Mb scale
    such coincidences produced 5.6x more candidates than true overlaps
    and dominated the overlap stage's pack/upload/DP cost.  Real
    overlaps carry anchors spread across hundreds of bases; requiring a
    spread kills the quadratic junk without losing sensitivity (0
    disables).
    """
    if len(q_pos) == 0:
        z = np.zeros(0, np.int64)
        return z, z, z
    pair = read_id.astype(np.int64) * n_targets + t_ctg.astype(np.int64)
    assert pair.max(initial=0) < (1 << 31), "block the read axis"
    diag = t_pos.astype(np.int64) - q_pos.astype(np.int64)
    bins = (diag + (1 << 30)) // bin_width
    key = pair * (1 << 32) + bins
    uniq, inv, counts = np.unique(key, return_inverse=True,
                                  return_counts=True)
    merged = counts.copy()
    same = (uniq[1:] >> 32) == (uniq[:-1] >> 32)
    adjacent = (uniq[1:] - uniq[:-1]) == 1
    nb = same & adjacent
    merged[1:][nb] += counts[:-1][nb]
    merged[:-1][nb] += counts[1:][nb]
    bin_min_diag = np.full(len(uniq), np.iinfo(np.int64).max, np.int64)
    np.minimum.at(bin_min_diag, inv, diag)
    order = np.lexsort((uniq, -merged))
    pair_of = (uniq >> 32)[order]
    first = np.unique(pair_of, return_index=True)[1]
    win = order[first]
    win = win[merged[win] >= min_anchors]
    if min_span > 0 and len(win):
        qmin = np.full(len(uniq), np.iinfo(np.int64).max, np.int64)
        qmax = np.full(len(uniq), np.iinfo(np.int64).min, np.int64)
        q64 = q_pos.astype(np.int64)
        np.minimum.at(qmin, inv, q64)
        np.maximum.at(qmax, inv, q64)
        # spread over the merged neighborhood (own bin + adjacent)
        qmin_m, qmax_m = qmin.copy(), qmax.copy()
        np.minimum.at(qmin_m, np.nonzero(nb)[0], qmin[1:][nb])
        np.minimum.at(qmin_m, np.nonzero(nb)[0] + 1, qmin[:-1][nb])
        np.maximum.at(qmax_m, np.nonzero(nb)[0], qmax[1:][nb])
        np.maximum.at(qmax_m, np.nonzero(nb)[0] + 1, qmax[:-1][nb])
        win = win[qmax_m[win] - qmin_m[win] >= min_span]
    pair_w = uniq[win] >> 32
    return pair_w // n_targets, pair_w % n_targets, bin_min_diag[win]
