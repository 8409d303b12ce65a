"""Seed-chain-extend read->contig aligner (the blasr role) on a torch device.

Port of ``falcon_unzip_tpu.models.aligner``.  Anchoring and chaining are
the reference's host numpy (``ops.kmer_index``); the extension DP runs in
``ops.banded_align.BandedAligner`` on the aligner's ``device``.  Reads are
bucketed by length on the pow2 query ladder from 256 so each bucket is
one fixed-shape device batch.  ``AlnSet``, ``LongAln``,
``align_long_queries`` and the packing helpers are verbatim copies.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np

from ..device import resolve
from ..ops.banded_align import BandedAligner, anchor_trim, moves_to_tags_vec
from ..ops.kmer_index import KmerIndex, seed_batch, seed_read
from ..seq import PAD, SeqBatch, revcomp
from ..utils.profiling import span


@dataclasses.dataclass
class AlnSet:
    """Columnar alignment records for a read batch vs a contig set."""

    read_id: np.ndarray    # (A,) int32 index into the read batch
    ctg: np.ndarray        # (A,) int32
    strand: np.ndarray     # (A,) int8   0 fwd / 1 rc
    t_start: np.ndarray    # (A,) int64  contig-local start of alignment
    t_end: np.ndarray      # (A,) int64
    q_len: np.ndarray      # (A,) int32
    dist: np.ndarray       # (A,) int32 edit distance
    tags: list[np.ndarray] # per-record (n,3) int32 (t_pos, delta, base),
                           # t_pos in CONTIG-local coordinates
    q_start: np.ndarray | None = None
    #   (A,) int32 start of the aligned span in the ALIGNED-ORIENTATION
    #   read (fwd reads: offset from read start; rc reads: offset from
    #   read END) — lets consumers map each read-consuming tag back to a
    #   read coordinate (per-base quality conditioning, SURVEY.md §2b
    #   variantCaller row).  None (legacy blobs) -> zeros.

    def __post_init__(self):
        if self.q_start is None:
            self.q_start = np.zeros(len(self.read_id), np.int32)

    def __len__(self) -> int:
        return len(self.read_id)

    def identity(self) -> np.ndarray:
        span = np.maximum(self.t_end - self.t_start, 1)
        return 1.0 - self.dist / span

    def sort_canonical(self) -> "AlnSet":
        """Reorder records into the canonical (read_id, ctg, strand,
        t_start, t_end) order.

        Record order out of the batched DP is bucket-shape order, which
        depends on how the read batch was split; the canonical sort makes
        the record order a pure function of the record SET, so a
        host-sharded multi-process run merges to byte-identical output
        (SURVEY.md §2c cluster fan-out row)."""
        order = np.lexsort((self.t_end, self.t_start, self.strand,
                            self.ctg, self.read_id))
        return AlnSet(
            read_id=self.read_id[order], ctg=self.ctg[order],
            strand=self.strand[order], t_start=self.t_start[order],
            t_end=self.t_end[order], q_len=self.q_len[order],
            dist=self.dist[order],
            tags=[self.tags[i] for i in order],
            q_start=self.q_start[order])

    def subset(self, mask: np.ndarray) -> "AlnSet":
        """Records selected by a boolean mask (or index array), order
        preserved — the contig-owner routing primitive."""
        idx = np.nonzero(mask)[0] if mask.dtype == bool else mask
        return AlnSet(
            read_id=self.read_id[idx], ctg=self.ctg[idx],
            strand=self.strand[idx], t_start=self.t_start[idx],
            t_end=self.t_end[idx], q_len=self.q_len[idx],
            dist=self.dist[idx],
            tags=[self.tags[i] for i in idx],
            q_start=self.q_start[idx])

    def to_bytes(self) -> bytes:
        """Pack into one msgpack blob (the cross-host gather payload)."""
        from ..parallel.distributed import pack_arrays
        tag_lens = np.array([len(t) for t in self.tags], np.int64)
        tag_cat = (np.concatenate(self.tags) if self.tags
                   else np.zeros((0, 3), np.int32)).astype(np.int32)
        return pack_arrays({
            "read_id": self.read_id, "ctg": self.ctg,
            "strand": self.strand, "t_start": self.t_start,
            "t_end": self.t_end, "q_len": self.q_len, "dist": self.dist,
            "q_start": self.q_start,
            "tag_lens": tag_lens, "tag_cat": tag_cat.reshape(-1, 3)})

    @staticmethod
    def from_bytes(blob: bytes) -> "AlnSet":
        from ..parallel.distributed import unpack_arrays
        c = unpack_arrays(blob)
        offs = np.concatenate([[0], np.cumsum(c["tag_lens"])]).astype(np.int64)
        tags = [c["tag_cat"][offs[i]:offs[i + 1]]
                for i in range(len(c["tag_lens"]))]
        return AlnSet(read_id=c["read_id"], ctg=c["ctg"],
                      strand=c["strand"], t_start=c["t_start"],
                      t_end=c["t_end"], q_len=c["q_len"], dist=c["dist"],
                      tags=tags, q_start=c.get("q_start"))

    @staticmethod
    def merge(parts: list["AlnSet"]) -> "AlnSet":
        """Concatenate per-host record shards and canonically re-sort."""
        return AlnSet(
            read_id=np.concatenate([p.read_id for p in parts]),
            ctg=np.concatenate([p.ctg for p in parts]),
            strand=np.concatenate([p.strand for p in parts]),
            t_start=np.concatenate([p.t_start for p in parts]),
            t_end=np.concatenate([p.t_end for p in parts]),
            q_len=np.concatenate([p.q_len for p in parts]),
            dist=np.concatenate([p.dist for p in parts]),
            tags=[t for p in parts for t in p.tags],
            q_start=np.concatenate([p.q_start for p in parts])
            ).sort_canonical()


@dataclasses.dataclass
class AlignerConfig:
    k: int = 13
    max_hits: int = 64           # kmer repeat filter
    band: int = 256              # DP band width W
    # Window slack. The slope-1/2 band covers start offsets o <= ~W, so the
    # pad must stay well under the band width; anchor-diagonal drift from
    # indels eats the rest of the margin (see seed window math in
    # ops.kmer_index.chain_diag_bins).
    window_pad: int = 48
    min_anchors: int = 4
    max_hits_per_read: int = 1   # placements kept per read
    min_identity: float = 0.65
    batch_pairs: int = 256        # device batch size
    anchor_k: int = 8             # exact-match run anchoring both aln ends


def clip_query_overhang(q: np.ndarray, d0: int, d1: int, t_len: int,
                        pad: int) -> tuple[np.ndarray, int]:
    """Pre-DP soft clip of query bases hanging past the target's ends.

    Seed diagonals place the read's span on the target at roughly
    [d0, d1 + len(q)).  Bases beyond [0, t_len) cannot be placed by the
    slope-1/2 banded DP — a long overhang drifts out of the band and
    smears garbage tags over the contig's terminal columns — so they are
    clipped BEFORE alignment (blasr soft-clip semantics, [U] SURVEY.md
    §2b blasr row), keeping `pad` bases of slack for chaining error.
    Returns (q_slice, q_lo); the residual <= pad overhang comes out of
    the DP as up-runs and is trimmed by ops.banded_align.soft_clip_ups.
    """
    q_lo = max(0, -int(d0) - pad)
    q_hi = max(0, int(d1) + len(q) - t_len - pad)
    if q_lo + q_hi >= len(q):
        return q[:0], 0
    if q_lo or q_hi:
        return q[q_lo : len(q) - q_hi], q_lo
    return q, 0


class ReadToContigAligner:
    """Map a read batch onto contigs; emit AlnSet with per-read tags.

    device: the torch device of the DP (None: the enclosing
    ``device.scope``)."""

    def __init__(self, contigs: list[np.ndarray],
                 cfg: AlignerConfig | None = None, device=None):
        self.cfg = cfg or AlignerConfig()
        self.device = resolve(device)
        self.contigs = [np.asarray(c, dtype=np.int8) for c in contigs]
        self.index = KmerIndex.build(self.contigs, k=self.cfg.k,
                                     max_hits=self.cfg.max_hits)
        self._aligners: dict[tuple[int, int], BandedAligner] = {}
        # flat contig pool for vectorized target packing
        self._ctg_pool = (np.concatenate(self.contigs) if self.contigs
                          else np.zeros(0, np.int8))
        self.timings: dict = {}

    def _aligner(self) -> BandedAligner:
        if "a" not in self._aligners:
            self._aligners["a"] = BandedAligner(W=self.cfg.band,
                                                mode="tglocal",
                                                device=self.device)
        return self._aligners["a"]

    def align_batch(self, reads: SeqBatch,
                    read_range: tuple[int, int] | None = None) -> AlnSet:
        """Align reads onto the contig set.

        read_range: optional [lo, hi) read-id slice to process (the
        host-shard hook).  Per-read results are independent, so sharding
        never changes record values, and the canonical sort makes order
        shard-invariant.
        """
        cfg = self.cfg
        tm = {"seed_s": 0.0, "jobs_s": 0.0, "pack_s": 0.0,
              "dispatch_s": 0.0, "fetch_s": 0.0, "post_s": 0.0}
        r_lo, r_hi = read_range if read_range is not None \
            else (0, len(reads))
        # read pools for vectorized query packing: fwd + revcomp of the
        # batch slice, with per-read offsets (jobs reference pool spans
        # instead of materialized per-read arrays)
        seqs = [reads.row(i) for i in range(r_lo, r_hi)]
        rlen = np.array([len(s) for s in seqs], np.int64)
        roff = np.zeros(len(seqs) + 1, np.int64)
        np.cumsum(rlen, out=roff[1:])
        fwd_pool = (np.concatenate(seqs) if seqs
                    else np.zeros(0, np.int8))
        rc_pool = (np.concatenate([revcomp(s) for s in seqs]) if seqs
                   else np.zeros(0, np.int8))
        qpool = np.concatenate([fwd_pool, rc_pool])
        nf = len(fwd_pool)
        ctg_starts = self.index.ctg_starts

        # 1) seed + chain every read (host, one vectorized pass for the
        #    whole batch when a single placement per read is kept; the
        #    per-read seed_read loop serves max_hits_per_read > 1)
        jobs = []  # (read_id, strand, ctg, win_lo, win_hi, q_off, q_len)
        if cfg.max_hits_per_read == 1:
            with span("align.seed") as sp:
                strand, ctg_a, score, d_min, d_max = seed_batch(
                    self.index, seqs, min_anchors=cfg.min_anchors)
            tm["seed_s"] = sp.s
        with span("align.jobs") as sp:
            if cfg.max_hits_per_read == 1:
                for rid in np.nonzero(score >= 0)[0]:
                    L = int(rlen[rid])
                    t_len = len(self.contigs[ctg_a[rid]])
                    d0, d1 = int(d_min[rid]), int(d_max[rid])
                    # clip_query_overhang on pool spans (same arithmetic)
                    q_lo = max(0, -d0 - cfg.window_pad)
                    q_hi = max(0, d1 + L - t_len - cfg.window_pad)
                    qn = L - q_lo - q_hi
                    if qn < cfg.k:
                        continue
                    lo = max(0, d0 + q_lo - cfg.window_pad)
                    hi = min(t_len,
                             d1 + q_lo + qn + cfg.k + cfg.window_pad)
                    if hi - lo < cfg.k:
                        continue
                    q_off = (roff[rid] if strand[rid] == 0
                             else nf + roff[rid]) + q_lo
                    jobs.append((int(rid) + r_lo, int(strand[rid]),
                                 int(ctg_a[rid]), lo, hi, int(q_off), qn))
            else:
                for rid in range(r_lo, r_hi):
                    r = seqs[rid - r_lo]
                    if len(r) < cfg.k:
                        continue
                    hits = seed_read(self.index, r,
                                     min_anchors=cfg.min_anchors,
                                     max_hits_per_read=cfg.max_hits_per_read)
                    for h in hits[: cfg.max_hits_per_read]:
                        L = len(r)
                        t_len = len(self.contigs[h.ctg])
                        d0 = h.t_lo
                        d1 = h.t_hi - L - cfg.k
                        q_lo = max(0, -d0 - cfg.window_pad)
                        q_hi = max(0, d1 + L - t_len - cfg.window_pad)
                        qn = L - q_lo - q_hi
                        if qn < cfg.k:
                            continue
                        lo = max(0, d0 + q_lo - cfg.window_pad)
                        hi = min(t_len,
                                 d1 + q_lo + qn + cfg.k + cfg.window_pad)
                        if hi - lo < cfg.k:
                            continue
                        q_off = (roff[rid - r_lo] if h.strand == 0
                                 else nf + roff[rid - r_lo]) + q_lo
                        jobs.append((rid, h.strand, h.ctg, lo, hi,
                                     int(q_off), qn))
        tm["jobs_s"] = sp.s

        # 2) bucket jobs by padded shapes and run the device DP.  The
        # target bucket tracks the query bucket (bt = bq + step*j), since
        # the DP window is always ~len(q) + pads.  Padding is inert to
        # results (PAD chars never match; end extraction uses true
        # lengths).
        out = {k: [] for k in
               ("read_id", "ctg", "strand", "t_start", "t_end",
                "q_len", "dist", "q_start")}
        tags_out: list[np.ndarray] = []
        aligner = self._aligner()
        j_ctg = np.array([j[2] for j in jobs], np.int64)
        j_lo = np.array([j[3] for j in jobs], np.int64)
        j_hi = np.array([j[4] for j in jobs], np.int64)
        j_qoff = np.array([j[5] for j in jobs], np.int64)
        j_qn = np.array([j[6] for j in jobs], np.int64)
        buckets: dict[tuple[int, int], list[int]] = {}
        for ji in range(len(jobs)):
            bq = _q_bucket(int(j_qn[ji]))
            bt = _t_bucket(int(j_hi[ji] - j_lo[ji]), bq)
            buckets.setdefault((bq, bt), []).append(ji)
        # two-phase async: dispatch chunks ahead of collection under a
        # BOUNDED window (every in-flight chunk pins its input and
        # moves buffers)
        max_inflight = int(os.environ.get(
            "FALCON_UNZIP_TPU_MAX_INFLIGHT", "1024"))
        pending = []  # (chunk, n_real, handle)

        def _drain_one():
            chunk, n_real, handle = pending.pop(0)
            with span("align.fetch") as sp:
                res = aligner.collect(handle)
            tm["fetch_s"] += sp.s
            with span("align.post") as sp:
                for pi, ji in enumerate(chunk[:n_real]):
                    rid, strand, ctg, lo, hi, q_off, qn = jobs[ji]
                    q = qpool[q_off : q_off + qn]
                    # anchor both alignment ends on exact k-runs: smeared
                    # free-end tails (query overhang / read-end errors)
                    # emit no tags and no edits
                    cl = anchor_trim(q, self.contigs[ctg][lo:hi],
                                     res["moves"][pi],
                                     int(res["end_j"][pi]),
                                     k=cfg.anchor_k)
                    if cl is None:
                        continue
                    start_j, end_j = cl["start_j"], cl["end_j"]
                    dist = cl["dist"]
                    width = max(end_j - start_j, 1)
                    if 1.0 - dist / width < cfg.min_identity:
                        continue
                    tags = moves_to_tags_vec(cl["q"], cl["moves"],
                                             t_offset=lo + start_j)
                    out["read_id"].append(rid)
                    out["ctg"].append(ctg)
                    out["strand"].append(strand)
                    out["t_start"].append(lo + start_j)
                    out["t_end"].append(lo + end_j)
                    out["q_len"].append(qn)
                    out["dist"].append(dist)
                    # aligned-orientation read offset of the first kept
                    # base: overhang clip (q_off rel. to the read's pool
                    # row) + anchor trim
                    out["q_start"].append(
                        q_off - int(roff[rid - r_lo])
                        - (nf if strand else 0) + cl["q0"])
                    tags_out.append(tags)
            tm["post_s"] += sp.s
        chunk_pairs = cfg.batch_pairs
        for (bq, bt), jidx in sorted(buckets.items()):
            for s in range(0, len(jidx), chunk_pairs):
                chunk = jidx[s : s + chunk_pairs]
                n_real = len(chunk)
                if n_real < chunk_pairs and s > 0:
                    # pad the tail chunk to the full batch (repeat last
                    # job, results discarded), as the reference does
                    chunk = chunk + [chunk[-1]] * (chunk_pairs - n_real)
                P = len(chunk)
                idx = np.asarray(chunk)
                with span("align.pack") as sp:
                    qa = _gather_rows(qpool, j_qoff[idx], j_qn[idx], P, bq)
                    ta = _gather_rows(self._ctg_pool,
                                      ctg_starts[j_ctg[idx]] + j_lo[idx],
                                      j_hi[idx] - j_lo[idx], P, bt)
                tm["pack_s"] += sp.s
                with span("align.dispatch") as sp:
                    pending.append((chunk, n_real, aligner.dispatch(
                        qa, ta, j_qn[idx].astype(np.int32),
                        (j_hi[idx] - j_lo[idx]).astype(np.int32),
                        want_moves=True)))
                tm["dispatch_s"] += sp.s
                if len(pending) >= max_inflight:
                    _drain_one()
        while pending:
            _drain_one()

        self.timings = {k: round(v, 2) for k, v in tm.items()}
        self.timings["n_jobs"] = len(jobs)
        return AlnSet(
            read_id=np.array(out["read_id"], np.int32),
            ctg=np.array(out["ctg"], np.int32),
            strand=np.array(out["strand"], np.int8),
            t_start=np.array(out["t_start"], np.int64),
            t_end=np.array(out["t_end"], np.int64),
            q_len=np.array(out["q_len"], np.int32),
            dist=np.array(out["dist"], np.int32),
            tags=tags_out,
            q_start=np.array(out["q_start"], np.int32),
        ).sort_canonical()


@dataclasses.dataclass
class LongAln:
    """Columnar result of chunk-sampled long-query alignment."""

    read_id: np.ndarray   # (A,) int32
    ctg: np.ndarray       # (A,) int32
    strand: np.ndarray    # (A,) int8
    t_start: np.ndarray   # (A,) int64  union interval on the target
    t_end: np.ndarray     # (A,) int64
    q_len: np.ndarray     # (A,) int32
    dist: np.ndarray      # (A,) int32  summed chunk edit distance
    span: np.ndarray      # (A,) int32  summed chunk aligned span

    def __len__(self):
        return len(self.read_id)

    def identity(self) -> np.ndarray:
        return 1.0 - self.dist / np.maximum(self.span, 1)


def align_long_queries(aligner: "ReadToContigAligner", batch: SeqBatch,
                       chunk: int = 4096, max_chunks: int = 8,
                       target_ctg: np.ndarray | None = None) -> LongAln:
    """Place LONG queries (haplotigs, contigs) by chunk sampling.

    A whole-contig banded DP with traceback materializes an
    O(Dmax * PB * W) backpointer tensor — an 18 GB allocation for a 65k
    query at W=512 (observed OOM on the 1 Mb e2e).  Placement and dedup
    only need the mapped INTERVAL and a sampled identity, so each query
    is aligned as <= max_chunks head/tail/interior chunks of `chunk`
    bases — every job lands in the standard canonical kernel shape —
    and the per-query interval is the union of its chunk intervals on
    the majority contig (strand from the head chunk).

    target_ctg: optional (len(batch),) required contig id per query —
    chunk hits on other contigs are dropped instead of voting (the
    haplotig-placement case: align each h_ctg to its OWN primary, so
    every query shares ONE aligner/index over all primaries instead of
    one index build per primary).
    """
    jobs_per_q: list[list[int]] = []
    offs: list[int] = []
    seqs: list[np.ndarray] = []
    for qi in range(len(batch)):
        r = batch.row(qi)
        L = len(r)
        if L <= chunk:
            starts = [0]
        else:
            n_ch = min(max_chunks, max(2, -(-L // chunk)))
            starts = list(np.unique(np.linspace(
                0, L - chunk, n_ch).astype(np.int64)))
        jobs_per_q.append(list(range(len(offs),
                                     len(offs) + len(starts))))
        for s in starts:
            offs.append(int(s))
            seqs.append(r[s : s + chunk])
    from ..seq import round_up
    lmax = round_up(max((len(s) for s in seqs), default=1), 128)
    data = np.full((len(seqs), lmax), PAD, np.int8)
    lengths = np.zeros(len(seqs), np.int32)
    for i, s in enumerate(seqs):
        data[i, : len(s)] = s
        lengths[i] = len(s)
    sub = SeqBatch(data=data, lengths=lengths,
                   names=[f"chunk/{i}" for i in range(len(seqs))])
    aln = aligner.align_batch(sub)

    by_chunk: dict[int, int] = {}
    for a in range(len(aln)):
        by_chunk.setdefault(int(aln.read_id[a]), a)
    cols = {k: [] for k in ("read_id", "ctg", "strand", "t_start",
                            "t_end", "q_len", "dist", "span")}
    for qi, jids in enumerate(jobs_per_q):
        hits = [(j, by_chunk[j]) for j in jids if j in by_chunk]
        if not hits:
            continue
        if target_ctg is not None:
            ctg = int(target_ctg[qi])
        else:
            ctgs = [int(aln.ctg[a]) for _, a in hits]
            ctg = max(set(ctgs), key=ctgs.count)  # majority contig
        hits = [(j, a) for (j, a) in hits if int(aln.ctg[a]) == ctg]
        if not hits:
            continue
        cols["read_id"].append(qi)
        cols["ctg"].append(ctg)
        cols["strand"].append(int(aln.strand[hits[0][1]]))
        cols["t_start"].append(min(int(aln.t_start[a]) for _, a in hits))
        cols["t_end"].append(max(int(aln.t_end[a]) for _, a in hits))
        cols["q_len"].append(int(batch.lengths[qi]))
        cols["dist"].append(sum(int(aln.dist[a]) for _, a in hits))
        cols["span"].append(sum(int(aln.t_end[a] - aln.t_start[a])
                                for _, a in hits))
    return LongAln(
        read_id=np.array(cols["read_id"], np.int32),
        ctg=np.array(cols["ctg"], np.int32),
        strand=np.array(cols["strand"], np.int8),
        t_start=np.array(cols["t_start"], np.int64),
        t_end=np.array(cols["t_end"], np.int64),
        q_len=np.array(cols["q_len"], np.int32),
        dist=np.array(cols["dist"], np.int32),
        span=np.array(cols["span"], np.int32))


def _bucket(n: int, minimum: int = 256) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


def _q_bucket(n: int) -> int:
    """Query bucket: pow2 from 256."""
    return _bucket(n)


def _gather_rows(pool: np.ndarray, src: np.ndarray, lens: np.ndarray,
                 P: int, width: int) -> np.ndarray:
    """Pack P variable-length pool slices into a PAD-padded (P, width)
    batch with one vectorized gather (replaces the per-pair fill loops
    that dominated host time at 10 Mb — VERDICT r3 next #1).

    src[i]: pool start of row i; lens[i]: its true length (<= width).
    """
    out = np.full((P, width), PAD, np.int8)
    lens = lens.astype(np.int64)
    total = int(lens.sum())
    if total == 0:
        return out
    rows = np.repeat(np.arange(P, dtype=np.int64), lens)
    cum = np.cumsum(lens) - lens
    cols = np.arange(total, dtype=np.int64) - np.repeat(cum, lens)
    out[rows, cols] = pool[np.repeat(src.astype(np.int64), lens) + cols]
    return out


def _q_bucket_vec(n: np.ndarray) -> np.ndarray:
    """Vectorized _q_bucket over an int array (identical ladder)."""
    n = np.maximum(np.asarray(n, np.int64), 1)
    out = np.full(n.shape, 256, np.int64)
    while (n > out).any():
        out = np.where(n > out, out * 2, out)
    return out


def _t_bucket(t_len: int, bq: int, step: int = 0) -> int:
    """Smallest bq + step*j (j >= 1) covering t_len: the target bucket
    follows the query bucket so each query bucket compiles ONE kernel
    shape instead of a grid of (bq, bt) combinations.  The step scales
    with the query bucket (bq/8, floor 512) so long-target windows
    (haplotig placement on a full contig) stay on a sparse ladder."""
    if step == 0:
        step = max(512, bq // 8)
    return bq + step * max(1, -(-max(t_len - bq, 1) // step))
