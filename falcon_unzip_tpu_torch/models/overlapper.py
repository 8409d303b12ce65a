"""All-vs-all pread overlapper (the DALIGNER/LA4Falcon role) on a torch
device.

Port of ``falcon_unzip_tpu.models.overlapper``.  Candidates come from the
reference's k-mer index + diagonal chaining (host numpy); each candidate
is verified by the banded DP in summary mode on the overlapper's
``device``: the traceback is reduced on the device to 7 ints per pair and
each drain window comes back in one copy.  ``OverlapSet`` and
``OverlapperConfig`` are verbatim copies.

Overlap record convention (falcon/m4-style, b-coords on b's FORWARD
strand never flipped; ``strand``=1 means b was reverse-complemented for
the match):
  a_start/a_end : matched window on a (forward)
  b_start/b_end : matched window on b as used in the match orientation
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np

from ..device import resolve
from ..ops.banded_align import BandedAligner
from ..ops.kmer_index import KmerIndex, chain_best_per_pair, query_flat
from ..seq import PAD, SeqBatch, revcomp


@dataclasses.dataclass
class OverlapSet:
    a_id: np.ndarray      # (O,) int32
    b_id: np.ndarray      # (O,) int32
    strand: np.ndarray    # (O,) int8  0: b fwd, 1: b rc
    a_start: np.ndarray   # (O,) int32 on a forward
    a_end: np.ndarray     # (O,) int32
    b_start: np.ndarray   # (O,) int32 on b in match orientation
    b_end: np.ndarray     # (O,) int32
    a_len: np.ndarray     # (O,) int32
    b_len: np.ndarray     # (O,) int32
    dist: np.ndarray      # (O,) int32 edit distance of the matched region

    def __len__(self):
        return len(self.a_id)

    def identity(self) -> np.ndarray:
        span = np.maximum(self.a_end - self.a_start, 1)
        return 1.0 - self.dist / span

    _COLS = ("a_id", "b_id", "strand", "a_start", "a_end",
             "b_start", "b_end", "a_len", "b_len", "dist")

    def sort_canonical(self) -> "OverlapSet":
        """Reorder records by (a_id, strand, b_id, a_start): a pure
        function of the record set, so host-sharded candidate batches
        merge to the identical overlap stream (graph construction
        consumes this order — SURVEY.md §2c cluster fan-out row)."""
        order = np.lexsort((self.a_start, self.b_id, self.strand,
                            self.a_id))
        return OverlapSet(**{k: getattr(self, k)[order]
                             for k in self._COLS})

    def to_bytes(self) -> bytes:
        from ..parallel.distributed import pack_arrays
        return pack_arrays({k: getattr(self, k) for k in self._COLS})

    @staticmethod
    def from_bytes(blob: bytes) -> "OverlapSet":
        from ..parallel.distributed import unpack_arrays
        return OverlapSet(**unpack_arrays(blob))

    @staticmethod
    def merge(parts: list["OverlapSet"]) -> "OverlapSet":
        return OverlapSet(**{
            k: np.concatenate([getattr(p, k) for p in parts])
            for k in OverlapSet._COLS}).sort_canonical()


@dataclasses.dataclass
class OverlapperConfig:
    k: int = 13
    max_hits: int = 128
    band: int = 256
    min_anchors: int = 4
    min_span: int = 100         # min q-spread of a candidate's anchors
                                # (kills single-accidental-match junk
                                # pairs — see kmer_index.chain_best_per_pair)
    min_overlap: int = 500      # minimum overlap length
    min_identity: float = 0.70
    end_fuzz: int = 60          # tolerance for dovetail/containment calls
    batch_pairs: int = 256


class PreadOverlapper:
    """Compute all proper overlaps among a batch of preads.

    device: the torch device of the DP (None: the enclosing
    ``device.scope``)."""

    def __init__(self, reads: SeqBatch, cfg: OverlapperConfig | None = None,
                 device=None):
        self.cfg = cfg or OverlapperConfig()
        self.device = resolve(device)
        self.reads = reads
        self.seqs = [reads.row(i) for i in range(len(reads))]
        self.lengths = np.array([len(s) for s in self.seqs], np.int64)
        self.index = KmerIndex.build(self.seqs, k=self.cfg.k,
                                     max_hits=self.cfg.max_hits)
        self._pools = None
        self.timings: dict = {}

    def _seq_pools(self):
        """(offs, fwd, rc): flat forward + revcomp pools over all preads.

        Batch packing gathers query/target slices straight out of these
        with one fancy index per chunk — the per-pair Python fill loop
        they replace was a measured top term of the 10 Mb overlap stage
        (VERDICT r3 next #1)."""
        if self._pools is None:
            offs = np.zeros(len(self.seqs) + 1, np.int64)
            np.cumsum(self.lengths, out=offs[1:])
            fwd = (np.concatenate(self.seqs) if self.seqs
                   else np.zeros(0, np.int8))
            rc = (np.concatenate([revcomp(s) for s in self.seqs])
                  if self.seqs else np.zeros(0, np.int8))
            self._pools = (offs, fwd, rc)
        return self._pools

    def _candidates(self, a_range: tuple[int, int] | None = None):
        """Seed/chain candidate overlap placements (a_id < b_id only; the
        symmetric record is derived, not recomputed).

        a_range: optional [lo, hi) slice of a-read ids to seed from — the
        host-shard hook (each unordered pair is generated from its smaller
        id, so sharding the a axis partitions the candidate set exactly).

        Returns columnar (a, b, strand, diag) int64/int8 arrays ordered
        by (a, strand, b) — the same stream the per-read formulation
        produced, without per-candidate Python objects.
        """
        cfg = self.cfg
        n = len(self.seqs)
        a_lo, a_hi = a_range if a_range is not None else (0, n)
        offs, fwd, rc = self._seq_pools()
        fwd_rows = [fwd[offs[i]:offs[i + 1]] for i in range(n)]
        rc_rows = [rc[offs[i]:offs[i + 1]] for i in range(n)]
        cols = {"a": [], "b": [], "s": [], "d": []}
        # pair keys must stay < 2^31 inside chain_best_per_pair; beyond
        # that, small blocks keep the anchor temporaries cache-resident
        # (measured: 64-read blocks beat both per-read and full-batch)
        block = max(1, min(n, 64, (1 << 31) // max(n, 1) - 1))

        def _one(strand: int, a0: int):
            rows = fwd_rows if strand == 0 else rc_rows
            rid, q_pos, t_pos, t_ctg = query_flat(
                self.index, rows[a0 : min(a0 + block, a_hi)])
            a_glob = rid.astype(np.int64) + a0
            # each unordered pair is chained once, from the smaller
            # id (self anchors drop with it; self-rc also skipped)
            keep = t_ctg > a_glob
            # best placement per (read, partner) pair, one numpy pass
            # (t_lo is the exact minimum anchor diagonal, NOT the
            # quantized bin start — quantization here shifts the DP
            # window and corrupts overlap ends)
            a_l, bs, t_los = chain_best_per_pair(
                rid[keep], q_pos[keep], t_pos[keep], t_ctg[keep],
                n_targets=n, min_anchors=cfg.min_anchors,
                min_span=cfg.min_span)
            return (np.asarray(a_l, np.int64) + a0,
                    np.asarray(bs, np.int64),
                    np.full(len(a_l), strand, np.int8),
                    np.asarray(t_los, np.int64))

        # (strand, block) passes are independent; the thread pool
        # overlaps the np.unique sorts across host cores and task-order
        # appends keep the stream byte-identical to the serial loop
        from ..ops.kmer_index import thread_map
        tasks = [(strand, a0) for strand in (0, 1)
                 for a0 in range(a_lo, a_hi, block)]
        for a_l, bs, st, t_los in thread_map(_one, tasks):
            cols["a"].append(a_l)
            cols["b"].append(bs)
            cols["s"].append(st)
            cols["d"].append(t_los)
        a = (np.concatenate(cols["a"]) if cols["a"]
             else np.zeros(0, np.int64))
        b = (np.concatenate(cols["b"]) if cols["b"]
             else np.zeros(0, np.int64))
        s = (np.concatenate(cols["s"]) if cols["s"]
             else np.zeros(0, np.int8))
        d = (np.concatenate(cols["d"]) if cols["d"]
             else np.zeros(0, np.int64))
        # deterministic order matching the per-read formulation: a, then
        # strand, then partner (graph construction consumes this order)
        order = np.lexsort((b, s, a))
        return a[order], b[order], s[order], d[order]

    def compute(self, a_range: tuple[int, int] | None = None) -> OverlapSet:
        """Verify candidates with banded DP and emit overlap records.

        For a candidate with diagonal D (approx b_pos - a_pos in match
        orientation): the overlapping window is a[max(0,D'):...] vs
        b[max(0,-D'):...]; the query window is aligned onto the target
        window with free target ends (tglocal).

        a_range host-shards the candidate set (see _candidates).
        Candidate windows, batch packing (flat-pool gathers) and record
        emission are whole-array numpy passes.  Stage wall-clocks land in
        ``self.timings``.
        """
        import time as _time
        cfg = self.cfg
        tm: dict = {}
        _t0 = _time.perf_counter()
        a, b, strand, diag = self._candidates(a_range)
        tm["cand_s"] = round(_time.perf_counter() - _t0, 2)
        _t0 = _time.perf_counter()
        aligner = BandedAligner(W=cfg.band, mode="tglocal",
                                device=self.device)

        # ---- candidate windows (vectorized) --------------------------
        la = self.lengths[a] if len(a) else np.zeros(0, np.int64)
        lb = self.lengths[b] if len(b) else np.zeros(0, np.int64)
        a_lo = np.maximum(0, -diag)
        b_lo = np.maximum(0, diag)
        ov = np.minimum(la - a_lo, lb - b_lo)
        keep = ov >= cfg.min_overlap
        a, b, strand, a_lo, b_lo, ov, lb = (
            x[keep] for x in (a, b, strand, a_lo, b_lo, ov, lb))
        pad = cfg.band // 4
        t_lo = np.maximum(0, b_lo - pad)
        t_hi = np.minimum(lb, b_lo + ov + pad)
        t_len = t_hi - t_lo
        nj = len(a)
        if nj == 0:
            # a host shard can legitimately see zero candidates
            z32 = np.zeros(0, np.int32)
            tm.update(pack_s=0.0, dispatch_s=0.0, fetch_s=0.0,
                      emit_s=0.0, n_cands=0, n_overlaps=0)
            self.timings = tm
            return OverlapSet(
                a_id=z32, b_id=z32, strand=np.zeros(0, np.int8),
                a_start=z32, a_end=z32, b_start=z32, b_end=z32,
                a_len=z32, b_len=z32, dist=z32)

        # ---- shape buckets (vectorized ladder, == scalar _q_bucket) --
        from .aligner import _gather_rows, _q_bucket_vec
        bq = _q_bucket_vec(ov)
        bt = bq + 512 * np.maximum(
            1, -(-np.maximum(t_len - bq, 1) // 512))      # _t_bucket
        # job order within a bucket follows candidate order (stable sort)
        key = bq * (1 << 32) + bt
        order = np.argsort(key, kind="stable")

        # source offsets into the flat pools: q from fwd[a], t from
        # fwd[b] or rc[b] depending on strand (rc rows live at
        # pool_off + offs[b] in the stacked pool)
        offs, fwd, rc = self._seq_pools()
        pool = np.concatenate([fwd, rc])
        q_src = offs[a] + a_lo
        t_src = offs[b] + t_lo + np.where(strand == 1, len(fwd), 0)

        # ---- chunked dispatch with vectorized packing ----------------
        # In-flight chunks hold their device buffers alive until
        # collected; a bounded window keeps dispatch and collection
        # overlapped while capping that memory; each drain is one copy.
        max_inflight = int(os.environ.get(
            "FALCON_UNZIP_TPU_MAX_INFLIGHT", "1024"))
        pending = []  # (idx, n_real, handle)
        meta = []     # (idx, n_real) in dispatch order, across drains
        parts = []    # per-drain summary dicts
        tm["pack_s"] = 0.0
        tm["dispatch_s"] = 0.0
        tm["fetch_s"] = 0.0

        def _drain():
            if not pending:
                return
            _td = _time.perf_counter()
            parts.append(aligner.collect_summaries(
                [h for _, _, h in pending]))
            tm["fetch_s"] += _time.perf_counter() - _td
            meta.extend((idx, n) for idx, n, _ in pending)
            pending.clear()

        bounds = np.nonzero(np.diff(key[order]))[0] + 1
        chunk_pairs = cfg.batch_pairs
        for grp in np.split(order, bounds):
            if not len(grp):      # nj == 0: np.split yields one empty group
                continue
            gbq, gbt = int(bq[grp[0]]), int(bt[grp[0]])
            for s in range(0, len(grp), chunk_pairs):
                idx = grp[s : s + chunk_pairs]
                n_real = len(idx)
                if n_real < chunk_pairs and s > 0:
                    # pad the tail chunk to the full batch (repeat last
                    # job, results discarded), as the reference does
                    idx = np.concatenate(
                        [idx, np.full(chunk_pairs - n_real, idx[-1])])
                P = len(idx)
                _tp = _time.perf_counter()
                qa = _gather_rows(pool, q_src[idx], ov[idx], P, gbq)
                ta = _gather_rows(pool, t_src[idx], t_len[idx], P, gbt)
                tm["pack_s"] += _time.perf_counter() - _tp
                _tp = _time.perf_counter()
                pending.append((idx, n_real, aligner.dispatch(
                    qa, ta, ov[idx].astype(np.int32),
                    t_len[idx].astype(np.int32), want_moves="summary")))
                tm["dispatch_s"] += _time.perf_counter() - _tp
                if len(pending) >= max_inflight:
                    _drain()
        _drain()
        tm["fetch_s"] = round(tm["fetch_s"], 2)
        allres = ({k: np.concatenate([p[k] for p in parts])
                   for k in parts[0]} if len(parts) > 1 else parts[0])

        # ---- vectorized record emission ------------------------------
        _t0 = _time.perf_counter()
        live_l, rows_l = [], []
        r0 = 0
        for idx, n in meta:                 # rows: chunk-padded layout
            live_l.append(idx[:n])
            rows_l.append(np.arange(r0, r0 + n))
            r0 += len(idx)
        live = (np.concatenate(live_l) if live_l
                else np.zeros(0, np.int64))
        rows = (np.concatenate(rows_l) if rows_l
                else np.zeros(0, np.int64))
        dist = allres["dist"][rows].astype(np.int64)
        end_j = allres["end_j"][rows].astype(np.int64)
        start_j = end_j - allres["n_t"][rows]
        # trim query insertions hanging off the target's ends (the q
        # window may overshoot the true overlap): leading ups advance
        # a_start, trailing ups retract a_end
        lead = allres["lead"][rows].astype(np.int64)
        trail = np.maximum(0, np.minimum(
            allres["trail"][rows], allres["n_up"][rows] - lead))
        a_s = a_lo[live] + lead
        a_e = a_lo[live] + ov[live] - trail
        dist = dist - lead - trail
        span = a_e - a_s
        ok = ((allres["dist"][rows] < (1 << 20))
              & (span >= cfg.min_overlap)
              & (1.0 - dist / np.maximum(span, 1) >= cfg.min_identity))
        sel = live[ok]
        out = OverlapSet(
            a_id=a[sel].astype(np.int32), b_id=b[sel].astype(np.int32),
            strand=strand[sel].astype(np.int8),
            a_start=a_s[ok].astype(np.int32),
            a_end=a_e[ok].astype(np.int32),
            b_start=(t_lo[sel] + start_j[ok]).astype(np.int32),
            b_end=(t_lo[sel] + end_j[ok]).astype(np.int32),
            a_len=self.lengths[a[sel]].astype(np.int32),
            b_len=self.lengths[b[sel]].astype(np.int32),
            dist=dist[ok].astype(np.int32)).sort_canonical()
        tm["emit_s"] = round(_time.perf_counter() - _t0, 2)
        tm["pack_s"] = round(tm["pack_s"], 2)
        tm["dispatch_s"] = round(tm["dispatch_s"], 2)
        tm["n_cands"] = nj
        tm["n_overlaps"] = len(out)
        self.timings = tm
        return out


def _bucket(n: int, minimum: int = 256) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


def _t_bucket(t_len: int, bq: int, step: int = 512) -> int:
    """See models.aligner._t_bucket: one kernel shape per query bucket."""
    return bq + step * max(1, -(-max(t_len - bq, 1) // step))
