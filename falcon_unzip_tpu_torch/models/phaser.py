"""Per-contig het-SNP calling + read phasing stage on a torch device.

Port of ``falcon_unzip_tpu.models.phaser``: pileup, het predicate,
banded association and block-vote matmuls as torch ops on an explicit
``device``; the greedy block linking stays the reference's host oracle
(``oracle.phasing.phase_blocks``).  The host helpers (bucketing, tag
flattening, grouping, sparse votes, ``phased_reads_table``) are verbatim
copies.

Output mirrors the reference's ``phased_reads`` records:
(read_id, ctg, block, phase).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve
from ..ops.association import (assign_reads, association_band_batch,
                               read_block_votes_batch)
from ..ops.pileup import (allele_matrix_scatter_batch, het_call_host,
                          pileup_het_batch, pileup_host)
from ..oracle.phasing import PhasingConfig, phase_blocks
from .aligner import AlnSet


def _t(x, dev) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)).to(dev)


def _bucket(n: int, floor: int) -> int:
    """Smallest ladder size >= n from {p2, 1.5*p2} (waste <= 33%).

    Every device op in this stage jits on its static shapes; without
    bucketing each contig's unique (t_len, n_tags, n_sites, n_reads,
    n_blocks) tuple forced a fresh XLA compile — at 300kb/6 contigs the
    phasing stage spent 83 of its 83s compiling.  The ladder collapses
    the shape space so programs are reused across contigs AND across
    runs (persistent compile cache).  Padding is inert: pos=-1 tags are
    dropped by the scatters, zero count-rows fail the het predicate
    (filtered on host regardless), and zero M rows/cols contribute
    nothing to association scores or block votes.
    """
    b = floor
    while b < n:
        if b + (b >> 1) >= n:
            return b + (b >> 1)
        b <<= 1
    return b


@dataclasses.dataclass
class ContigPhasing:
    ctg: int
    het_pos: np.ndarray       # (S,) int64 contig positions of het SNPs
    b1: np.ndarray            # (S,) int8 top allele
    b2: np.ndarray            # (S,) int8 second allele
    block_id: np.ndarray      # (S,) int64, -1 = unblocked
    orient: np.ndarray        # (S,) int8
    read_ids: np.ndarray      # (R,) int32 reads aligned to this contig
    r_block: np.ndarray       # (R,) int64, -1 = unphased
    r_phase: np.ndarray       # (R,) int8, -1 = unphased
    counts: np.ndarray        # (t_len, 5) pileup


def flat_delta0_tags(aln: AlnSet, rec_idx: np.ndarray):
    """Concatenate delta-0 tags of the given aln records into flat arrays.

    Returns (row, pos, base): row indexes into rec_idx order.  One
    concatenation + one vectorized delta mask for the whole record set
    (this feeds every pileup; a per-record mask loop dominated host time
    at >100kb scale).
    """
    tags_l = [aln.tags[a] for a in rec_idx]
    lens = np.array([0 if t is None else len(t) for t in tags_l], np.int64)
    if lens.sum() == 0:
        z = np.zeros(0, np.int32)
        return z, z, z
    cat = np.concatenate([t for t in tags_l if t is not None and len(t)])
    rows = np.repeat(np.arange(len(rec_idx), dtype=np.int32), lens)
    d0 = cat[:, 1] == 0
    return (rows[d0], cat[d0, 0].astype(np.int32),
            cat[d0, 2].astype(np.int32))


def phase_contig_device(aln: AlnSet, ctg: int, t_len: int,
                        cfg: PhasingConfig | None = None,
                        device=None, phase_ops=None) -> ContigPhasing:
    """Run the full phasing stage for one contig with device ops.

    The ops are the batched ones with a contig axis of 1 (per-contig
    slices of the batched ops are bit-identical to the single-contig
    ones of the reference).  phase_ops: optional
    ``parallel.sharding.ShardedPhaseOps`` — routes the pileup +
    association through mesh-sharded collectives (bit-identical integer
    semantics); None = the single-device ops on ``device``.
    """
    cfg = cfg or PhasingConfig()
    dev = resolve(device)
    rec_idx = np.nonzero(aln.ctg == ctg)[0]
    read_ids = aln.read_id[rec_idx]
    row, pos, base = flat_delta0_tags(aln, rec_idx)

    Tb = _bucket(t_len, 4096)
    Nb = _bucket(len(pos), 8192)
    pos_b = np.full((1, Nb), -1, np.int32)
    pos_b[0, : len(pos)] = pos
    base_b = np.zeros((1, Nb), np.int32)
    base_b[0, : len(base)] = base
    row_b = np.zeros((1, Nb), np.int32)
    row_b[0, : len(row)] = row

    het_kw = dict(min_depth=cfg.min_depth,
                  min_allele_count=cfg.min_allele_count,
                  allele_freq_min=cfg.allele_freq_min,
                  biallelic_frac=cfg.biallelic_frac)
    if phase_ops is not None:
        # rows beyond t_len are zero, so the full (Tb, 5) counts feed the
        # het call directly; only the stored counts field is sliced
        cpad = phase_ops.pileup(pos_b[0], base_b[0], t_len=Tb)
        is_het, b1_all, b2_all = het_call_host(cpad, **het_kw)
    else:
        is_het, b1_all, b2_all, cp = pileup_het_batch(
            _t(pos_b, dev), _t(base_b, dev), t_len=Tb, with_counts=True,
            **het_kw)
        cpad = cp[0].cpu().numpy()
        is_het, b1_all, b2_all = (x[0].cpu().numpy()
                                  for x in (is_het, b1_all, b2_all))
    counts = cpad[:t_len]
    het_pos = np.nonzero(is_het[:t_len])[0].astype(np.int64)
    b1 = b1_all[het_pos]
    b2 = b2_all[het_pos]
    S = len(het_pos)
    R = len(rec_idx)
    if S == 0 or R == 0:
        return ContigPhasing(
            ctg=ctg, het_pos=het_pos, b1=b1, b2=b2,
            block_id=np.full(S, -1, np.int64),
            orient=np.zeros(S, np.int8),
            read_ids=read_ids,
            r_block=np.full(R, -1, np.int64),
            r_phase=np.full(R, -1, np.int8),
            counts=counts)

    Sb = _bucket(S, 256)
    Rb = _bucket(R, 256)
    pos_to_site = np.full((1, Tb), -1, np.int32)
    pos_to_site[0, het_pos] = np.arange(S, dtype=np.int32)
    b1_b = np.full((1, Sb), -9, np.int32)   # sentinel: matches no base code
    b1_b[0, :S] = b1
    b2_b = np.full((1, Sb), -9, np.int32)
    b2_b[0, :S] = b2
    M = allele_matrix_scatter_batch(
        _t(row_b, dev), _t(pos_b, dev), _t(base_b, dev),
        _t(pos_to_site, dev), _t(b1_b, dev), _t(b2_b, dev),
        n_reads=Rb, n_sites=Sb, t_len=Tb)
    if phase_ops is not None:
        score, cov = phase_ops.association(M[0].cpu().numpy(),
                                           max_span=cfg.max_span)
    else:
        score, cov = (x[0].cpu().numpy() for x in association_band_batch(
            M, max_span=cfg.max_span))
    block_id, orient = phase_blocks(score[:S], cov[:S], S, cfg)

    n_blocks = int(block_id.max()) + 1 if S else 0
    if n_blocks == 0:
        r_block = np.full(R, -1, np.int64)
        r_phase = np.full(R, -1, np.int8)
    else:
        onehot = np.zeros((1, Sb, _bucket(n_blocks, 16)), np.int8)
        sel = block_id >= 0
        onehot[0, np.nonzero(sel)[0], block_id[sel]] = 1
        sgn = np.ones((1, Sb), np.int32)
        sgn[0, :S] = 1 - 2 * orient.astype(np.int32)
        votes, covs = read_block_votes_batch(M, _t(onehot, dev),
                                             _t(sgn, dev))
        r_block, r_phase = assign_reads(
            votes[0].cpu().numpy()[:R, :n_blocks],
            covs[0].cpu().numpy()[:R, :n_blocks])

    return ContigPhasing(
        ctg=ctg, het_pos=het_pos, b1=b1, b2=b2,
        block_id=block_id, orient=orient,
        read_ids=read_ids, r_block=r_block, r_phase=r_phase,
        counts=counts)


def phased_reads_table(ph: ContigPhasing) -> np.ndarray:
    """(R, 4) int64 table: read_id, ctg, block, phase (-1 = unphased).

    Role parity: the per-contig ``phased_reads`` output file of
    [U] falcon_unzip phasing (SURVEY.md §3.2 output)."""
    return np.stack([
        ph.read_ids.astype(np.int64),
        np.full(len(ph.read_ids), ph.ctg, np.int64),
        ph.r_block,
        ph.r_phase.astype(np.int64),
    ], axis=1)


# ---- batched multi-contig phasing --------------------------------------
#
# The batched driver groups contigs by shape bucket, stacks them on a
# leading group axis, and runs each pipeline step as a handful of batched
# device ops.  Per-contig results are bit-identical to
# phase_contig_device (integer scatter/sum semantics are order-free;
# padding rows are inert).


def _g_ladder(n: int, cap: int) -> int:
    """Group-axis bucket: pow2 >= n, capped (one compile per size)."""
    g = 1
    while g < n and g < cap:
        g *= 2
    return min(g, cap)


def _prep_contig(aln: AlnSet, ci: int, t_len: int) -> dict:
    rec_idx = np.nonzero(aln.ctg == ci)[0]
    row, pos, base = flat_delta0_tags(aln, rec_idx)
    return {
        "ci": ci, "t_len": t_len, "rec_idx": rec_idx,
        "read_ids": aln.read_id[rec_idx], "row": row, "pos": pos,
        "base": base, "Tb": _bucket(t_len, 4096),
        "Nb": _bucket(len(pos), 8192),
    }


def _group_chunks(keys: list[tuple], per_bytes, cap_bytes: int):
    """Yield (chunk_of_indices, Gb) with Gb on a pow2 ladder, grouped by
    identical bucket keys and capped so one dispatch stays under
    cap_bytes of device temporaries."""
    groups: dict[tuple, list[int]] = {}
    for k, key in enumerate(keys):
        groups.setdefault(key, []).append(k)
    for key, idxs in sorted(groups.items()):
        cap = max(1, min(64, int(cap_bytes // max(per_bytes(key), 1))))
        Gb = _g_ladder(len(idxs), cap)
        for s in range(0, len(idxs), Gb):
            yield idxs[s : s + Gb], Gb


def _batched_pileup_het(prep: list[dict], cfg: PhasingConfig, dev,
                        cap_bytes: int = 1 << 30,
                        host_tag_cap: int = 0) -> None:
    """Fill per-contig het_pos/b1/b2.

    Default: HOST pileup + het predicate (``pileup_host`` /
    ``het_call_host``, bit-identical to the device ops).  The raw tag
    arrays live on the host and outweigh the (t_len, 5) counts ~100x, so
    counting them where they are beats copying them.  Contigs with at
    most host_tag_cap tags use the grouped device batch (tests set it
    high)."""
    keys, devk = [], []
    for k, p in enumerate(prep):
        if len(p["pos"]) > host_tag_cap or not len(p["pos"]):
            counts = pileup_host(p["pos"], p["base"], p["t_len"])
            is_het, b1a, b2a = het_call_host(
                counts, min_depth=cfg.min_depth,
                min_allele_count=cfg.min_allele_count,
                allele_freq_min=cfg.allele_freq_min,
                biallelic_frac=cfg.biallelic_frac)
            het = np.nonzero(is_het)[0].astype(np.int64)
            p["het_pos"] = het
            p["b1"] = b1a[het]
            p["b2"] = b2a[het]
        else:
            devk.append(k)
            keys.append((p["Tb"], p["Nb"]))
    pend = []
    for sub, Gb in _group_chunks(
            keys, lambda k: k[0] * 20 + k[1] * 8, cap_bytes):
        sub = [devk[i] for i in sub]
        Tb, Nb = prep[sub[0]]["Tb"], prep[sub[0]]["Nb"]
        pos_b = np.full((Gb, Nb), -1, np.int32)
        base_b = np.zeros((Gb, Nb), np.int32)
        for gi, k in enumerate(sub):
            p = prep[k]
            pos_b[gi, : len(p["pos"])] = p["pos"]
            base_b[gi, : len(p["base"])] = p["base"]
        h = pileup_het_batch(
            _t(pos_b, dev), _t(base_b, dev), t_len=Tb,
            min_depth=cfg.min_depth,
            min_allele_count=cfg.min_allele_count,
            allele_freq_min=cfg.allele_freq_min,
            biallelic_frac=cfg.biallelic_frac)
        pend.append((sub, h))
    for sub, (is_het, b1a, b2a) in pend:
        is_het = is_het.cpu().numpy()
        b1a = b1a.cpu().numpy()
        b2a = b2a.cpu().numpy()
        for gi, k in enumerate(sub):
            p = prep[k]
            het = np.nonzero(is_het[gi][: p["t_len"]])[0].astype(np.int64)
            p["het_pos"] = het
            p["b1"] = b1a[gi][het]
            p["b2"] = b2a[gi][het]


def _het_filter_tags(p: dict):
    """(row, pos, base) restricted to het-site positions.

    Only het-site tags contribute to the allele matrix / association /
    votes, and they are ~1%% of all tags — filtering before upload cuts
    the association stage's transfer and scatter sizes ~100x."""
    t_len = p["t_len"]
    het_mask = np.zeros(t_len, bool)
    het_mask[p["het_pos"]] = True
    pos = p["pos"]
    sel = (pos >= 0) & (pos < t_len)
    sel &= het_mask[np.clip(pos, 0, t_len - 1)]
    return p["row"][sel], pos[sel], p["base"][sel]


def _sparse_block_votes(p: dict, cfg: PhasingConfig, n_blocks: int):
    """Host per-record block votes from flat het tags (long contigs).

    Semantics == assign_reads(read_block_votes(M, onehot, sgn)) — the
    dense (records x blocks) vote matrix of an Mb-contig does not fit,
    but each record observes only a handful of blocks, so the votes are
    summed over unique (record, block) keys and the winner per record
    picked with the same (max cov, ties -> smaller block) rule."""
    R = len(p["rec_idx"])
    r_block = np.full(R, -1, np.int64)
    r_phase = np.full(R, -1, np.int8)
    hrow, hpos, hbase = p["het_tags"]
    if not len(hrow):
        return r_block, r_phase
    p2s = np.full(p["t_len"], -1, np.int64)
    p2s[p["het_pos"]] = np.arange(len(p["het_pos"]))
    site = p2s[hpos]
    blk = p["block_id"][site]
    sel = blk >= 0
    if not sel.any():
        return r_block, r_phase
    row, site, base, blk = hrow[sel], site[sel], hbase[sel], blk[sel]
    sgn = 1 - 2 * p["orient"].astype(np.int32)
    val = np.where(base == p["b1"][site], 1,
                   np.where(base == p["b2"][site], -1, 0)) * sgn[site]
    key = row.astype(np.int64) * n_blocks + blk
    uk, inv = np.unique(key, return_inverse=True)
    votes = np.zeros(len(uk), np.int64)
    covs = np.zeros(len(uk), np.int64)
    np.add.at(votes, inv, val)
    np.add.at(covs, inv, np.abs(val))
    rows_u = uk // n_blocks
    blk_u = uk % n_blocks
    order = np.lexsort((blk_u, -covs, rows_u))
    first = np.unique(rows_u[order], return_index=True)[1]
    win = order[first]
    ok = (covs[win] > 0) & (votes[win] != 0)
    win = win[ok]
    r_block[rows_u[win]] = blk_u[win]
    r_phase[rows_u[win]] = np.where(votes[win] > 0, 0, 1)
    return r_block, r_phase


def phase_contigs_batched(aln: AlnSet, ctg_ids, t_lens,
                          cfg: PhasingConfig | None = None,
                          cap_bytes: int = 1 << 30,
                          s_win: int = 2048, long_s: int = 3072,
                          host_tag_cap: int = 0, device=None
                          ) -> list[ContigPhasing]:
    """Phase many contigs with grouped batched device ops.

    Drop-in for [phase_contig_device(aln, ci, tl, cfg) for ci, tl in
    zip(ctg_ids, t_lens)] with bit-identical outputs (ContigPhasing
    .counts is omitted — no production consumer needs the full pileup).

    Contigs with more than long_s het sites take the LONG path: the
    association runs over overlapping windows of s_win sites (the band
    only pairs sites within max_span, so rows away from a window edge are
    complete and windows stitch exactly), and block votes are summed
    sparsely on the host instead of materializing the (records x sites)
    matrix.
    """
    cfg = cfg or PhasingConfig()
    dev = resolve(device)
    # Exact stitching needs the full association band inside a window;
    # a stride <= 0 would loop forever on the long path.
    if s_win <= cfg.max_span:
        raise ValueError(
            f"phase window s_win={s_win} must exceed "
            f"cfg.max_span={cfg.max_span} for windowed phasing")
    prep = [_prep_contig(aln, int(ci), int(tl))
            for ci, tl in zip(ctg_ids, t_lens)]
    _batched_pileup_het(prep, cfg, dev, cap_bytes, host_tag_cap)

    # ---- association entries: small contig = one entry; long contig =
    # overlapping site windows in template-shifted coordinates
    entries: list[dict] = []
    for k, p in enumerate(prep):
        S = len(p["het_pos"])
        R = len(p["rec_idx"])
        p["long"] = S > long_s
        if S == 0 or R == 0:
            continue
        hrow, hpos, hbase = _het_filter_tags(p)
        p["het_tags"] = (hrow, hpos, hbase)
        if not p["long"]:
            entries.append({
                "k": k, "w_lo": 0, "S_w": S, "final": True,
                "row": hrow, "pos": hpos, "base": hbase,
                "het_local": p["het_pos"], "b1": p["b1"], "b2": p["b2"],
                "Tb": p["Tb"], "R_rows": R})
        else:
            stride = s_win - cfg.max_span  # > 0: guarded at entry
            w_lo = 0
            while True:
                w_hi = min(S, w_lo + s_win)
                span_lo = int(p["het_pos"][w_lo])
                span_hi = int(p["het_pos"][w_hi - 1]) + 1
                wsel = (hpos >= span_lo) & (hpos < span_hi)
                rw = hrow[wsel]
                # rows renumbered densely: association sums over rows,
                # identity is irrelevant within a window
                _, rloc = np.unique(rw, return_inverse=True)
                entries.append({
                    "k": k, "w_lo": w_lo, "S_w": w_hi - w_lo,
                    "final": w_hi >= S,
                    "row": rloc.astype(np.int32),
                    "pos": (hpos[wsel] - span_lo).astype(np.int32),
                    "base": hbase[wsel],
                    "het_local": p["het_pos"][w_lo:w_hi] - span_lo,
                    "b1": p["b1"][w_lo:w_hi], "b2": p["b2"][w_lo:w_hi],
                    "Tb": _bucket(span_hi - span_lo, 4096),
                    "R_rows": int(rloc.max()) + 1 if len(rloc) else 1})
                if w_hi >= S:
                    break
                w_lo += stride
            p["score"] = np.zeros((S, cfg.max_span), np.int32)
            p["cov"] = np.zeros((S, cfg.max_span), np.int32)

    for e in entries:
        e["Nb"] = _bucket(len(e["pos"]), 8192)
        e["Sb"] = _bucket(e["S_w"], 256)
        e["Rb"] = _bucket(e["R_rows"], 256)

    def _assoc_bytes(key):
        Tb, Nb, Sb, Rb = key
        return Rb * Sb * 13 + Tb * 4 + Nb * 12

    pend = []
    ekeys = [(e["Tb"], e["Nb"], e["Sb"], e["Rb"]) for e in entries]
    for sub, Gb in _group_chunks(ekeys, _assoc_bytes, cap_bytes):
        Tb, Nb, Sb, Rb = ekeys[sub[0]]
        pos_b = np.full((Gb, Nb), -1, np.int32)
        base_b = np.zeros((Gb, Nb), np.int32)
        row_b = np.zeros((Gb, Nb), np.int32)
        p2s = np.full((Gb, Tb), -1, np.int32)
        b1_b = np.full((Gb, Sb), -9, np.int32)
        b2_b = np.full((Gb, Sb), -9, np.int32)
        for gi, ei in enumerate(sub):
            e = entries[ei]
            pos_b[gi, : len(e["pos"])] = e["pos"]
            base_b[gi, : len(e["base"])] = e["base"]
            row_b[gi, : len(e["row"])] = e["row"]
            S_w = e["S_w"]
            p2s[gi][e["het_local"]] = np.arange(S_w, dtype=np.int32)
            b1_b[gi, :S_w] = e["b1"]
            b2_b[gi, :S_w] = e["b2"]
        M = allele_matrix_scatter_batch(
            _t(row_b, dev), _t(pos_b, dev), _t(base_b, dev),
            _t(p2s, dev), _t(b1_b, dev), _t(b2_b, dev),
            n_reads=Rb, n_sites=Sb, t_len=Tb)
        sc = association_band_batch(M, max_span=cfg.max_span)
        pend.append((sub, M, sc))

    # ---- host: assemble score/cov; phase blocks per contig ----------
    small_groups = []           # (sub_small, M, per_ctg rows) for votes
    for sub, M, (score, cov) in pend:
        score = score.cpu().numpy()
        cov = cov.cpu().numpy()
        small = []
        for gi, ei in enumerate(sub):
            e = entries[ei]
            p = prep[e["k"]]
            S_w = e["S_w"]
            if not p["long"]:
                p["score"] = score[gi][:S_w]
                p["cov"] = cov[gi][:S_w]
                small.append((gi, e["k"]))
            else:
                # non-final windows contribute their band-complete rows
                # [w_lo, w_lo + S_w - max_span); the final window all
                take = S_w if e["final"] else S_w - cfg.max_span
                w_lo = e["w_lo"]
                p["score"][w_lo : w_lo + take] = score[gi][:take]
                p["cov"][w_lo : w_lo + take] = cov[gi][:take]
        if small:
            small_groups.append((small, M, score.shape[0]))

    for p in prep:
        S = len(p.get("het_pos", ()))
        if S and "score" in p:
            p["block_id"], p["orient"] = phase_blocks(
                p["score"], p["cov"], S, cfg)
            p["n_blocks"] = int(p["block_id"].max()) + 1

    # ---- votes: device matmul for small contigs, host sparse for long
    votes_pend = []
    for small, M, Gb in small_groups:
        Sb = M.shape[2]
        max_blocks = max((prep[k].get("n_blocks", 0)
                          for _gi, k in small), default=0)
        Bb = _bucket(max(max_blocks, 1), 16)
        onehot = np.zeros((Gb, Sb, Bb), np.int8)
        sgn = np.ones((Gb, Sb), np.int32)
        for gi, k in small:
            p = prep[k]
            S = len(p["het_pos"])
            sel = p["block_id"] >= 0
            onehot[gi][np.nonzero(sel)[0], p["block_id"][sel]] = 1
            sgn[gi, :S] = 1 - 2 * p["orient"].astype(np.int32)
        v = read_block_votes_batch(M, _t(onehot, dev), _t(sgn, dev))
        votes_pend.append((small, v))
    for small, (votes, covs) in votes_pend:
        votes = votes.cpu().numpy()
        covs = covs.cpu().numpy()
        for gi, k in small:
            p = prep[k]
            R = len(p["rec_idx"])
            nb = p.get("n_blocks", 0)
            if nb <= 0:
                continue
            p["r_block"], p["r_phase"] = assign_reads(
                votes[gi][:R, :nb], covs[gi][:R, :nb])
    for p in prep:
        if p.get("long") and p.get("n_blocks", 0) > 0:
            p["r_block"], p["r_phase"] = _sparse_block_votes(
                p, cfg, p["n_blocks"])

    out = []
    for p in prep:
        S = len(p.get("het_pos", ()))
        R = len(p["rec_idx"])
        out.append(ContigPhasing(
            ctg=p["ci"], het_pos=p["het_pos"], b1=p["b1"], b2=p["b2"],
            block_id=p.get("block_id", np.full(S, -1, np.int64)),
            orient=p.get("orient", np.zeros(S, np.int8)),
            read_ids=p["read_ids"],
            r_block=p.get("r_block", np.full(R, -1, np.int64)),
            r_phase=p.get("r_phase", np.full(R, -1, np.int8)),
            counts=None))
    return out


def template_route_votes(aln: AlnSet, ctg_ids, t_lens, templates,
                         cfg: PhasingConfig | None = None,
                         cap_bytes: int = 1 << 30, device=None):
    """Per-record template-agreement votes for the quiver phase routing.

    For each contig: call het sites from the record pileup (grouped
    batched device programs), then score every record +1/-1 per het
    site where it carries the template's own allele / the opposite
    allele.  Records with a NEGATIVE vote oppose the template's
    haplotype and should be dropped; 0 (spans no usable het site)
    keeps.  Role parity: [U] quiver consumes the tracked phase map
    instead of re-running full phasing (SURVEY.md §3.4 step 1) — this
    replaces the full phase_contig_device re-phasing that was the
    4th-largest wall-clock item at 10 Mb (VERDICT r3 weak #7).

    The vote itself is one vectorized host pass over the ~1% of tags
    that sit on het sites — after the het call there is nothing left
    worth shipping to the device.

    Returns a list of (rec_idx, votes, het_pos) per contig, aligned
    with ctg_ids.  device: the torch device of the grouped het call
    (None: the enclosing ``device.scope``).
    """
    cfg = cfg or PhasingConfig()
    dev = resolve(device)
    prep = [_prep_contig(aln, int(ci), int(tl))
            for ci, tl in zip(ctg_ids, t_lens)]
    _batched_pileup_het(prep, cfg, dev, cap_bytes)
    out = []
    for p, tpl in zip(prep, templates):
        R = len(p["rec_idx"])
        votes = np.zeros(R, np.int64)
        het = p["het_pos"]
        if len(het) and R:
            tb = np.asarray(tpl)[het].astype(np.int32)
            is1 = tb == p["b1"]
            is2 = tb == p["b2"]
            tmpl_a = np.where(is1 | is2, tb, -9)
            other_a = np.where(is1, p["b2"],
                               np.where(is2, p["b1"], -9)).astype(np.int32)
            hrow, hpos, hbase = _het_filter_tags(p)
            p2s = np.full(p["t_len"], -1, np.int64)
            p2s[het] = np.arange(len(het))
            site = p2s[hpos]
            val = np.where(hbase == tmpl_a[site], 1,
                           np.where(hbase == other_a[site], -1, 0))
            np.add.at(votes, hrow, val)
        out.append((p["rec_idx"], votes, p["het_pos"]))
    return out
