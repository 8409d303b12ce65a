"""Numpy oracle for het-SNP calling + read phasing.

Role parity: [U] falcon_unzip/phasing.py — make_het_call (pileup ->
biallelic het sites), generate_association_table (SNP-pair co-occurrence),
get_phased_blocks (greedy block partition), get_phased_reads (per-read
majority vote).  SURVEY.md §3.2 is the behavioral spec; exact symbol names
in the upstream are unverified (mount empty — see SURVEY provenance note).

This oracle defines the deterministic semantics the device ops
(`ops.pileup`, `ops.association`) must reproduce bit-for-bit:

  het site   : depth >= min_depth; top-2 base counts c1 >= c2 (ties ->
               smaller base code); c2 >= max(min_allele_count,
               ceil(allele_freq_min * (c1+c2))); (c1+c2) >= biallelic_frac
               * depth.
  allele obs : M[r, s] = +1 if read base == b1, -1 if == b2, else 0.
  link score : score(s, s') = sum_r M[r,s] * M[r,s'] (cis - trans), for
               site pairs within max_span sites; link kept iff
               |score| >= min_link and 2*|score| > cov_pair.
  blocks     : process kept links in order (-|score|, s, delta); union-find
               with parity (score > 0 -> same orientation); conflicting
               late links are dropped.
  read phase : v(r, B) = sum_{s in B} M[r,s] * (1 - 2*orient[s]); read is
               assigned to the covering block with the most observed sites
               (ties -> smaller block id); phase 0 if v > 0, 1 if v < 0,
               unphased if v == 0.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class PhasingConfig:
    min_depth: int = 10
    min_allele_count: int = 2
    allele_freq_min: float = 0.25
    biallelic_frac: float = 0.8
    max_span: int = 64          # association band: site pairs within this
    min_link: int = 3
    # link kept iff 2*|score| > cov_pair (strict majority of informative
    # read pairs agree)


def pileup_counts(tags_list, read_ids, t_len: int) -> np.ndarray:
    """Delta-0 align tags -> (t_len, 5) base counts (4 = deletion)."""
    counts = np.zeros((t_len, 5), dtype=np.int32)
    for tags in tags_list:
        if tags is None or len(tags) == 0:
            continue
        d0 = tags[(tags[:, 1] == 0)]
        ok = (d0[:, 0] >= 0) & (d0[:, 0] < t_len)
        np.add.at(counts, (d0[ok, 0], d0[ok, 2]), 1)
    return counts


def call_het_sites(counts: np.ndarray, cfg: PhasingConfig):
    """(t_len, 5) counts -> (positions, b1, b2) of het sites."""
    t_len = counts.shape[0]
    pos_out, b1_out, b2_out = [], [], []
    for p in range(t_len):
        depth = int(counts[p].sum())
        if depth < cfg.min_depth:
            continue
        base_counts = counts[p, :4]
        order = np.argsort(-base_counts, kind="stable")  # ties -> smaller code
        b1, b2 = int(order[0]), int(order[1])
        c1, c2 = int(base_counts[b1]), int(base_counts[b2])
        if c2 < max(cfg.min_allele_count,
                    int(np.ceil(cfg.allele_freq_min * (c1 + c2)))):
            continue
        if (c1 + c2) < cfg.biallelic_frac * depth:
            continue
        pos_out.append(p); b1_out.append(b1); b2_out.append(b2)
    return (np.array(pos_out, np.int64), np.array(b1_out, np.int8),
            np.array(b2_out, np.int8))


def allele_matrix(tags_list, het_pos, b1, b2, t_len: int) -> np.ndarray:
    """Per-read allele observations: (n_reads, n_sites) int8 in {-1,0,+1}."""
    n_sites = len(het_pos)
    pos_to_site = np.full(t_len, -1, np.int64)
    pos_to_site[het_pos] = np.arange(n_sites)
    M = np.zeros((len(tags_list), n_sites), dtype=np.int8)
    for r, tags in enumerate(tags_list):
        if tags is None or len(tags) == 0:
            continue
        d0 = tags[tags[:, 1] == 0]
        ok = (d0[:, 0] >= 0) & (d0[:, 0] < t_len)
        d0 = d0[ok]
        site = pos_to_site[d0[:, 0]]
        hit = site >= 0
        s = site[hit]
        base = d0[hit, 2]
        M[r, s] = np.where(base == b1[s], 1,
                           np.where(base == b2[s], -1, 0))
    return M


def association_band(M: np.ndarray, max_span: int):
    """Banded link scores/coverages: (n_sites, max_span) int32 arrays.

    score[s, d] = sum_r M[r,s]*M[r,s+d+1];  cov[s, d] = #reads observing both.
    """
    n_sites = M.shape[1]
    Mi = M.astype(np.int32)
    score = np.zeros((n_sites, max_span), np.int32)
    cov = np.zeros((n_sites, max_span), np.int32)
    for d in range(1, max_span + 1):
        if d >= n_sites:
            break
        prod = Mi[:, : n_sites - d] * Mi[:, d:]
        score[: n_sites - d, d - 1] = prod.sum(axis=0)
        cov[: n_sites - d, d - 1] = np.abs(prod).sum(axis=0)
    return score, cov


class _UnionFindParity:
    """Union-find with relative phase parity to parent."""

    def __init__(self, n: int):
        self.parent = np.arange(n)
        self.parity = np.zeros(n, np.int8)  # parity to parent
        self.rank = np.zeros(n, np.int32)

    def find(self, x: int) -> tuple[int, int]:
        path = []
        while self.parent[x] != x:
            path.append(x)
            x = int(self.parent[x])
        p = 0
        for y in reversed(path):
            p ^= int(self.parity[y])
            self.parent[y] = x
            self.parity[y] = p
        # recompute parity for each path node relative to root
        # (done above: parity[y] accumulated root-ward)
        return x, 0

    def parity_to_root(self, x: int) -> int:
        self.find(x)
        return int(self.parity[x]) if self.parent[x] != x else 0

    def union(self, a: int, b: int, rel: int) -> bool:
        """Link a,b with relative parity rel. False if conflicting."""
        ra, _ = self.find(a)
        rb, _ = self.find(b)
        pa = self.parity_to_root(a)
        pb = self.parity_to_root(b)
        if ra == rb:
            return (pa ^ pb) == rel
        if self.rank[ra] < self.rank[rb]:
            ra, rb = rb, ra
            pa, pb = pb, pa
        # attach rb under ra: parity[rb] = pa ^ pb ^ rel
        self.parent[rb] = ra
        self.parity[rb] = pa ^ pb ^ rel
        if self.rank[ra] == self.rank[rb]:
            self.rank[ra] += 1
        return True


def phase_blocks(score: np.ndarray, cov: np.ndarray, n_sites: int,
                 cfg: PhasingConfig):
    """Greedy block construction. Returns (block_id, orient) per site.

    block_id: -1 for singleton/unlinked sites; otherwise 0..n_blocks-1 in
    order of first site position.  orient[s]: 0 if site's b1 is block hap0.
    """
    # vectorized link collection (same accept rule and same processing
    # order (-|score|, s, d) as the original per-cell Python loop, which
    # was O(n_sites * max_span) interpreter work — ~10 s/Mb-contig)
    sc = np.asarray(score)
    cv = np.asarray(cov)
    s_grid = np.arange(n_sites)[:, None]
    d_grid = np.arange(1, sc.shape[1] + 1)[None, :]
    ok = ((s_grid + d_grid < n_sites)
          & (np.abs(sc[:n_sites]) >= cfg.min_link)
          & (2 * np.abs(sc[:n_sites]) > cv[:n_sites]))
    ls, ld = np.nonzero(ok)
    lsc = sc[ls, ld]
    order = np.lexsort((ld, ls, -np.abs(lsc)))
    uf = _UnionFindParity(n_sites)
    for i in order:
        s, d = int(ls[i]), int(ld[i]) + 1
        uf.union(s, s + d, 0 if lsc[i] > 0 else 1)

    roots = np.array([uf.find(s)[0] for s in range(n_sites)])
    orient = np.array([uf.parity_to_root(s) for s in range(n_sites)],
                      dtype=np.int8)
    block_id = np.full(n_sites, -1, np.int64)
    seen: dict[int, int] = {}
    nxt = 0
    counts = np.bincount(roots, minlength=n_sites)
    for s in range(n_sites):
        r = int(roots[s])
        if counts[r] < 2:
            continue  # singleton: no phase information
        if r not in seen:
            seen[r] = nxt
            nxt += 1
        block_id[s] = seen[r]
    return block_id, orient


def phase_reads(M: np.ndarray, block_id: np.ndarray, orient: np.ndarray):
    """Assign each read (block, phase). Returns (r_block, r_phase) int64/int8;
    r_block=-1 & r_phase=-1 for unphased reads."""
    n_reads, n_sites = M.shape
    n_blocks = int(block_id.max()) + 1 if len(block_id) else 0
    r_block = np.full(n_reads, -1, np.int64)
    r_phase = np.full(n_reads, -1, np.int8)
    if n_blocks == 0:
        return r_block, r_phase
    sgn = (1 - 2 * orient.astype(np.int32))
    for r in range(n_reads):
        m = M[r].astype(np.int32)
        best_cov, best_b, best_v = 0, -1, 0
        for b in range(n_blocks):
            sel = block_id == b
            cv = int(np.abs(m[sel]).sum())
            if cv > best_cov:
                best_cov = cv
                best_b = b
                best_v = int((m[sel] * sgn[sel]).sum())
        if best_b >= 0 and best_v != 0:
            r_block[r] = best_b
            r_phase[r] = 0 if best_v > 0 else 1
    return r_block, r_phase


def phase_contig(tags_list, read_ids, t_len: int,
                 cfg: PhasingConfig | None = None):
    """Full oracle phasing for one contig. Returns dict of arrays."""
    cfg = cfg or PhasingConfig()
    counts = pileup_counts(tags_list, read_ids, t_len)
    het_pos, b1, b2 = call_het_sites(counts, cfg)
    M = allele_matrix(tags_list, het_pos, b1, b2, t_len)
    score, cov = association_band(M, cfg.max_span)
    block_id, orient = phase_blocks(score, cov, len(het_pos), cfg)
    r_block, r_phase = phase_reads(M, block_id, orient)
    return {
        "counts": counts, "het_pos": het_pos, "b1": b1, "b2": b2,
        "M": M, "score": score, "cov": cov,
        "block_id": block_id, "orient": orient,
        "r_block": r_block, "r_phase": r_phase,
    }
