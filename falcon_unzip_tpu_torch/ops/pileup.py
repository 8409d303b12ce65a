"""Pileup + het-site calling as torch ops.

Port of ``falcon_unzip_tpu.ops.pileup``.  The pileup is one bincount of
flat (contig, pos, base) keys into a (G, t_len, 5) count tensor, and the
het test a branch-free predicate over all positions.  Thresholds are
computed in float32, as the reference does, never through float64.
``pileup_host`` and ``het_call_host`` are verbatim host copies.

Determinism: identical results to oracle.phasing.call_het_sites (ties
broken toward smaller base codes: torch.argmax returns the first maximal
index).
"""
from __future__ import annotations

import numpy as np
import torch


def _het_core(counts: torch.Tensor, *, min_depth: int,
              min_allele_count: int, allele_freq_min: float,
              biallelic_frac: float):
    """Het predicate over (rows, 5) int32 count rows."""
    depth = counts.sum(dim=1)
    bc = counts[:, :4]
    b1 = torch.argmax(bc, dim=1)                     # first max
    c1 = bc.gather(1, b1[:, None])[:, 0]
    bc2 = bc.clone()
    bc2.scatter_(1, b1[:, None], -1)
    b2 = torch.argmax(bc2, dim=1)
    c2 = bc2.gather(1, b2[:, None])[:, 0]
    c12 = c1 + c2
    f32 = torch.float32
    afm = torch.tensor(allele_freq_min, dtype=f32, device=counts.device)
    bfr = torch.tensor(biallelic_frac, dtype=f32, device=counts.device)
    thresh = torch.clamp(torch.ceil(afm * c12.to(f32)).to(torch.int32),
                         min=min_allele_count)
    is_het = ((depth >= min_depth)
              & (c2 >= thresh)
              & (c12.to(f32) >= bfr * depth.to(f32)))
    return is_het, b1.to(torch.int8), b2.to(torch.int8)


def pileup_het_batch(pos: torch.Tensor, base: torch.Tensor, *, t_len: int,
                     min_depth: int, min_allele_count: int,
                     allele_freq_min: float, biallelic_frac: float,
                     with_counts: bool = False):
    """Batched pileup + het call for G contigs.

    pos, base: (G, N) int32 flat delta-0 tags per contig (pos < 0 pads;
    out-of-range positions are dropped).  Returns (is_het, b1, b2) each
    (G, t_len) [, counts (G, t_len, 5) int32].  Integer counts are
    order-free, so the result does not depend on the reduction order.
    """
    G, N = pos.shape
    dev = pos.device
    ok = (pos >= 0) & (pos < t_len)
    p = torch.where(ok, pos, t_len).to(torch.int64)
    g = torch.arange(G, dtype=torch.int64, device=dev)[:, None]
    key = (g * (t_len + 1) + p) * 5 + base.clamp(0, 4).to(torch.int64)
    counts = torch.bincount(key.reshape(-1), minlength=G * (t_len + 1) * 5)
    counts = counts.reshape(G, t_len + 1, 5)[:, :t_len].to(torch.int32)
    is_het, b1, b2 = _het_core(
        counts.reshape(G * t_len, 5), min_depth=min_depth,
        min_allele_count=min_allele_count,
        allele_freq_min=allele_freq_min, biallelic_frac=biallelic_frac)
    out = (is_het.reshape(G, t_len), b1.reshape(G, t_len),
           b2.reshape(G, t_len))
    if with_counts:
        return out + (counts,)
    return out


def pileup_host(pos: np.ndarray, base: np.ndarray,
                t_len: int) -> np.ndarray:
    """Host pileup (np.bincount), == pileup_scatter bit-for-bit.

    The device scatter is the production path; Mb-scale contigs carry
    hundreds of millions of flat tags, and shipping them through the
    relay costs more than the bincount — the host path keeps pileup
    O(tags) local and feeds the same integer counts downstream.
    """
    ok = (pos >= 0) & (pos < t_len)
    key = (pos[ok].astype(np.int64) * 5
           + np.clip(base[ok], 0, 4).astype(np.int64))
    return np.bincount(key, minlength=t_len * 5).reshape(
        t_len, 5).astype(np.int32)


def het_call_host(counts: np.ndarray, *, min_depth: int,
                  min_allele_count: int, allele_freq_min: float,
                  biallelic_frac: float):
    """Numpy mirror of _het_core, float32 scaling like the jit path.

    Integer comparisons; the two float products use np.float32 so the
    host result is bit-identical to het_call_vec (tested).
    """
    counts = np.asarray(counts)
    depth = counts.sum(axis=1)
    bc = counts[:, :4]
    b1 = np.argmax(bc, axis=1)
    c1 = np.take_along_axis(bc, b1[:, None], axis=1)[:, 0]
    bc2 = bc.copy()
    bc2[np.arange(len(bc)), b1] = -1
    b2 = np.argmax(bc2, axis=1)
    c2 = np.take_along_axis(bc2, b2[:, None], axis=1)[:, 0]
    c12 = c1 + c2
    thresh = np.maximum(
        min_allele_count,
        np.ceil(np.float32(allele_freq_min)
                * c12.astype(np.float32)).astype(np.int32))
    is_het = ((depth >= min_depth)
              & (c2 >= thresh)
              & (c12.astype(np.float32)
                 >= np.float32(biallelic_frac) * depth.astype(np.float32)))
    return is_het, b1.astype(np.int8), b2.astype(np.int8)


def allele_matrix_scatter_batch(read_row, pos, base, pos_to_site, b1, b2,
                                *, n_reads: int, n_sites: int, t_len: int):
    """Batched allele matrix for G contigs.

    read_row/pos/base: (G, N) flat tags; pos_to_site: (G, t_len) int32
    (-1 where not a het site); b1/b2: (G, n_sites) int32.  Returns M
    (G, n_reads, n_sites) int8: +1 where the read carries b1, -1 for b2,
    0 otherwise.

    Only tags that hit a het site are written.  Each (read row, site) is
    hit at most once: a row is one alignment record, and a record's
    delta-0 tags have distinct target positions (every diagonal or left
    move consumes a new target base).  So the write has no duplicate
    indices and no writer order to resolve.
    """
    G, N = pos.shape
    dev = pos.device
    inb = (pos >= 0) & (pos < t_len)
    site = torch.where(
        inb, pos_to_site.gather(1, pos.clamp(0, t_len - 1).to(torch.int64)),
        -1)
    hit = site >= 0
    sc = site.clamp(0, n_sites - 1).to(torch.int64)
    b1s = b1.gather(1, sc)
    b2s = b2.gather(1, sc)
    val = torch.where(base == b1s, 1,
                      torch.where(base == b2s, -1, 0)).to(torch.int8)
    g = torch.arange(G, dtype=torch.int64, device=dev)[:, None].expand(G, N)
    M = torch.zeros((G, n_reads, n_sites), dtype=torch.int8, device=dev)
    M[g[hit], read_row.clamp(0, n_reads - 1).to(torch.int64)[hit],
      sc[hit]] = val[hit]
    return M
