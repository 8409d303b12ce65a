"""Synthetic diploid genome + long-read simulator for tests and benches.

Role parity: the reference validates end-to-end on synthetic/tiny genomes
(FALCON-examples `run/synth0`, greg200k-sv2 — SURVEY.md §4).  This module
generates the equivalent fixtures in-process: a random genome, a diploid
pair of haplotypes separated by SNPs (+ optional indels/SVs), and noisy
long reads sampled from both haplotypes.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..seq import NBASE, SeqBatch


@dataclasses.dataclass
class Diploid:
    hap0: np.ndarray            # int8 codes
    hap1: np.ndarray
    snp_pos: np.ndarray         # het SNP positions in hap0 coordinates
    snp_alt: np.ndarray         # hap1 base at those positions
    indel_pos: np.ndarray = None  # het indel positions (hap0 coords)
    indel_len: np.ndarray = None  # +k insertion in hap1 / -k deletion
    repeat_src: np.ndarray = None   # segmental-duplication source starts
    repeat_dst: np.ndarray = None   # duplication destination starts
    repeat_len: int = 0             # duplication length


def random_genome(length: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, NBASE, size=length, dtype=np.int8)


def make_diploid(
    length: int = 20000,
    het_rate: float = 0.01,
    seed: int = 0,
    het_span: tuple[float, float] | None = None,
    indel_frac: float = 0.0,
    max_indel: int = 3,
    n_repeats: int = 0,
    repeat_len: int = 3000,
    repeat_identity: float = 0.97,
) -> Diploid:
    """Haplotype pair differing by SNPs (and optionally small indels).

    het_span: optional (lo_frac, hi_frac) restricting het events to a
    sub-region (models a diverged bubble flanked by collapsed sequence).
    indel_frac: fraction of het events realized as 1..max_indel het
    INDELS instead of SNPs (hap1 inserts or deletes relative to hap0);
    0.0 keeps the SNP-only behavior (golden-stable default).
    n_repeats: segmental duplications (VERDICT r3 next #8 realism) —
    n_repeats source windows of repeat_len bases are copied to distant
    loci at repeat_identity, HOMOZYGOUSLY (before het events), so reads
    from either copy multi-map and challenge placement/bestn/chimer
    logic the way real repeats do.  0 keeps the repeat-free
    (golden-stable) behavior.
    """
    rng = np.random.default_rng(seed)
    hap0 = random_genome(length, seed)
    rep_src = np.zeros(0, np.int64)
    rep_dst = np.zeros(0, np.int64)
    if n_repeats > 0 and length >= 4 * repeat_len:
        # non-overlapping slots, shuffled: src and dst copies land far
        # apart; the dst window is REPLACED (length preserved) by a
        # mutated copy of the src window
        n_slots = length // (2 * repeat_len)
        slots = rng.permutation(n_slots)[: 2 * n_repeats]
        starts = slots * (2 * repeat_len) + repeat_len // 2
        rep_src = np.sort(starts[:n_repeats]).astype(np.int64)
        rep_dst = np.sort(starts[n_repeats:]).astype(np.int64)
        for s, t in zip(rep_src, rep_dst):
            copy = hap0[s : s + repeat_len].copy()
            n_mut = int(round((1.0 - repeat_identity) * repeat_len))
            if n_mut:
                mp = rng.choice(repeat_len, size=n_mut, replace=False)
                copy[mp] = (copy[mp]
                            + rng.integers(1, NBASE, size=n_mut)) % NBASE
            hap0[t : t + repeat_len] = copy
    lo, hi = (0, length) if het_span is None else (
        int(length * het_span[0]), int(length * het_span[1]))
    n_het = int((hi - lo) * het_rate) if het_rate > 0 else 0
    if n_het == 0:
        return Diploid(hap0=hap0, hap1=hap0.copy(),
                       snp_pos=np.zeros(0, np.int64),
                       snp_alt=np.zeros(0, np.int8),
                       indel_pos=np.zeros(0, np.int64),
                       indel_len=np.zeros(0, np.int64),
                       repeat_src=rep_src, repeat_dst=rep_dst,
                       repeat_len=repeat_len if len(rep_src) else 0)
    pos = lo + np.sort(rng.choice(hi - lo, size=n_het, replace=False))
    if indel_frac > 0:
        # events must not overlap a neighboring deletion's span
        spaced = np.diff(pos, prepend=pos[0] - max_indel - 1) > max_indel
        pos = pos[spaced]
    is_indel = rng.random(len(pos)) < indel_frac
    snp_p = pos[~is_indel]
    alt = (hap0[snp_p] + rng.integers(1, NBASE, size=len(snp_p))) % NBASE
    hap1 = hap0.copy()
    hap1[snp_p] = alt
    ind_p = pos[is_indel]
    ind_l = np.zeros(len(ind_p), np.int64)
    if len(ind_p):
        sz = rng.integers(1, max_indel + 1, size=len(ind_p))
        sign = np.where(rng.random(len(ind_p)) < 0.5, 1, -1)
        ind_l = (sz * sign).astype(np.int64)
        # splice right-to-left so earlier coordinates stay valid
        parts = []
        prev = len(hap1)
        for p, k in sorted(zip(ind_p.tolist(), ind_l.tolist()),
                           reverse=True):
            if k > 0:                      # insertion in hap1 before p
                parts.append(hap1[p:prev])
                parts.append(rng.integers(0, NBASE, size=k,
                                          ).astype(np.int8))
            else:                          # deletion of -k bases at p
                parts.append(hap1[p - k:prev])
            prev = p
        parts.append(hap1[:prev])
        hap1 = np.concatenate(parts[::-1])
    return Diploid(hap0=hap0, hap1=hap1,
                   snp_pos=snp_p.astype(np.int64),
                   snp_alt=alt.astype(np.int8),
                   indel_pos=ind_p.astype(np.int64), indel_len=ind_l,
                   repeat_src=rep_src, repeat_dst=rep_dst,
                   repeat_len=repeat_len if len(rep_src) else 0)


def mutate_read(read: np.ndarray, error_rate: float, rng) -> np.ndarray:
    """Apply PacBio-like errors (~equal mix of mismatch/ins/del)."""
    if error_rate <= 0:
        return read.copy()
    out = []
    for b in read:
        r = rng.random()
        if r < error_rate / 3:                      # mismatch
            out.append((b + rng.integers(1, NBASE)) % NBASE)
        elif r < 2 * error_rate / 3:                # insertion
            out.append(int(b))
            out.append(rng.integers(0, NBASE))
        elif r < error_rate:                        # deletion
            pass
        else:
            out.append(int(b))
    return np.array(out, dtype=np.int8)


def mutate_read_qv(read: np.ndarray, rates: np.ndarray, rng):
    """Per-base error application + matching PHRED track.

    rates: per-TRUE-base error probability.  Each emitted base carries
    the phred of its source base's rate (inserted bases inherit the
    rate of the base they follow) — the simulator analogue of a PacBio
    per-base QV track whose values actually predict the local error
    rate (the signal real Arrow's IQV/DQV conditioning exploits).
    """
    out: list[int] = []
    qv: list[int] = []
    phred = np.clip(np.round(-10.0 * np.log10(np.maximum(rates, 1e-5))),
                    2, 40).astype(np.uint8)
    for k, b in enumerate(read):
        e = rates[k]
        r = rng.random()
        if r < e / 3:                               # mismatch
            out.append((int(b) + int(rng.integers(1, NBASE))) % NBASE)
            qv.append(int(phred[k]))
        elif r < 2 * e / 3:                         # insertion
            out.append(int(b))
            qv.append(int(phred[k]))
            out.append(int(rng.integers(0, NBASE)))
            qv.append(int(phred[k]))
        elif r < e:                                 # deletion
            pass
        else:
            out.append(int(b))
            qv.append(int(phred[k]))
    return (np.array(out, dtype=np.int8),
            np.array(qv, dtype=np.uint8))


def hotspot_map(glen: int, seed: int, spacing: int = 2000,
                width: int = 120) -> np.ndarray:
    """Genome-positioned error hotspots (bool mask).

    Real long-read error is not i.i.d.: certain loci (homopolymers,
    GC-skew) raise the error rate for every read crossing them, often
    STRAND-specifically.  The "hotspot" qv_profile gives reverse-strand
    reads a high error rate inside these windows — the regime where
    per-base QV conditioning has signal that a per-read mean does not.
    """
    rng = np.random.default_rng(seed ^ 0x9E3779B9)
    mask = np.zeros(glen, bool)
    for s in range(spacing // 2, max(glen - width, 1), spacing):
        j = s + int(rng.integers(0, spacing // 4))
        mask[j : j + width] = True
    return mask


def burst_rates(L: int, rng, base_rate: float = 0.01,
                burst_rate: float = 0.2, burst_frac: float = 0.15,
                burst_len: int = 150) -> np.ndarray:
    """Per-base error-rate track: clean baseline + low-quality bursts.

    Models the bimodal quality structure of real long reads (clean
    passes vs noisy segments); ~burst_frac of bases sit in ~burst_len
    stretches at burst_rate error."""
    rates = np.full(L, base_rate, np.float64)
    n_bursts = max(0, int(round(burst_frac * L / max(burst_len, 1))))
    for _ in range(n_bursts):
        s = int(rng.integers(0, max(1, L - burst_len + 1)))
        rates[s : s + burst_len] = burst_rate
    return rates


@dataclasses.dataclass
class SimReads:
    batch: SeqBatch
    hap: np.ndarray        # true haplotype of each read (0/1)
    start: np.ndarray      # true start on its haplotype
    end: np.ndarray
    strand: np.ndarray = None   # 0 = forward, 1 = reverse-complement
    chimera: np.ndarray = None  # 1 = chimeric junction read
    quals: list | None = None   # per-read uint8 PHRED (qv_profile runs)


def simulate_reads(
    diploid: Diploid,
    coverage: float = 20.0,
    read_len: int = 4000,
    error_rate: float = 0.0,
    seed: int = 1,
    rc_frac: float = 0.0,
    chimera_frac: float = 0.0,
    qv_profile: str | None = None,
) -> SimReads:
    """Sample reads uniformly from both haplotypes.

    rc_frac: fraction of reads emitted reverse-complemented (0.0 keeps
    the forward-only, golden-stable behavior); the truth arrays record
    strand and forward-coordinate span.

    chimera_frac: fraction of reads emitted as CHIMERAS — two segments
    from unrelated loci fused at a junction (the blasr-era library
    artifact the reference's chimer filter targets, SURVEY.md §3.1).
    A chimeric read's truth span records its FIRST segment; the
    ``chimera`` array marks it.  0.0 keeps golden-stable behavior.

    qv_profile: None keeps the uniform-error, no-quality-track
    behavior (golden-stable).  "burst" draws a per-base error-rate
    track per read (clean baseline + noisy bursts, see burst_rates;
    error_rate scales the whole track relative to its ~2.9% default
    mean) and emits matching per-read PHRED arrays in ``quals`` — the
    fixture for per-base quality-conditioned polishing.
    """
    from ..seq import revcomp
    rng = np.random.default_rng(seed)
    haps = [diploid.hap0, diploid.hap1]
    glen = len(diploid.hap0)
    n_reads = max(2, int(coverage * glen / read_len))
    seqs, hap_ids, starts, ends, strands, chim = [], [], [], [], [], []
    quals: list[np.ndarray] | None = [] if qv_profile else None
    qv_scale = 1.0
    hs_mask = None
    if qv_profile == "hotspot":
        hs_mask = hotspot_map(glen, seed)
    elif qv_profile:
        # burst_rates defaults average ~0.01*0.85 + 0.2*0.15 = 0.0385
        qv_scale = (error_rate / 0.0385) if error_rate > 0 else 1.0
    for i in range(n_reads):
        h = int(rng.integers(0, 2))
        hlen = len(haps[h])
        L = int(min(read_len * (0.7 + 0.6 * rng.random()), hlen))
        s = int(rng.integers(0, max(1, hlen - L + 1)))
        # a chimera needs room for two non-empty segments: L1 is
        # clamped to L and short reads skip chimerization outright so
        # the recorded truth end (s + L1) never overshoots the read
        # (ADVICE r4)
        is_chim = chimera_frac > 0 and L >= 400 and (
            rng.random() < chimera_frac)
        if is_chim:
            # first half from (h, s), second half from a random other
            # locus (either haplotype, either orientation)
            L1 = min(L - 100, max(200, L // 2))
            h2 = int(rng.integers(0, 2))
            L2 = L - L1
            s2 = int(rng.integers(0, max(1, len(haps[h2]) - L2 + 1)))
            seg2 = haps[h2][s2 : s2 + L2]
            if rng.random() < 0.5:
                seg2 = revcomp(seg2)
            raw = np.concatenate([haps[h][s : s + L1], seg2])
            ends_i = s + L1
        else:
            raw = haps[h][s : s + L]
            ends_i = s + L
        if qv_profile == "hotspot":
            # strand decided BEFORE mutation: reverse-strand reads take
            # the high error rate inside genome hotspots
            st = 1 if (rc_frac > 0 and rng.random() < rc_frac) else 0
            base = error_rate if error_rate > 0 else 0.01
            rates = np.full(len(raw), base, np.float64)
            if st and not is_chim:
                span = hs_mask[s : s + len(raw)]
                rates[: len(span)] = np.where(span, 0.30,
                                              rates[: len(span)])
            read, q_track = mutate_read_qv(raw, rates, rng)
        elif qv_profile:
            st = 1 if (rc_frac > 0 and rng.random() < rc_frac) else 0
            rates = burst_rates(len(raw), rng) * qv_scale
            read, q_track = mutate_read_qv(raw, rates, rng)
        else:
            read = mutate_read(raw, error_rate, rng)
            q_track = None
            st = 1 if (rc_frac > 0 and rng.random() < rc_frac) else 0
        if st:
            read = revcomp(read)
            if q_track is not None:
                q_track = q_track[::-1].copy()
        if quals is not None:
            quals.append(q_track)
        seqs.append(read)
        hap_ids.append(h)
        starts.append(s)
        ends.append(ends_i)
        strands.append(st)
        chim.append(1 if is_chim else 0)
    names = [f"read/{i}/{hap_ids[i]}_{starts[i]}_{ends[i]}"
             + ("_chim" if chim[i] else "")
             for i in range(n_reads)]
    batch = SeqBatch.from_strs(seqs, names=names)
    if quals is not None:
        batch.base_qv = quals
        batch.mean_qv = np.array(
            [float(t.mean()) if len(t) else 0.0 for t in quals],
            np.float32)
    return SimReads(
        batch=batch,
        hap=np.array(hap_ids, dtype=np.int8),
        start=np.array(starts, dtype=np.int64),
        end=np.array(ends, dtype=np.int64),
        strand=np.array(strands, dtype=np.int8),
        chimera=np.array(chim, dtype=np.int8),
        quals=quals,
    )
