"""Seeded inputs of the benchmark's cells, in plain numpy.

A frozen copy of the simulators the port's own benches use, so that a
later change of the program cannot move the yardstick:

- ``make_diploid``: ``falcon_unzip_tpu_torch/utils/simulate.py``'s
  haplotype pair separated by het SNPs inside ``het_span`` (no indels,
  repeats or chimeras, as the e2e bench runs it);
- ``simulate_reads``: the same module's uniform read sampler (length
  0.7-1.3x the mean, a random haplotype and start, forward strand), with
  the error model applied to all reads at once (``mutate``, the numpy form
  of ``mutate_read`` that ``utils/fixtures.py`` keeps);
- ``contig_lengths``: ``scripts/e2e_bench.py``'s contig shapes;
- ``genome_reads``: the raw reads of one haploid genome on both strands,
  whose seed reads falcon_sense corrects.

Bases are int8 codes A, C, G, T = 0..3.  Nothing here imports the port.
"""
from __future__ import annotations

import dataclasses

import numpy as np

NBASE = 4
ASCII = np.frombuffer(b"ACGTN", np.uint8)


def seed_of(*parts: int) -> int:
    """A 63-bit seed drawn from the run's seed and the parts' indices."""
    return int(np.random.SeedSequence([int(p) for p in parts])
               .generate_state(2, np.uint64)[0] >> np.uint64(1))


def random_genome(length: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, NBASE, size=length,
                                                dtype=np.int8)


def revcomp(codes: np.ndarray) -> np.ndarray:
    return (3 - np.asarray(codes, np.int8)[::-1]).astype(np.int8)


def mutate(rng, seq: np.ndarray, rate: float) -> tuple:
    """Each base mismatched, followed by a random inserted base, or deleted,
    each with probability rate / 3.  Returns (mutated codes, for each of its
    bases the index in ``seq`` of the base it came from; an inserted base
    takes the index of the base it follows)."""
    seq = np.asarray(seq, np.int8)
    r = rng.random(len(seq))
    sub = r < rate / 3
    ins = (r >= rate / 3) & (r < 2 * rate / 3)
    dele = (r >= 2 * rate / 3) & (r < rate)
    out = seq.copy()
    out[sub] = (out[sub] + rng.integers(1, NBASE, int(sub.sum()))) % NBASE
    reps = 1 - dele.astype(np.int64) + ins
    res = np.repeat(out, reps)
    src = np.repeat(np.arange(len(seq), dtype=np.int64), reps)
    # an insertion's random base takes the second of its base's two slots
    res[np.cumsum(reps)[ins] - 1] = rng.integers(0, NBASE, int(ins.sum()))
    return res.astype(np.int8), src


@dataclasses.dataclass
class Diploid:
    hap0: np.ndarray
    hap1: np.ndarray
    snp_pos: np.ndarray


def make_diploid(length: int, het_rate: float, seed: int,
                 het_span: tuple = (0.0, 1.0)) -> Diploid:
    """Two haplotypes of one contig: hap1 is hap0 with het SNPs at
    ``het_rate`` inside the ``het_span`` fraction of the contig (both
    haplotypes keep hap0's coordinates)."""
    rng = np.random.default_rng(seed)
    hap0 = random_genome(length, seed)
    lo, hi = int(length * het_span[0]), int(length * het_span[1])
    n_het = int((hi - lo) * het_rate)
    pos = lo + np.sort(rng.choice(hi - lo, size=n_het, replace=False))
    hap1 = hap0.copy()
    hap1[pos] = (hap0[pos] + rng.integers(1, NBASE, size=n_het)) % NBASE
    return Diploid(hap0, hap1, pos.astype(np.int64))


@dataclasses.dataclass
class Reads:
    seqs: list          # int8 codes of each read
    hap: np.ndarray     # the haplotype each read was drawn from
    start: np.ndarray   # its span on that haplotype
    end: np.ndarray


def simulate_reads(haps: list, coverage: float, read_len: int,
                   error_rate: float, seed: int) -> Reads:
    """max(2, coverage * length / read_len) reads, each from a random
    haplotype of ``haps`` (equal lengths), of read_len x U(0.7, 1.3) bases
    at a random start, mutated at ``error_rate``."""
    rng = np.random.default_rng(seed)
    glen = len(haps[0])
    n = max(2, int(coverage * glen / read_len))
    hap = rng.integers(0, len(haps), n)
    L = np.minimum((read_len * (0.7 + 0.6 * rng.random(n))).astype(np.int64),
                   glen)
    start = (rng.random(n) * (glen - L + 1)).astype(np.int64)
    stacked = np.stack(haps)
    flat = np.concatenate([stacked[h, s : s + l]
                           for h, s, l in zip(hap, start, L)])
    if error_rate > 0:
        flat, src = mutate(rng, flat, error_rate)
        owner = np.repeat(np.arange(n), L)[src]
        bounds = np.searchsorted(owner, np.arange(1, n))
    else:
        bounds = np.cumsum(L)[:-1]
    return Reads(np.split(flat, bounds), hap.astype(np.int8), start,
                 start + L)


def contig_lengths(genome_bp: int, fractions: list) -> list:
    """Contig lengths of a genome: each fraction of genome_bp, the last
    contig taking the rest (``scripts/e2e_bench.py``'s n50 shape for
    [0.5, 0.2, 0.1, 0.065, 0.065, 0.07])."""
    lens = [int(genome_bp * f) for f in fractions[:-1]]
    return lens + [genome_bp - sum(lens)]


def genome_reads(length: int, coverage: float, read_len: int,
                 error_rate: float, seed: int) -> dict:
    """Raw reads of one haploid genome, as falcon_sense gets them: a random
    truth of ``length`` bases and coverage x length / read_len reads of
    read_len x U(0.7, 1.3) bases at random starts, mutated at
    ``error_rate``, each on a random strand (a reverse one
    reverse-complemented), with their truth spans and strands."""
    truth = random_genome(length, seed_of(seed, 1))
    rd = simulate_reads([truth], coverage, read_len, error_rate,
                        seed_of(seed, 2))
    strand = np.random.default_rng(seed_of(seed, 3)).integers(
        0, 2, len(rd.seqs)).astype(np.int8)
    reads = [revcomp(r) if s else r for r, s in zip(rd.seqs, strand)]
    return {"truth": truth, "reads": reads, "start": rd.start,
            "end": rd.end, "strand": strand}


def fasta_bytes(records) -> bytes:
    """FASTA of (name, int8 codes) records, one line a sequence."""
    parts = []
    for name, codes in records:
        parts += [b">", name.encode(), b"\n",
                  ASCII[np.asarray(codes, np.int8)].tobytes(), b"\n"]
    return b"".join(parts)
