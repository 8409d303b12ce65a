"""The benchmark's simulators: seeded, and their truth right."""
import numpy as np

from benchmark import sim


def test_mutate_source_map():
    rng = np.random.default_rng(5)
    seq = sim.random_genome(20_000, 1)
    out, src = sim.mutate(rng, seq, 0.09)
    assert len(out) == len(src) and np.all(np.diff(src) >= 0)
    same = out == seq[src]
    assert 0.85 < same.mean() < 0.97          # mismatches and insertions
    assert abs(len(out) - len(seq)) < 0.02 * len(seq)


def test_reads_are_seeded_and_true_to_their_span():
    dip = sim.make_diploid(8000, 0.02, 3, (0.2, 0.8))
    assert (dip.hap0 != dip.hap1).sum() == int(4800 * 0.02)
    a = sim.simulate_reads([dip.hap0, dip.hap1], 10, 1000, 0.0, 9)
    b = sim.simulate_reads([dip.hap0, dip.hap1], 10, 1000, 0.0, 9)
    assert len(a.seqs) == 80
    for r, h, s, e in zip(a.seqs, a.hap, a.start, a.end):
        assert np.array_equal(r, (dip.hap0, dip.hap1)[h][s:e])
    assert all(np.array_equal(x, y) for x, y in zip(a.seqs, b.seqs))
    noisy = sim.simulate_reads([dip.hap0, dip.hap1], 10, 1000, 0.05, 9)
    assert len(noisy.seqs) == 80


def test_genome_reads():
    d = sim.genome_reads(30_000, 5, 2000, 0.0, 11)
    assert len(d["truth"]) == 30_000 and len(d["reads"]) == 75
    assert 0 < d["strand"].sum() < 75
    for r, a, b, st in zip(d["reads"], d["start"], d["end"], d["strand"]):
        t = d["truth"][a:b]
        assert np.array_equal(r, sim.revcomp(t) if st else t)
    e = sim.genome_reads(30_000, 5, 2000, 0.13, 11)
    assert np.array_equal(e["start"], d["start"])


def test_contig_lengths_and_seeds():
    assert sim.contig_lengths(400_000, [0.5, 0.2, 0.1, 0.065, 0.065, 0.07]) \
        == [200_000, 80_000, 40_000, 26_000, 26_000, 28_000]
    assert sim.seed_of(2**33 + 5, 1) == sim.seed_of(2**33 + 5, 1)
    assert sim.seed_of(2**33 + 5, 1) != sim.seed_of(2**33 + 5, 2)
