"""The benchmark's plain reference against brute force, on the CPU."""
import numpy as np
import pytest

from benchmark import reference as ref
from benchmark import sim


def _edit(a, b) -> int:
    """Full-matrix unit-cost edit distance, one cell at a time."""
    D = list(range(len(b) + 1))
    for i in range(1, len(a) + 1):
        prev, D[0] = D[0], i
        for j in range(1, len(b) + 1):
            prev, D[j] = D[j], min(D[j] + 1, D[j - 1] + 1,
                                   prev + (a[i - 1] != b[j - 1]))
    return D[-1]


def _semi(q, w) -> int:
    """q whole against the best substring of w, one cell at a time."""
    D = [0] * (len(w) + 1)
    for i in range(1, len(q) + 1):
        prev, D[0] = D[0], i
        for j in range(1, len(w) + 1):
            prev, D[j] = D[j], min(D[j] + 1, D[j - 1] + 1,
                                   prev + (q[i - 1] != w[j - 1]))
    return min(D)


@pytest.mark.parametrize("seed", range(6))
def test_banded_equals_brute_force(seed):
    rng = np.random.default_rng(seed)
    qs, ts = [], []
    for _ in range(5):
        t = sim.random_genome(int(rng.integers(40, 160)),
                              int(rng.integers(1e9)))
        q, _ = sim.mutate(rng, t, 0.15)
        if not len(q):
            q = t[:1]
        qs.append(q)
        ts.append(t)
    got = ref.banded(qs, ts, band=48)
    assert got.tolist() == [_edit(q, t) for q, t in zip(qs, ts)]


def test_banded_never_under_brute_force_with_a_narrow_band():
    rng = np.random.default_rng(7)
    t = sim.random_genome(300, 3)
    q = np.concatenate([t[:100], sim.random_genome(30, 4), t[100:]])
    assert ref.banded([q], [t], band=4)[0] >= _edit(q, t)
    assert ref.banded([q], [t], band=64)[0] == _edit(q, t)


@pytest.mark.parametrize("seed", range(4))
def test_free_ends_equal_brute_force(seed):
    rng = np.random.default_rng(seed + 10)
    qs, ws = [], []
    for _ in range(4):
        n = int(rng.integers(60, 200))
        w = sim.random_genome(n + 40, int(rng.integers(1e9)))
        a = int(rng.integers(0, 30))
        q, _ = sim.mutate(rng, w[a : a + n], 0.1)
        qs.append(q)
        ws.append(w)
    got = ref.banded(qs, ws, band=64, free_ends=True)
    assert got.tolist() == [_semi(q, w) for q, w in zip(qs, ws)]


def test_alts_match_the_other_haplotype():
    t = sim.random_genome(200, 5)
    alt = t.copy()
    alt[[20, 90]] = (alt[[20, 90]] + 1) % 4
    q = alt.copy()
    q[150] = (q[150] + 2) % 4
    assert ref.banded([q], [t], band=16)[0] == 3
    assert ref.banded([q], [t], band=16, alts=[alt])[0] == 1


def _genome(seed):
    lens = [6000, 3000]
    dips = [sim.make_diploid(n, 0.012, seed + i, (0.2, 0.8))
            for i, n in enumerate(lens)]
    return [d.hap0 for d in dips], [d.hap1 for d in dips]


def test_score_assembly_counts_planted_errors_and_switches():
    hap0, hap1 = _genome(1)
    perfect = ref.score_assembly(
        [hap0[0], hap1[1][500:2500], sim.revcomp(hap0[1])], hap0, hap1)
    assert perfect["errors"] == 0 and perfect["unplaced"] == 0
    assert perfect["bases"] == 6000 + 2000 + 3000
    # a mosaic switching haplotype between pieces (and k-mers) costs nothing
    mosaic = np.concatenate([hap0[0][:4000], hap1[0][4000:]])
    assert ref.score_assembly([mosaic], hap0, hap1)["errors"] == 0
    bad = hap1[0].copy()
    bad[[100, 2600, 5100]] = (bad[[100, 2600, 5100]] + 1) % 4
    bad = np.insert(np.delete(bad, [4000, 4500]), 1000, 2)
    assert ref.score_assembly([bad], hap0, hap1)["errors"] == 6
    gap = np.delete(hap1[0], np.r_[2000:2083, 4000:4091])  # whole blocks
    assert ref.score_assembly([gap], hap0, hap1)["errors"] == 83 + 91
    junk = sim.random_genome(1000, 99)
    sc = ref.score_assembly([junk, hap0[1]], hap0, hap1)
    assert sc["unplaced"] == 1 and sc["errors"] == 1000


def _snps(hap0, hap1):
    return [np.nonzero(a != b)[0] for a, b in zip(hap0, hap1)]


@pytest.mark.parametrize("piece", [500, 300])
def test_alleles_mixed_within_a_piece_count(piece):
    """Each piece counts against one haplotype: a contig that takes its
    alleles from either haplotype, column by column, pays for the minority
    of each piece, which a brute-force count over the pieces confirms."""
    hap0, hap1 = _genome(2)
    snp = _snps(hap0, hap1)[0]
    rng = np.random.default_rng(3)
    pick = rng.integers(0, 2, len(snp)).astype(bool)
    mixed = hap0[0].copy()
    mixed[snp[pick]] = hap1[0][snp[pick]]
    want = 0
    for lo in range(0, len(mixed), piece):
        inside = (snp >= lo) & (snp < lo + piece)
        want += min(int((pick & inside).sum()), int((~pick & inside).sum()))
    got = ref.score_assembly([mixed], hap0, hap1, piece=piece)["errors"]
    assert want > 0 and got == want


def test_score_alleles():
    hap0, hap1 = _genome(4)
    snps = _snps(hap0, hap1)
    n = sum(len(s) for s in snps)
    both = ref.score_alleles([hap0[0], hap0[1], hap1[0], hap1[1]], hap0,
                             hap1, snps)
    assert both == {"shown": n, "missing": 0}
    # a haplotig copying its primary's alleles shows no other allele
    copied = ref.score_alleles([hap0[0], hap0[1], hap0[0][1000:5000]], hap0,
                               hap1, snps)
    assert copied == {"shown": n, "missing": n}
    # a haplotig over part of a contig leaves the rest with one allele
    part = ref.score_alleles([hap0[0], hap0[1], hap1[0][:3000]], hap0, hap1,
                             snps)
    s0 = snps[0]
    inner = int(((s0 >= 32) & (s0 < 2944)).sum())
    assert part["shown"] == n
    assert n - part["missing"] - inner in (0, 1, 2)


def test_score_phasing_per_block_naming():
    origin = {f"r{i}": (0, i % 2) for i in range(8)}
    origin["x"] = (1, 0)
    phaseable = {f"r{i}" for i in range(8)} | {"u"}
    rows = [(0, 5, 1 - i % 2, f"r{i}") for i in range(8)]     # swapped names
    assert ref.score_phasing(rows, origin, phaseable) == {
        "reads": 9, "wrong": 0, "unphased": 1}
    rows[0] = (0, 5, 0, "r0")                 # r0 (hap 0) beside hap 1's
    rows.append((0, 5, 0, "x"))               # a read of another contig
    assert ref.score_phasing(rows, origin, phaseable) == {
        "reads": 10, "wrong": 2, "unphased": 1}


def test_truth_index_labels_haplotype_kmers():
    hap0, hap1 = _genome(5)
    idx = ref.TruthIndex(hap0, hap1)
    snp = _snps(hap0, hap1)[0]
    _, pos, lab = idx.hits(hap1[0])
    near = np.array([bool(((snp >= p) & (snp < p + 32)).any()) for p in pos])
    assert np.array_equal(lab == 1, near) and set(lab[~near]) == {2}
    assert set(idx.hits(hap0[0])[2]) == {0, 2}


def test_score_pieces_counts_missing_answers_whole():
    t = [sim.random_genome(500, 1), sim.random_genome(400, 2)]
    a = t[0].copy()
    a[10] = (a[10] + 1) % 4
    sc = ref.score_pieces([a, None], t)
    assert sc == {"bases": 900, "errors": 401, "missing": 1}


def test_phred():
    assert ref.phred(1, 10_000) == pytest.approx(40.0)
    assert ref.phred(0, 10_000) == pytest.approx(40.0)


def test_score_pieces_of_overlapping_slices():
    """Slices that share stretches of the genome are each scored on their
    own: a k-mer held by two slices still anchors."""
    g = sim.random_genome(3000, 8)
    t = [g[:2000], g[1000:]]
    a = [t[0].copy(), t[1].copy()]
    a[1][500] = (a[1][500] + 1) % 4
    assert ref.score_pieces(a, t) == {"bases": 4000, "errors": 1,
                                      "missing": 0}
