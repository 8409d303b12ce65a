"""Port phasing ops and drivers == the JAX package, bit for bit.

The same AlnSet (aligned once, by the reference) feeds both packages;
every count, het call, allele matrix, association table, vote and phase
assignment must be equal (integer semantics; the float32 thresholds and
float32 vote matmuls are exact on these inputs).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from falcon_unzip_tpu.models import phaser as ref_phaser
from falcon_unzip_tpu.models.aligner import ReadToContigAligner
from falcon_unzip_tpu.ops import association as ref_assoc
from falcon_unzip_tpu.ops import pileup as ref_pileup
from falcon_unzip_tpu.oracle import phasing as op
from falcon_unzip_tpu.seq import SeqBatch
from falcon_unzip_tpu.utils.simulate import make_diploid, simulate_reads
from falcon_unzip_tpu_torch.models import phaser as port_phaser
from falcon_unzip_tpu_torch.ops import association as port_assoc
from falcon_unzip_tpu_torch.ops import pileup as port_pileup

# one intra-op thread: the suite runs several pytest workers on one host,
# and a torch CPU thread pool in each would oversubscribe the cores
torch.set_num_threads(1)

HET_KW = dict(min_depth=10, min_allele_count=2, allele_freq_min=0.25,
              biallelic_frac=0.8)
FIELDS = ("het_pos", "b1", "b2", "block_id", "orient", "read_ids",
          "r_block", "r_phase")


@pytest.fixture(scope="module")
def sim():
    """tests/test_phasing.py's single-contig case."""
    dip = make_diploid(length=12000, het_rate=0.01, seed=10)
    reads = simulate_reads(dip, coverage=30.0, read_len=2000,
                           error_rate=0.05, seed=11)
    aln = ReadToContigAligner([dip.hap0]).align_batch(reads.batch)
    return dip, aln


@pytest.fixture(scope="module")
def multi():
    """tests/test_phasing.py's three-contig case."""
    contigs, all_reads = [], []
    for ci, ln in enumerate((9000, 5000, 14000)):
        dip = make_diploid(length=ln, het_rate=0.02, seed=70 + ci,
                           het_span=(0.1, 0.9))
        rd = simulate_reads(dip, coverage=14.0, read_len=2500,
                            error_rate=0.0, seed=80 + ci)
        contigs.append(dip.hap0)
        all_reads += [rd.batch.to_str(i) for i in range(len(rd.batch))]
    aln = ReadToContigAligner(contigs).align_batch(
        SeqBatch.from_strs(all_reads))
    return aln, [len(c) for c in contigs]


def _same(a, b):
    for f in FIELDS:
        assert np.array_equal(getattr(a, f), getattr(b, f)), f


def test_pileup_het_batch_matches_jax():
    rng = np.random.default_rng(5)
    pos = rng.integers(-5, 1000, size=(3, 20000)).astype(np.int32)
    base = rng.integers(0, 5, size=(3, 20000)).astype(np.int32)
    r = ref_pileup.pileup_het_batch(jnp.asarray(pos), jnp.asarray(base),
                                    t_len=997, with_counts=True, **HET_KW)
    p = port_pileup.pileup_het_batch(torch.from_numpy(pos),
                                     torch.from_numpy(base), t_len=997,
                                     with_counts=True, **HET_KW)
    for a, b in zip(r, p):
        assert np.array_equal(np.asarray(a), b.numpy())
    assert np.array_equal(port_pileup.pileup_host(pos[0], base[0], 997),
                          p[3][0].numpy())


def test_het_call_argmax_ties_pick_first_code():
    # every tie pattern of the top two alleles, incl. all-equal rows
    counts = np.array([[5, 5, 5, 5, 0], [0, 7, 7, 0, 1], [3, 0, 3, 3, 0],
                       [0, 0, 0, 0, 0], [9, 9, 0, 0, 0], [0, 0, 6, 6, 0]],
                      np.int32)
    kw = dict(min_depth=1, min_allele_count=1, allele_freq_min=0.25,
              biallelic_frac=0.5)
    ih_j, b1_j, b2_j = (np.asarray(x) for x in
                        ref_pileup.het_call_vec(jnp.asarray(counts), **kw))
    ih_p, b1_p, b2_p = (x.numpy() for x in port_pileup._het_core(
        torch.from_numpy(counts), **kw))
    ih_h, b1_h, b2_h = port_pileup.het_call_host(counts, **kw)
    assert b1_p.tolist() == [0, 1, 0, 0, 0, 2]
    assert b2_p.tolist() == [1, 2, 2, 1, 1, 3]
    for j, p, h in ((ih_j, ih_p, ih_h), (b1_j, b1_p, b1_h),
                    (b2_j, b2_p, b2_h)):
        assert np.array_equal(j, p) and np.array_equal(h, p)


def test_het_thresholds_are_float32():
    # allele_freq_min * c12 lands just above an integer in float64 but
    # exactly on it in float32: the ceil differs, float32 must win
    counts = np.array([[10, 10, 0, 0, 0]], np.int32)
    kw = dict(min_depth=1, min_allele_count=1, allele_freq_min=0.1,
              biallelic_frac=0.8)
    ih_j, _, _ = ref_pileup.het_call_vec(jnp.asarray(counts), **kw)
    ih_p, _, _ = port_pileup._het_core(torch.from_numpy(counts), **kw)
    assert np.array_equal(np.asarray(ih_j), ih_p.numpy())


def test_scatter_association_votes_match_jax(sim):
    dip, aln = sim
    t_len = len(dip.hap0)
    rec = np.nonzero(aln.ctg == 0)[0]
    row, pos, base = ref_phaser.flat_delta0_tags(aln, rec)
    counts = port_pileup.pileup_host(pos, base, t_len)
    is_het, b1a, b2a = port_pileup.het_call_host(counts, **HET_KW)
    het = np.nonzero(is_het)[0]
    S, R, Tb = len(het), len(rec), 12288
    bucket = port_phaser._bucket
    Sb, Rb, Nb = bucket(S, 256), bucket(R, 256), bucket(len(pos), 8192)
    p2s = np.full((1, Tb), -1, np.int32)
    p2s[0, het] = np.arange(S, dtype=np.int32)
    b1 = np.full((1, Sb), -9, np.int32)
    b1[0, :S] = b1a[het]
    b2 = np.full((1, Sb), -9, np.int32)
    b2[0, :S] = b2a[het]
    rb, pb, bb = (np.zeros((1, Nb), np.int32) for _ in range(3))
    pb[:] = -1
    rb[0, :len(row)], pb[0, :len(pos)], bb[0, :len(base)] = row, pos, base
    args = (rb, pb, bb, p2s, b1, b2)
    kw = dict(n_reads=Rb, n_sites=Sb, t_len=Tb)
    Mj = np.asarray(ref_pileup.allele_matrix_scatter_batch(
        *(jnp.asarray(a) for a in args), **kw))
    Mp = port_pileup.allele_matrix_scatter_batch(
        *(torch.from_numpy(a) for a in args), **kw)
    assert np.array_equal(Mj, Mp.numpy())
    assert (Mj != 0).sum() > 1000

    sj, cj = ref_assoc.association_band_batch(jnp.asarray(Mj), max_span=64)
    sp, cp = port_assoc.association_band_batch(Mp, max_span=64)
    assert np.array_equal(np.asarray(sj), sp.numpy())
    assert np.array_equal(np.asarray(cj), cp.numpy())

    block_id, orient = op.phase_blocks(sp.numpy()[0][:S], cp.numpy()[0][:S],
                                       S, op.PhasingConfig())
    nb = int(block_id.max()) + 1
    oh = np.zeros((1, Sb, 16), np.int8)
    sel = block_id >= 0
    oh[0, np.nonzero(sel)[0], block_id[sel]] = 1
    sgn = np.ones((1, Sb), np.int32)
    sgn[0, :S] = 1 - 2 * orient.astype(np.int32)
    vj, wj = ref_assoc.read_block_votes_batch(jnp.asarray(Mj),
                                              jnp.asarray(oh),
                                              jnp.asarray(sgn))
    vp, wp = port_assoc.read_block_votes_batch(Mp, torch.from_numpy(oh),
                                               torch.from_numpy(sgn))
    assert np.array_equal(np.asarray(vj), vp.numpy())
    assert np.array_equal(np.asarray(wj), wp.numpy())
    a = ref_assoc.assign_reads(np.asarray(vj)[0][:R, :nb],
                               np.asarray(wj)[0][:R, :nb])
    b = port_assoc.assign_reads(vp.numpy()[0][:R, :nb],
                                wp.numpy()[0][:R, :nb])
    assert all(np.array_equal(x, y) for x, y in zip(a, b))


def test_phase_contig_device_matches_jax(sim):
    dip, aln = sim
    t_len = len(dip.hap0)
    r = ref_phaser.phase_contig_device(aln, 0, t_len)
    p = port_phaser.phase_contig_device(aln, 0, t_len, device="cpu")
    _same(r, p)
    assert np.array_equal(r.counts, p.counts)
    assert (p.r_block >= 0).sum() > 0.7 * len(p.read_ids)


@pytest.mark.parametrize("host_tag_cap", [0, 1 << 40])
def test_phase_contigs_batched_matches_jax(multi, host_tag_cap):
    aln, t_lens = multi
    r = ref_phaser.phase_contigs_batched(aln, range(3), t_lens,
                                         host_tag_cap=host_tag_cap)
    p = port_phaser.phase_contigs_batched(aln, range(3), t_lens,
                                          host_tag_cap=host_tag_cap,
                                          device="cpu")
    for a, b in zip(r, p):
        _same(a, b)
        assert np.array_equal(port_phaser.phased_reads_table(b),
                              ref_phaser.phased_reads_table(a))


def test_phase_long_contig_windowed_matches_jax():
    dip = make_diploid(length=24000, het_rate=0.02, seed=77,
                       het_span=(0.05, 0.95))
    rd = simulate_reads(dip, coverage=14.0, read_len=2500,
                        error_rate=0.0, seed=78)
    aln = ReadToContigAligner([dip.hap0]).align_batch(rd.batch)
    t_len = len(dip.hap0)
    kw = dict(s_win=96, long_s=64, host_tag_cap=1)
    r = ref_phaser.phase_contigs_batched(aln, [0], [t_len], **kw)[0]
    p = port_phaser.phase_contigs_batched(aln, [0], [t_len], device="cpu",
                                          **kw)[0]
    assert len(p.het_pos) > 150
    _same(r, p)


def test_windowed_phasing_rejects_degenerate_window():
    cfg = op.PhasingConfig()
    with pytest.raises(ValueError, match="must exceed"):
        port_phaser.phase_contigs_batched(None, [], [], cfg,
                                          s_win=cfg.max_span, device="cpu")
