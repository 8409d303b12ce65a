"""Adversarial parity: phasing on a repeat-bearing diploid, both packages.

The fixture of ``tests/test_unzip_adversarial.py::
test_repeat_phasing_stays_correct`` (a 60 kb diploid, 1.5% het over 5-95%
of its length, two 3 kb duplications at 97% identity, seed 931; 14x
error-free 2500 bp reads, seed 932) goes through the JAX package's
``ReadToContigAligner`` and ``phase_contig_device`` and the port's on the
CPU.  The AlnSets and every field of the two ContigPhasings (het sites,
alleles, blocks, orientations, the phased reads, their blocks and phases,
the pileup) must be equal, and the phased reads hap-pure as the
reference's test asks.
"""
import numpy as np
import pytest
import torch

from falcon_unzip_tpu.models.aligner import \
    ReadToContigAligner as RefAligner
from falcon_unzip_tpu.models.phaser import \
    phase_contig_device as ref_phase_contig
from falcon_unzip_tpu_torch.models.aligner import ReadToContigAligner
from falcon_unzip_tpu_torch.models.phaser import phase_contig_device
from falcon_unzip_tpu_torch.utils.simulate import make_diploid, simulate_reads

from test_torch_adversarial_repeat_multimap import aln_sets_equal

# one intra-op thread: the suite runs several pytest workers on one host
torch.set_num_threads(1)

PHASING_FIELDS = ("het_pos", "b1", "b2", "block_id", "orient", "read_ids",
                  "r_block", "r_phase", "counts")


@pytest.fixture(scope="module")
def both():
    dip = make_diploid(length=60000, het_rate=0.015, seed=931,
                       het_span=(0.05, 0.95), n_repeats=2, repeat_len=3000,
                       repeat_identity=0.97)
    rd = simulate_reads(dip, coverage=14.0, read_len=2500, error_rate=0.0,
                        seed=932)
    ref_aln = RefAligner([dip.hap0]).align_batch(rd.batch)
    port_aln = ReadToContigAligner([dip.hap0], device="cpu").align_batch(
        rd.batch)
    return (rd, ref_aln, port_aln,
            ref_phase_contig(ref_aln, 0, len(dip.hap0)),
            phase_contig_device(port_aln, 0, len(dip.hap0), device="cpu"))


def test_aln_sets_equal(both):
    _, ref, port, _, _ = both
    aln_sets_equal(ref, port)


@pytest.mark.parametrize("field", PHASING_FIELDS)
def test_phasing_equal(both, field):
    *_, ref, port = both
    assert port.ctg == ref.ctg
    assert np.array_equal(np.asarray(getattr(port, field)),
                          np.asarray(getattr(ref, field))), field


def test_phased_reads_stay_hap_pure(both):
    rd, *_, ph = both
    phased = ph.r_block >= 0
    assert phased.sum() >= 0.5 * len(ph.read_ids)
    ok = tot = 0
    for b in np.unique(ph.r_block[phased]):
        for s in (0, 1):
            sel = phased & (ph.r_block == b) & (ph.r_phase == s)
            if sel.sum() < 2:
                continue
            haps = rd.hap[ph.read_ids[sel]]
            tot += len(haps)
            ok += max((haps == 0).sum(), (haps == 1).sum())
    assert tot > 0 and ok >= 0.97 * tot, (ok, tot)
