"""Adversarial parity: repeat multimapping through both packages' aligner.

The fixture of ``tests/test_unzip_adversarial.py::
test_repeat_multimapping_places_true_locus`` (a 60 kb haploid with two 3 kb
segmental duplications at 97% identity, seed 911; 10x error-free 2500 bp
reads, seed 912) goes through the JAX package's ``ReadToContigAligner``
with ``max_hits_per_read = 4`` and the port's on the CPU.  Every field of
the two AlnSets (records in the same order, every tag array) must be
equal, with secondary hits present as the reference's test asks.
"""
import numpy as np
import pytest
import torch

from falcon_unzip_tpu.models.aligner import AlignerConfig as RefAlignerConfig
from falcon_unzip_tpu.models.aligner import \
    ReadToContigAligner as RefAligner
from falcon_unzip_tpu_torch.models.aligner import (AlignerConfig,
                                                   ReadToContigAligner)
from falcon_unzip_tpu_torch.utils.simulate import make_diploid, simulate_reads

# one intra-op thread: the suite runs several pytest workers on one host
torch.set_num_threads(1)

ALN_FIELDS = ("read_id", "ctg", "strand", "t_start", "t_end", "q_len",
              "dist", "q_start")


def aln_sets_equal(ref, port) -> None:
    """Every column and every record's tags equal, in the same order."""
    assert len(port) == len(ref)
    for f in ALN_FIELDS:
        assert np.array_equal(np.asarray(getattr(port, f)),
                              np.asarray(getattr(ref, f))), f
    assert len(port.tags) == len(ref.tags)
    for k, (a, b) in enumerate(zip(ref.tags, port.tags)):
        assert np.array_equal(np.asarray(b), np.asarray(a)), k


@pytest.fixture(scope="module")
def both():
    dip = make_diploid(length=60000, het_rate=0.0, seed=911, n_repeats=2,
                       repeat_len=3000, repeat_identity=0.97)
    rd = simulate_reads(dip, coverage=10.0, read_len=2500, error_rate=0.0,
                        seed=912)
    ref = RefAligner([dip.hap0], RefAlignerConfig(max_hits_per_read=4))
    port = ReadToContigAligner([dip.hap0], AlignerConfig(max_hits_per_read=4),
                               device="cpu")
    return dip, ref.align_batch(rd.batch), port.align_batch(rd.batch)


def test_secondary_hits_surface(both):
    dip, _, aln = both
    assert len(dip.repeat_src) == 2
    assert sum(1 for r in set(aln.read_id.tolist())
               if (aln.read_id == r).sum() > 1) > 0


def test_aln_sets_equal(both):
    _, ref, port = both
    aln_sets_equal(ref, port)
