"""Adversarial parity: chimeric reads through both packages' aligner.

The fixture of ``tests/test_unzip_adversarial.py::
test_chimeric_reads_align_single_segment`` (a 40 kb haploid, seed 921; 6x
error-free 3000 bp reads, every one a chimera, seed 922) goes through the
JAX package's ``ReadToContigAligner`` and the port's on the CPU with the
default config.  Every field of the two AlnSets must be equal.
"""
import pytest
import torch

from falcon_unzip_tpu.models.aligner import \
    ReadToContigAligner as RefAligner
from falcon_unzip_tpu_torch.models.aligner import ReadToContigAligner
from falcon_unzip_tpu_torch.utils.simulate import make_diploid, simulate_reads

from test_torch_adversarial_repeat_multimap import aln_sets_equal

# one intra-op thread: the suite runs several pytest workers on one host
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def both():
    dip = make_diploid(length=40000, het_rate=0.0, seed=921)
    rd = simulate_reads(dip, coverage=6.0, read_len=3000, error_rate=0.0,
                        seed=922, chimera_frac=1.0)
    return (rd, RefAligner([dip.hap0]).align_batch(rd.batch),
            ReadToContigAligner([dip.hap0], device="cpu").align_batch(
                rd.batch))


def test_reads_are_chimeric_and_align(both):
    rd, _, aln = both
    assert rd.chimera.all()
    assert len(aln) > 0


def test_aln_sets_equal(both):
    _, ref, port = both
    aln_sets_equal(ref, port)
