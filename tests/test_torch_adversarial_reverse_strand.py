"""Adversarial parity: reverse-strand reads through both packages'
3-unzip + 4-polish.

The reverse-strand fixture of ``tests/test_unzip_adversarial.py`` (a
10 kb diploid at 2% het, 18x error-free 2500 bp preads, half of them
reverse-complemented), with 20x raw reads of 1800 bp at 3% error added,
also half reverse-complemented, goes through the JAX package's
``run_unzip`` + ``run_quiver`` and the port's on the CPU.  The seven
canonical output files must be byte-identical.
"""
import pytest
from test_torch_adversarial_het_indels import CANONICAL, run_both

from falcon_unzip_tpu_torch.utils.simulate import make_diploid, simulate_reads


@pytest.fixture(scope="module")
def reverse_strand(tmp_path_factory):
    dip = make_diploid(length=10000, het_rate=0.02, seed=33,
                       het_span=(0.3, 0.7))
    preads = simulate_reads(dip, coverage=18.0, read_len=2500,
                            error_rate=0.0, seed=34, rc_frac=0.5)
    raw = simulate_reads(dip, coverage=20.0, read_len=1800,
                         error_rate=0.03, seed=36, rc_frac=0.5)
    return preads, raw, run_both(str(tmp_path_factory.mktemp("rc")), dip,
                                 preads, raw)


def test_fixture_has_reverse_strand_reads(reverse_strand):
    preads, raw, files = reverse_strand
    assert preads.strand.sum() > 5 and raw.strand.sum() > 5
    assert files["3-unzip/all_h_ctg.fa"][1].count(b">") >= 1


@pytest.mark.parametrize("rel", CANONICAL)
def test_canonical_file_byte_identical(reverse_strand, rel):
    ref, port = reverse_strand[2][rel]
    assert len(port) > 0
    assert port == ref
