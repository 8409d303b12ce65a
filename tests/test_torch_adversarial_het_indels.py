"""Adversarial parity: het indels through both packages' 3-unzip + 4-polish.

The het-indel fixture of ``tests/test_unzip_adversarial.py`` (a 12 kb
diploid, 1.5% het of which 30% indels, 18x error-free 2500 bp preads),
with 20x raw reads of 1800 bp at 3% error added, goes through the JAX
package's ``run_unzip`` + ``run_quiver`` and the port's on the CPU.  The
seven canonical output files must be byte-identical.  ``run_both`` is
shared with ``test_torch_adversarial_reverse_strand.py``.
"""
import os

import pytest
import torch

from falcon_unzip_tpu.config import PipelineConfig as RefConfig
from falcon_unzip_tpu.pipeline.quiver import run_quiver as ref_run_quiver
from falcon_unzip_tpu.pipeline.unzip import run_unzip as ref_run_unzip
from falcon_unzip_tpu_torch.config import PipelineConfig
from falcon_unzip_tpu_torch.io.fasta import write_fasta
from falcon_unzip_tpu_torch.pipeline.quiver import run_quiver
from falcon_unzip_tpu_torch.pipeline.unzip import run_unzip
from falcon_unzip_tpu_torch.seq import decode
from falcon_unzip_tpu_torch.utils.simulate import make_diploid, simulate_reads

# one intra-op thread: the suite runs several pytest workers on one host
torch.set_num_threads(1)

CANONICAL = ("3-unzip/all_p_ctg.fa", "3-unzip/all_h_ctg.fa",
             "3-unzip/all_phased_reads", "4-polish/cns_p_ctg.fasta",
             "4-polish/cns_h_ctg.fasta", "4-polish/cns_p_ctg.fastq",
             "4-polish/cns_h_ctg.fastq")


def run_both(d, dip, preads, raw) -> dict:
    """Both packages' unzip + quiver on one fixture written under d;
    {canonical file: (JAX package's bytes, port's bytes)}."""
    for fn, b in (("preads.fa", preads.batch), ("raw.fa", raw.batch)):
        write_fasta(f"{d}/{fn}", ((b.names[i], b.to_str(i))
                                  for i in range(len(b))))
    write_fasta(f"{d}/draft.fa", [("d0", decode(dip.hap0))])
    paths = dict(preads=f"{d}/preads.fa", reads=f"{d}/raw.fa",
                 draft=f"{d}/draft.fa")
    ref = RefConfig(**paths, out_dir=f"{d}/ref")
    ref_run_unzip(ref)
    ref_run_quiver(ref)
    port = PipelineConfig(**paths, out_dir=f"{d}/port")
    run_unzip(port, device="cpu")
    run_quiver(port, device="cpu")
    out = {}
    for rel in CANONICAL:
        with open(os.path.join(ref.out_dir, rel), "rb") as a, \
                open(os.path.join(port.out_dir, rel), "rb") as b:
            out[rel] = (a.read(), b.read())
    return out


@pytest.fixture(scope="module")
def het_indels(tmp_path_factory):
    dip = make_diploid(length=12000, het_rate=0.015, seed=31,
                       het_span=(0.3, 0.7), indel_frac=0.3)
    preads = simulate_reads(dip, coverage=18.0, read_len=2500,
                            error_rate=0.0, seed=32)
    raw = simulate_reads(dip, coverage=20.0, read_len=1800,
                         error_rate=0.03, seed=35)
    return dip, run_both(str(tmp_path_factory.mktemp("het_indels")), dip,
                         preads, raw)


def test_fixture_unzips_het_indels(het_indels):
    dip, files = het_indels
    assert len(dip.indel_pos) > 0
    assert files["3-unzip/all_h_ctg.fa"][1].count(b">") >= 1


@pytest.mark.parametrize("rel", CANONICAL)
def test_canonical_file_byte_identical(het_indels, rel):
    ref, port = het_indels[1][rel]
    assert len(port) > 0
    assert port == ref
