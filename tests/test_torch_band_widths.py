"""Band widths off the card kernels' old five through both packages.

A 9 kb diploid (1.5% het, 16x error-free 2200 bp preads, 20x raw reads of
1800 bp at 3% error, seeds 40-42) goes through the JAX package's
``run_unzip`` + ``run_quiver`` and the port's on the CPU at two band
configurations: ``[align] band = 384`` with ``[overlap] band = 200``, and
``[align] band = 768`` (haplotig
placement then runs at ``max(512, band)`` = 768).  The seven canonical
3-unzip and 4-polish files must be byte-identical.  FalconSense at
``ConsensusConfig(band=96)`` on a short template must give the same
consensus in both packages.  On the card these widths run on wider
layouts with the cells past W held out of the band (``csrc/``); here the
plain versions run them.
"""
import os

import numpy as np
import pytest
import torch

from falcon_unzip_tpu.config import PipelineConfig as RefConfig
from falcon_unzip_tpu.models.consensus import ConsensusConfig as RefCC
from falcon_unzip_tpu.models.consensus import FalconSense as RefFalconSense
from falcon_unzip_tpu.pipeline.quiver import run_quiver as ref_run_quiver
from falcon_unzip_tpu.pipeline.unzip import run_unzip as ref_run_unzip
from falcon_unzip_tpu_torch.config import (AlignCfg, OverlapCfg,
                                           PipelineConfig)
from falcon_unzip_tpu_torch.io.fasta import write_fasta
from falcon_unzip_tpu_torch.models.consensus import (ConsensusConfig,
                                                     FalconSense)
from falcon_unzip_tpu_torch.pipeline.quiver import run_quiver
from falcon_unzip_tpu_torch.pipeline.unzip import run_unzip
from falcon_unzip_tpu_torch.seq import decode
from falcon_unzip_tpu_torch.utils.fixtures import template_reads
from falcon_unzip_tpu_torch.utils.simulate import make_diploid, simulate_reads

# one intra-op thread: the suite runs several pytest workers on one host
torch.set_num_threads(1)

CANONICAL = ("3-unzip/all_p_ctg.fa", "3-unzip/all_h_ctg.fa",
             "3-unzip/all_phased_reads", "4-polish/cns_p_ctg.fasta",
             "4-polish/cns_h_ctg.fasta", "4-polish/cns_p_ctg.fastq",
             "4-polish/cns_h_ctg.fastq")
# (name, [align] band, [overlap] band)
BANDS = (("align384_overlap200", 384, 200), ("align768", 768, 256))


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("band_widths"))
    dip = make_diploid(length=9000, het_rate=0.015, seed=40,
                       het_span=(0.3, 0.7))
    pr = simulate_reads(dip, coverage=16.0, read_len=2200, error_rate=0.0,
                        seed=41)
    raw = simulate_reads(dip, coverage=20.0, read_len=1800, error_rate=0.03,
                         seed=42)
    for fn, b in (("preads.fa", pr.batch), ("raw.fa", raw.batch)):
        write_fasta(f"{d}/{fn}", ((b.names[i], b.to_str(i))
                                  for i in range(len(b))))
    write_fasta(f"{d}/draft.fa", [("draft0", decode(dip.hap0))])
    return d


@pytest.fixture(scope="module", params=BANDS, ids=[b[0] for b in BANDS])
def outputs(request, inputs):
    """{canonical file: (JAX package's bytes, port's bytes)} at one band
    configuration."""
    name, align_band, overlap_band = request.param
    d = inputs
    paths = dict(preads=f"{d}/preads.fa", reads=f"{d}/raw.fa",
                 draft=f"{d}/draft.fa")
    ref = RefConfig(**paths, out_dir=f"{d}/{name}/ref")
    ref.align.band = align_band
    ref.overlap.band = overlap_band
    ref_run_unzip(ref)
    ref_run_quiver(ref)
    port = PipelineConfig(**paths, out_dir=f"{d}/{name}/port",
                          align=AlignCfg(band=align_band),
                          overlap=OverlapCfg(band=overlap_band))
    run_unzip(port, device="cpu")
    run_quiver(port, device="cpu")
    out = {}
    for rel in CANONICAL:
        with open(os.path.join(ref.out_dir, rel), "rb") as a, \
                open(os.path.join(port.out_dir, rel), "rb") as b:
            out[rel] = (a.read(), b.read())
    return out


def test_band_configurations_unzip_and_polish(outputs):
    assert outputs["3-unzip/all_p_ctg.fa"][1].count(b">") >= 1
    # haplotigs, so that placement ran (at max(512, [align] band))
    assert outputs["3-unzip/all_h_ctg.fa"][1].count(b">") >= 1
    assert len(outputs["4-polish/cns_p_ctg.fasta"][1]) > 8000


@pytest.mark.parametrize("rel", CANONICAL)
def test_canonical_file_byte_identical(outputs, rel):
    ref, port = outputs[rel]
    assert len(port) > 0
    assert port == ref


def test_falcon_sense_band_96_matches_jax():
    """FalconSense at band 96 (a ragged width on the card: its layout is
    128 wide) on a 6 kb template with 10 reads at 8%, half
    reverse-complemented: the same consensus in both packages."""
    _, template, reads, _ = template_reads(6000, 10, seed=44)
    got = FalconSense(ConsensusConfig(band=96), "cpu")(template, reads)
    want = np.asarray(RefFalconSense(RefCC(band=96))(template, reads))
    assert len(want) > 5000
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
