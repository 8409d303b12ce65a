"""Multi-contig parity: three 9 kb diploids through both packages.

The fixture of ``tests/test_integration_multicontig.py`` (three diploids
of 9 kb, 1.2% het over 25-75% of each, seeds 60-62; 14x error-free 2200 bp
preads, seeds 70-72; 18x raw reads of 1800 bp at 3% error, seeds 80-82;
one draft contig each) goes through the JAX package's ``run_unzip`` +
``run_quiver`` and the port's on the CPU.  The seven canonical 3-unzip and
4-polish files must be byte-identical, with a haplotig on each contig as
the reference's test asks.
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

from test_torch_adversarial_het_indels import CANONICAL

# one intra-op thread: the suite runs several pytest workers on one host
torch.set_num_threads(1)

N_CTG = 3
CTG_LEN = 9000


@pytest.fixture(scope="module")
def multi(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("multi"))
    pread_recs, raw_recs, draft_recs = [], [], []
    for i in range(N_CTG):
        dip = make_diploid(length=CTG_LEN, het_rate=0.012, seed=60 + i,
                           het_span=(0.25, 0.75))
        pr = simulate_reads(dip, coverage=14.0, read_len=2200,
                            error_rate=0.0, seed=70 + i)
        rw = simulate_reads(dip, coverage=18.0, read_len=1800,
                            error_rate=0.03, seed=80 + i)
        pread_recs += [(f"c{i}_{pr.batch.names[k]}", pr.batch.to_str(k))
                       for k in range(len(pr.batch))]
        raw_recs += [(f"c{i}_{rw.batch.names[k]}", rw.batch.to_str(k))
                     for k in range(len(rw.batch))]
        draft_recs.append((f"draft{i}", decode(dip.hap0)))
    write_fasta(f"{d}/preads.fa", pread_recs)
    write_fasta(f"{d}/raw.fa", raw_recs)
    write_fasta(f"{d}/draft.fa", draft_recs)
    paths = dict(preads=f"{d}/preads.fa", reads=f"{d}/raw.fa",
                 draft=f"{d}/draft.fa")
    ref = RefConfig(**paths, out_dir=f"{d}/ref")
    ref_res = ref_run_unzip(ref)
    ref_run_quiver(ref)
    port = PipelineConfig(**paths, out_dir=f"{d}/port")
    port_res = run_unzip(port, device="cpu")
    run_quiver(port, device="cpu")
    out = {}
    for rel in CANONICAL:
        with open(os.path.join(ref.out_dir, rel), "rb") as a, \
                open(os.path.join(port.out_dir, rel), "rb") as b:
            out[rel] = (a.read(), b.read())
    return ref_res, port_res, out


def test_multicontig_unzip_counts(multi):
    ref_res, port_res, _ = multi
    assert port_res["p_ctg"]["total_bp"] > 0.85 * N_CTG * CTG_LEN
    assert port_res["p_ctg"]["n_seqs"] >= N_CTG
    assert port_res["h_ctg"]["n_seqs"] >= N_CTG
    for k in ("p_ctg", "h_ctg"):
        assert port_res[k] == ref_res[k], k


@pytest.mark.parametrize("rel", CANONICAL)
def test_canonical_file_byte_identical(multi, rel):
    ref, port = multi[2][rel]
    assert len(port) > 0
    assert port == ref
