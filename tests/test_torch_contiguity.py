"""Contiguity parity: the thin-coverage fixtures of
``tests/test_contiguity.py`` through both packages' 3-unzip.

Two fixtures, as the reference's tests build them: a 40 kb diploid at 7x
error-free 2200 bp preads (seeds 71 / 72), whose graph has the dead ends
the draft-guided walk must bridge, and a 60 kb diploid with three 3 kb
repeats at 97% identity at 7x (seeds 81 / 82), where the gap rescues
fire inside segmental duplications.  Preads and a draft only, no raw
reads.  The JAX package's ``run_unzip`` and the port's on the CPU; the
three 3-unzip files must be byte-identical.
"""
import os

import pytest
import torch

from falcon_unzip_tpu.config import PipelineConfig as RefConfig
from falcon_unzip_tpu.pipeline.unzip import run_unzip as ref_run_unzip
from falcon_unzip_tpu_torch.config import PipelineConfig
from falcon_unzip_tpu_torch.io.fasta import write_fasta
from falcon_unzip_tpu_torch.pipeline.unzip import run_unzip
from falcon_unzip_tpu_torch.seq import decode
from falcon_unzip_tpu_torch.utils.simulate import make_diploid, simulate_reads

# one intra-op thread: the suite runs several pytest workers on one host
torch.set_num_threads(1)

FILES = ("all_p_ctg.fa", "all_h_ctg.fa", "all_phased_reads")
FIXTURES = {
    # tests/test_contiguity.py::thin_run
    "thin": (dict(length=40_000, het_rate=0.012, seed=71,
                  het_span=(0.2, 0.8)), 72),
    # tests/test_contiguity.py::repeat_thin_run
    "repeat_rescue": (dict(length=60_000, het_rate=0.015, seed=81,
                           het_span=(0.1, 0.9), n_repeats=3,
                           repeat_len=3000, repeat_identity=0.97), 82),
}


@pytest.fixture(scope="module", params=sorted(FIXTURES))
def both(request, tmp_path_factory):
    """{3-unzip file: (JAX package's bytes, port's bytes)} of a fixture."""
    dip_kw, read_seed = FIXTURES[request.param]
    d = str(tmp_path_factory.mktemp(request.param))
    dip = make_diploid(**dip_kw)
    preads = simulate_reads(dip, coverage=7.0, read_len=2200,
                            error_rate=0.0, seed=read_seed)
    write_fasta(f"{d}/preads.fa", ((preads.batch.names[i],
                                    preads.batch.to_str(i))
                                   for i in range(len(preads.batch))))
    write_fasta(f"{d}/draft.fa", [("draft0", decode(dip.hap0))])
    paths = dict(preads=f"{d}/preads.fa", draft=f"{d}/draft.fa")
    ref = RefConfig(**paths, out_dir=f"{d}/ref")
    ref_run_unzip(ref)
    port = PipelineConfig(**paths, out_dir=f"{d}/port")
    run_unzip(port, device="cpu")
    out = {}
    for name in FILES:
        with open(os.path.join(ref.out_dir, "3-unzip", name), "rb") as a, \
                open(os.path.join(port.out_dir, "3-unzip", name), "rb") as b:
            out[name] = (a.read(), b.read())
    return out


@pytest.mark.parametrize("name", FILES)
def test_unzip_file_byte_identical(both, name):
    ref, port = both[name]
    assert port.count(b">") >= 1 if name.endswith(".fa") else len(port) > 0
    assert port == ref
