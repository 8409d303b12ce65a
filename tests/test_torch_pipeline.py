"""Port aligner, overlapper and 3-unzip driver == the JAX package.

Bit-exact throughout: equal AlnSet / OverlapSet columns and tags, the
golden hashes of tests/test_golden.py, and every file under 3-unzip/
byte-identical to the reference's run on the same inputs (stage markers
compared without their wall time and input fingerprint, which hold
run-specific timings and paths).  The persisted AlnSet crosses between
the packages in both directions through the resume path.
"""
import dataclasses
import hashlib
import json
import os

import numpy as np
import pytest
import torch

from falcon_unzip_tpu.config import PipelineConfig
from falcon_unzip_tpu.io.fasta import write_fasta
from falcon_unzip_tpu.models import aligner as ref_aligner
from falcon_unzip_tpu.models.overlapper import PreadOverlapper as RefOverlapper
from falcon_unzip_tpu.pipeline.unzip import run_unzip as ref_run_unzip
from falcon_unzip_tpu.seq import SeqBatch, decode, revcomp
from falcon_unzip_tpu.utils.simulate import (make_diploid, random_genome,
                                             simulate_reads)
from falcon_unzip_tpu_torch.models import aligner as port_aligner
from falcon_unzip_tpu_torch.models.overlapper import PreadOverlapper
from falcon_unzip_tpu_torch.pipeline.unzip import run_unzip

# one intra-op thread: the suite runs several pytest workers on one host,
# and a torch CPU thread pool in each would oversubscribe the cores
torch.set_num_threads(1)

GOLDEN = {
    "all_p_ctg.fa": "2864673ab4dc9bf2",
    "all_h_ctg.fa": "70b2521a58bd85f1",
    "all_phased_reads": "3c3f04ee8364d5f6",
}
ALN_COLS = ("read_id", "ctg", "strand", "t_start", "t_end", "q_len", "dist",
            "q_start")


def _same_alnset(a, b):
    assert len(a) == len(b)
    for f in ALN_COLS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    for s, t in zip(a.tags, b.tags):
        assert s.dtype == t.dtype and np.array_equal(s, t)


def _aligner_cases():
    dip = make_diploid(length=6000, het_rate=0.0, seed=2)
    noisy = simulate_reads(dip, coverage=4.0, read_len=1200,
                           error_rate=0.1, seed=3).batch
    dip2 = make_diploid(length=4000, het_rate=0.0, seed=4)
    rc = SeqBatch.from_strs([decode(revcomp(dip2.hap0[1000:2500]))])
    ca, cb = random_genome(5000, 901), random_genome(5000, 902)
    chim = SeqBatch.from_strs([
        decode(np.concatenate([ca[1000:2500], cb[2000:3500]])),
        decode(ca[3000:4600])])
    return [("noisy", [dip.hap0], noisy, 1), ("revcomp", [dip2.hap0], rc, 1),
            ("chimeric", [ca, cb], chim, 2)]


@pytest.mark.parametrize("case", range(3))
def test_align_batch_matches_jax(case):
    _, contigs, batch, hits = _aligner_cases()[case]
    cfg = ref_aligner.AlignerConfig(max_hits_per_read=hits)
    r = ref_aligner.ReadToContigAligner(contigs, cfg).align_batch(batch)
    p = port_aligner.ReadToContigAligner(
        contigs, dataclasses.replace(cfg), device="cpu").align_batch(batch)
    assert len(p) >= 1
    _same_alnset(r.sort_canonical(), p.sort_canonical())


def test_alnset_blobs_cross_reload():
    _, contigs, batch, _ = _aligner_cases()[0]
    r = ref_aligner.ReadToContigAligner(contigs).align_batch(batch)
    p = port_aligner.AlnSet.from_bytes(r.to_bytes())
    _same_alnset(r, p)
    back = ref_aligner.AlnSet.from_bytes(p.to_bytes())
    _same_alnset(r, back)
    assert p.to_bytes() == r.to_bytes()


def test_overlapper_matches_jax():
    dip = make_diploid(length=8000, het_rate=0.01, seed=31)
    reads = simulate_reads(dip, coverage=10.0, read_len=1500,
                           error_rate=0.02, seed=32).batch
    r = RefOverlapper(reads).compute()
    po = PreadOverlapper(reads, device="cpu")
    p = po.compute()
    assert len(p) > 50 and po.timings["n_overlaps"] == len(p)
    for f in p._COLS:
        x, y = getattr(r, f), getattr(p, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f


def _inputs(d):
    """The golden fixture of tests/test_golden.py (preads + draft)."""
    dip = make_diploid(length=6000, het_rate=0.02, seed=77,
                       het_span=(0.3, 0.7))
    pr = simulate_reads(dip, coverage=14.0, read_len=1800,
                        error_rate=0.0, seed=78)
    write_fasta(f"{d}/preads.fa",
                ((pr.batch.names[i], pr.batch.to_str(i))
                 for i in range(len(pr.batch))))
    write_fasta(f"{d}/draft.fa", [("d0", decode(dip.hap0))])


def _files(out_dir):
    """{relative path: comparable bytes} of every file under 3-unzip/."""
    root = os.path.join(out_dir, "3-unzip")
    got = {}
    for base, _, names in os.walk(root):
        for nm in names:
            path = os.path.join(base, nm)
            with open(path, "rb") as fh:
                data = fh.read()
            if nm == "stage.done.json":
                meta = json.loads(data)
                meta.pop("wall_s")
                meta.pop("fingerprint")
                data = json.dumps(meta, sort_keys=True).encode()
            got[os.path.relpath(path, root)] = data
    return got


def _cfg(d, out):
    return PipelineConfig(preads=f"{d}/preads.fa", draft=f"{d}/draft.fa",
                          out_dir=f"{d}/{out}")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("golden"))
    _inputs(d)
    ref_run_unzip(_cfg(d, "ref"))
    run_unzip(_cfg(d, "port"), device="cpu")
    return d, _files(f"{d}/ref"), _files(f"{d}/port")


def test_run_unzip_golden_and_byte_identical(runs):
    _, ref_files, port_files = runs
    for rel, want in GOLDEN.items():
        got = hashlib.sha256(port_files[rel]).hexdigest()[:16]
        assert got == want, rel
    assert sorted(port_files) == sorted(ref_files)
    assert "1-align/aln_set.msgpack" in port_files
    for rel in ref_files:
        assert port_files[rel] == ref_files[rel], rel


def _reloaded(out_dir) -> bool:
    with open(os.path.join(out_dir, "metrics.jsonl")) as fh:
        return any(json.loads(ln)["stage"] == "align_reload" for ln in fh)


def test_port_resume_reloads_jax_alnset(runs):
    d, ref_files, _ = runs
    os.remove(f"{d}/ref/3-unzip/all_phased_reads")
    run_unzip(_cfg(d, "ref"), device="cpu")
    assert _reloaded(f"{d}/ref")
    got = _files(f"{d}/ref")
    for rel in ref_files:
        assert got[rel] == ref_files[rel], rel


def test_jax_resume_reloads_port_alnset(runs):
    d, _, port_files = runs
    os.remove(f"{d}/port/3-unzip/all_phased_reads")
    ref_run_unzip(_cfg(d, "port"))
    assert _reloaded(f"{d}/port")
    got = _files(f"{d}/port")
    for rel in port_files:
        assert got[rel] == port_files[rel], rel


def test_unported_options_raise(tmp_path):
    cfg = _cfg(str(tmp_path), "out")
    cfg.mesh.n_devices = 2
    with pytest.raises(NotImplementedError):
        run_unzip(cfg, device="cpu")
    cfg = _cfg(str(tmp_path), "out")
    cfg.profile_dir = str(tmp_path)
    with pytest.raises(NotImplementedError):
        run_unzip(cfg, device="cpu")
    cfg = _cfg(str(tmp_path), "out")
    cfg.mesh.multihost = True
    with pytest.raises(NotImplementedError):
        run_unzip(cfg, device="cpu")
