"""The port's full pipeline over an 8-shard mesh == the golden outputs.

``run_unzip`` + ``run_quiver`` of the port on the CPU with
``cfg.mesh.n_devices = 8`` (a 4 x 2 mesh of logical shards, so the
window-sharded votes run as well as the sharded phasing and Arrow
splice) on the golden fixture of tests/test_golden.py, with the
sharding-invariant debug checks on: the five golden hashes must hold.
"""
import collections
import hashlib
import os

import torch

from falcon_unzip_tpu.io.fasta import write_fasta
from falcon_unzip_tpu.seq import decode
from falcon_unzip_tpu.utils.simulate import make_diploid, simulate_reads
from falcon_unzip_tpu_torch.config import MeshCfg, PipelineConfig
from falcon_unzip_tpu_torch.parallel import debug
from falcon_unzip_tpu_torch.pipeline.quiver import run_quiver
from falcon_unzip_tpu_torch.pipeline.unzip import run_unzip
from test_golden import GOLDEN

torch.set_num_threads(1)


def _golden_inputs(d):
    """The inputs of tests/test_golden.py, whose GOLDEN hashes they
    must reproduce (a change of its inputs fails here through them)."""
    dip = make_diploid(length=6000, het_rate=0.02, seed=77,
                       het_span=(0.3, 0.7))
    pr = simulate_reads(dip, coverage=14.0, read_len=1800,
                        error_rate=0.0, seed=78)
    raw = simulate_reads(dip, coverage=16.0, read_len=1500,
                         error_rate=0.03, seed=79)
    for fn, b in (("preads.fa", pr.batch), ("raw.fa", raw.batch)):
        write_fasta(f"{d}/{fn}",
                    ((b.names[i], b.to_str(i)) for i in range(len(b))))
    write_fasta(f"{d}/draft.fa", [("d0", decode(dip.hap0))])


def test_sharded_pipeline_matches_golden(tmp_path, monkeypatch):
    from falcon_unzip_tpu_torch.parallel import sharding
    d = str(tmp_path)
    _golden_inputs(d)
    cfg = PipelineConfig(preads=f"{d}/preads.fa", reads=f"{d}/raw.fa",
                         draft=f"{d}/draft.fa", out_dir=f"{d}/out",
                         mesh=MeshCfg(n_devices=8, debug_sharding=True))
    meshes = []
    real = sharding.make_pipeline_mesh
    monkeypatch.setattr(sharding, "make_pipeline_mesh",
                        lambda *a, **k: meshes.append(real(*a, **k))
                        or meshes[-1])
    calls = collections.Counter()
    for cls, name in ((sharding.ShardedPhaseOps, "pileup"),
                      (sharding.ShardedPhaseOps, "association"),
                      (sharding.ShardedArrowSplicer, "_dispatch"),
                      (sharding.ShardedWindowVotes, "blocks")):
        def counted(self, *a, _f=getattr(cls, name), _n=name, **k):
            calls[_n] += 1
            return _f(self, *a, **k)
        monkeypatch.setattr(cls, name, counted)
    try:
        run_unzip(cfg, device="cpu")
        run_quiver(cfg, device="cpu")
    finally:
        debug.enable(None)
    assert [dict(m.shape) for m in meshes] == [{"data": 4, "window": 2}] * 2
    # every sharded op ran (under the debug checks)
    assert set(calls) == {"pileup", "association", "_dispatch", "blocks"}
    mismatches = []
    for rel, want in GOLDEN.items():
        with open(os.path.join(d, "out", rel), "rb") as fh:
            got = hashlib.sha256(fh.read()).hexdigest()[:16]
        if got != want:
            mismatches.append(f"{rel}: got {got}, golden {want}")
    assert not mismatches, mismatches
