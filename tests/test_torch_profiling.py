"""Profiler traces of the port's drivers (utils/profiling.py).

``run_unzip`` and ``run_quiver`` with ``cfg.profile_dir`` set write one
Chrome trace a run into it (the two runs share the directory and keep
both traces), and leave every artifact byte-identical to an untraced run
on the same inputs.
"""
import glob
import json

import pytest
import torch

from falcon_unzip_tpu_torch.config import PipelineConfig
from falcon_unzip_tpu_torch.io.fasta import write_fasta
from falcon_unzip_tpu_torch.pipeline.quiver import run_quiver
from falcon_unzip_tpu_torch.pipeline.unzip import run_unzip
from falcon_unzip_tpu_torch.seq import decode
from falcon_unzip_tpu_torch.utils.fixtures import run_artifacts
from falcon_unzip_tpu_torch.utils.profiling import StageTimer, device_trace
from falcon_unzip_tpu_torch.utils.simulate import (make_diploid,
                                                   simulate_reads)

# one intra-op thread: the suite runs several pytest workers on one host
torch.set_num_threads(1)


def _cfg(d, out, profile_dir=""):
    """preads + draft, as tests/test_torch_pipeline.py::_cfg (the quiver
    polishes with the preads)."""
    return PipelineConfig(preads=f"{d}/preads.fa", draft=f"{d}/draft.fa",
                          out_dir=f"{d}/{out}", profile_dir=profile_dir)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("prof"))
    # small: on the CPU every op of the plain DP versions is traced
    dip = make_diploid(length=2000, het_rate=0.02, seed=61,
                       het_span=(0.3, 0.7))
    pr = simulate_reads(dip, coverage=8.0, read_len=900, error_rate=0.0,
                        seed=62)
    write_fasta(f"{d}/preads.fa",
                ((pr.batch.names[i], pr.batch.to_str(i))
                 for i in range(len(pr.batch))))
    write_fasta(f"{d}/draft.fa", [("d0", decode(dip.hap0))])
    prof = f"{d}/traces"
    for out, pdir in (("plain", ""), ("traced", prof)):
        run_unzip(_cfg(d, out, pdir), device="cpu")
        run_quiver(_cfg(d, out, pdir), device="cpu")
    return d, prof


def test_one_trace_a_run(runs):
    _, prof = runs
    for stage in ("unzip", "quiver"):
        paths = glob.glob(f"{prof}/{stage}.*.pt.trace.json")
        assert len(paths) == 1, paths
        with open(paths[0]) as fh:
            trace = json.load(fh)
        assert trace["traceEvents"], stage


def test_traced_artifacts_byte_identical(runs):
    d, _ = runs
    plain = run_artifacts(f"{d}/plain")
    traced = run_artifacts(f"{d}/traced")
    assert {"3-unzip/all_p_ctg.fa", "3-unzip/all_h_ctg.fa",
            "4-polish/cns_p_ctg.fasta",
            "4-polish/cns_h_ctg.fasta"} <= set(plain)
    assert sorted(traced) == sorted(plain)
    for rel in plain:
        assert traced[rel] == plain[rel], rel


def test_device_trace_names_and_stage_timer(tmp_path):
    """Two traces into one directory under the same name stay two
    files."""
    timer = StageTimer()
    for _ in range(2):
        with device_trace(str(tmp_path), "cpu", "x"), timer.span("mm"):
            torch.ones(8, 8) @ torch.ones(8, 8)
    assert len(glob.glob(f"{tmp_path}/x.*.pt.trace.json")) == 2
    assert list(timer.summary()) == ["mm"]
