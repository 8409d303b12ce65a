"""Profiler traces of the port's drivers (utils/profiling.py).

``run_unzip`` and ``run_quiver`` with ``cfg.profile_dir`` set write one
Chrome trace a run into it (the two runs share the directory and keep
both traces), and leave every artifact byte-identical to an untraced run
on the same inputs.  The untraced run's ``metrics.jsonl`` holds the rows
it held before the span recorder, with the same keys; the traced run's
holds them too, then a row a span: children inside their parents, the
overlap compute on the prefetch's own thread, on the wall clock read
around the call.
"""
import glob
import json
import time

import pytest
import torch

from falcon_unzip_tpu_torch.config import PipelineConfig
from falcon_unzip_tpu_torch.io.fasta import write_fasta
from falcon_unzip_tpu_torch.pipeline.quiver import run_quiver
from falcon_unzip_tpu_torch.pipeline.unzip import run_unzip
from falcon_unzip_tpu_torch.seq import decode
from falcon_unzip_tpu_torch.utils.fixtures import run_artifacts
from falcon_unzip_tpu_torch.utils.profiling import (device_trace, drain,
                                                    span)
from falcon_unzip_tpu_torch.utils.simulate import (make_diploid,
                                                   simulate_reads)

# one intra-op thread: the suite runs several pytest workers on one host
torch.set_num_threads(1)

# (stage, keys) of each row an untraced run_unzip + run_quiver of the
# fixture writes: the rows and keys from before the span recorder
ALIGN = ["dispatch_s", "fetch_s", "jobs_s", "n_jobs", "pack_s", "post_s",
         "s", "seed_s"]
STATS = ["h", "p"]
ROWS = [
    ("align_compute", ALIGN),
    ("align", ["n_aligned", "n_reads"]),
    ("phasing_total", ["n_ctgs", "s"]),
    ("phasing", ["block_n50", "ctg", "n_blocks", "n_het",
                 "n_phased_sites"]),
    ("hasm_overlaps", ["cand_s", "dispatch_s", "emit_s", "fetch_s",
                       "n_cands", "n_overlaps", "pack_s", "s"]),
    ("ovlp_filter", ["n_kept", "n_overlaps"]),
    ("hasm_graph_walk", ["n_fills", "n_rescues", "s"]),
    ("hasm_dedup", ["s"]),
    ("hasm_placement", ["s"]),
    ("unzip", STATS),
    ("align_compute", ALIGN),
    ("polish_phase_route", ["n_dropped", "s"]),
    ("polish_windows", ["s"]),
    ("polish", ["h", "mean_qv", "p"]),
]
ROOTS = {"unzip": "run_unzip", "quiver": "run_quiver"}
STAGES = {"run_unzip": ["stage.0-draft", "stage.1-align", "stage.2-phasing",
                        "stage.3-hasm"],
          "run_quiver": ["stage.1-track", "stage.2-polish"]}


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
    walls = {}
    for out, pdir in (("plain", ""), ("traced", prof)):
        for name, call in (("unzip", run_unzip), ("quiver", run_quiver)):
            t = time.time()
            call(_cfg(d, out, pdir), device="cpu")
            walls[out, name] = (t, time.time())
    return d, prof, walls


def _rows(d, out):
    with open(f"{d}/{out}/metrics.jsonl") as fh:
        return [json.loads(ln) for ln in fh]


def _shape(rows):
    return [(r["stage"], sorted(set(r) - {"stage", "ts"})) for r in rows]


def test_one_trace_a_run(runs):
    _, prof, _ = runs
    for stage in ("unzip", "quiver"):
        paths = glob.glob(f"{prof}/{stage}.*.pt.trace.json")
        assert len(paths) == 1, paths
        with open(paths[0]) as fh:
            trace = json.load(fh)
        assert trace["traceEvents"], stage
        # the spans' record_function ranges are on the profiler's timeline
        names = {e.get("name") for e in trace["traceEvents"]}
        root = ROOTS[stage]
        assert {root, *STAGES[root]} <= names, stage


def test_traced_artifacts_byte_identical(runs):
    d, _, _ = runs
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
    files; a span inside each is timed and kept once a trace."""
    drain()
    for _ in range(2):
        with device_trace(str(tmp_path), "cpu", "x"), span("mm") as sp:
            torch.ones(8, 8) @ torch.ones(8, 8)
        assert sp.s > 0
    assert len(glob.glob(f"{tmp_path}/x.*.pt.trace.json")) == 2
    assert [r["stage"] for r in drain()] == ["mm", "mm"]


def test_untraced_run_writes_the_rows_of_before(runs):
    d, _, _ = runs
    assert _shape(_rows(d, "plain")) == ROWS


def test_traced_run_adds_a_row_a_span(runs):
    """The rows of before, each with its keys, then one row a span; no
    span is named as a row of before (the readers sum rows by name)."""
    d, _, _ = runs
    rows = _rows(d, "traced")
    old = [r for r in rows if "id" not in r]
    spans = [r for r in rows if "id" in r]
    assert _shape(old) == ROWS
    assert not {r["stage"] for r in spans} & {name for name, _ in ROWS}
    names = [r["stage"] for r in spans]
    for root, stages in STAGES.items():
        assert names.count(root) == 1
        for st in stages:
            assert names.count(st) == 1, st
    for name in ("overlap.compute", "hasm.join_wait", "align.compute",
                 "overlap.cand", "align.seed", "polish.windows"):
        assert name in names, name
    # an existing row takes its seconds from its span: same number
    by_name = {r["stage"]: r for r in spans}
    hasm = next(r for r in old if r["stage"] == "hasm_graph_walk")
    assert hasm["s"] == round(by_name["hasm.graph_walk"]["s"], 2)


def test_spans_nest_on_their_threads_and_the_wall_clock(runs):
    d, _, walls = runs
    spans = [r for r in _rows(d, "traced") if "id" in r]
    by_id = {r["id"]: r for r in spans}
    for r in spans:
        assert r["ts"] >= r["t0"] and r["s"] >= 0
        assert r["cpu_s"] <= r["s"], r
        if r["parent"] is None:
            assert r["stage"] in ROOTS.values() and "proc_cpu_s" in r
            continue
        p = by_id[r["parent"]]
        assert p["t0"] <= r["t0"] and r["ts"] <= p["ts"], (r, p)
    for part, root in ROOTS.items():
        a, b = walls["traced", part]
        rows = [r for r in spans if r["stage"] == root]
        # one anchor a process maps perf_counter onto time.time
        assert a - 1e-3 <= rows[0]["t0"] <= rows[0]["ts"] <= b + 1e-3
    name = {r["stage"]: r for r in spans}
    ovl, align = name["overlap.compute"], name["stage.1-align"]
    assert ovl["thread"] != align["thread"] == "MainThread"
    assert by_id[ovl["parent"]]["stage"] == "run_unzip"
