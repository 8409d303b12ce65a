"""Each cell end to end at a tiny size on the CPU, and the faults that
must turn ``correct`` false.

The CPU runs skip the harness's look for a card (``device="cpu"``) and
drive the rest of a run: slots, window, metrics and the comparison with
the reference.  A fault, and the stand-in program that the assembly cell
runs here (``faults.asm_oracle``: the port's plain DP takes minutes a
kilobase on the CPU), are driver files of their own, written into a copy
of the benchmark and named by the traffic mix (``faults.driver_file``);
``test_bench_port_cpu.py`` runs the assembly cell on the port itself.
FalconSense runs the port's own, on 3 kb seed reads.
"""
import json
import os
import shutil

import pytest

from benchmark import run
from benchmark.tests import faults

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]
ASM = {"config": {"genome_bp": 40_000},
       "traffic": {"slots": 2, "warmup_bp": 4000}}
CNS = {"config": {"length": 24_000, "read_len": 3000},
       "traffic": {"slots": 2, "scored": 3}}
TINY = {"n50_25x.unzip_polish": ASM, "ecoli_20x.falconsense": CNS}
BASE = {"n50_25x.unzip_polish": "assembly",
        "ecoli_20x.falconsense": "falconsense"}
STAND_IN = {"n50_25x.unzip_polish": "asm_oracle",
            "ecoli_20x.falconsense": None}


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    """A copy of the benchmark (BENCHMARK.json and benchmark/) to which
    fault drivers are added."""
    root = tmp_path_factory.mktemp("checkout")
    shutil.copy(os.path.join(run.ROOT, "BENCHMARK.json"), root)
    shutil.copytree(os.path.join(run.ROOT, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    return root


def run_line(capsys, cell, root, fault=None, trace=0, seed=3_000_000_019,
             **kw) -> dict:
    over = {k: dict(v) for k, v in TINY[cell].items()}
    fault = fault or STAND_IN[cell]
    if fault:
        over["traffic"]["driver"] = faults.driver_file(
            str(root / "benchmark"), BASE[cell], fault)
    rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds",
                   "1", "--trace", str(trace)], device="cpu",
                  overrides=over, root=str(root), **kw)
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0, out
    return json.loads(out[-1])


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", sorted(TINY))
def test_cell_runs_and_prints_the_result_line(capsys, checkout, cell,
                                              trace):
    line = run_line(capsys, cell, checkout, trace=trace)
    keys = list(line)
    assert keys[:5] == KEYS[:5] and keys[-1] == "checks"
    assert set(keys) <= set(KEYS) | {"breakdown"}
    assert ("breakdown" in keys) == bool(trace)
    assert line["correct"] is True, line
    assert line["attempted"] >= 2 and line["failed"] == 0
    spec = run.cell_spec(cell)
    if trace:                          # device metrics: none from a CPU run
        assert set(line["metrics"]) <= {m["name"] for m in spec["per_layer"]}
        assert not any(k.startswith(("device_idle", "wavefront", "arrow"))
                       for k in line["metrics"])
    else:
        assert sorted(line["metrics"]) == sorted(m["name"]
                                                 for m in spec["end_to_end"])
        assert all(v["value"] > 0 for v in line["metrics"].values())
    assert line["device"]["platform"] == "cpu"
    for name, c in line["checks"].items():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]


@pytest.mark.parametrize("cell, fault, check", [
    ("n50_25x.unzip_polish", "asm_unphased", "phase_err_pct"),
    ("n50_25x.unzip_polish", "asm_phase_swapped", "phase_err_pct"),
    ("n50_25x.unzip_polish", "asm_half", "p_span_err_pct"),
    ("n50_25x.unzip_polish", "asm_altered", "cns_err_per_mb"),
    ("n50_25x.unzip_polish", "asm_polish_returns_input", "cns_err_per_mb"),
    ("n50_25x.unzip_polish", "asm_haplotig_primary_alleles",
     "allele_miss_pct"),
    ("ecoli_20x.falconsense", "cns_unchanged", "cns_err_pct"),
    ("ecoli_20x.falconsense", "cns_half", "cns_err_pct"),
    ("ecoli_20x.falconsense", "cns_altered", "cns_err_pct"),
])
def test_a_broken_timed_path_is_not_correct(capsys, checkout, cell, fault,
                                            check):
    line = run_line(capsys, cell, checkout, fault=fault)
    assert line["correct"] is False
    c = line["checks"][check]
    assert c["value"] > c["limit"], line["checks"]


def test_the_consensus_control_is_not_correct(capsys, checkout):
    line = run_line(capsys, "ecoli_20x.falconsense", checkout, control=True)
    assert line["correct"] is False
    assert line["checks"]["cns_err_pct"]["value"] > 5.0
