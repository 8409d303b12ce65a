"""BENCHMARK.json against the shape its readers expect, and discovery by
name: a configuration, a traffic mix and a per-layer metric dropped into
a copy of the benchmark are found with no file edited."""
import json
import os
import re
import shutil

import pytest

from benchmark import run, slots

ROOT = run.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def manifest():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


def test_manifest_shape():
    m = manifest()
    assert list(m) == ["command", "paths", "run_seconds", "configs",
                       "workloads", "end_to_end", "per_layer"]
    assert m["paths"] == ["benchmark"] and 1 <= m["run_seconds"] <= 51
    names = [e["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for e in m[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    e2e = {e["name"]: e for e in m["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for e in m["end_to_end"]:
        assert 0.01 <= e["bound"] <= 0.25 and UNIT.match(e["unit"])
        assert e["source"] in ("host_clock", "device_trace")
    cells = {w["name"]: w for w in m["workloads"]}
    for w in m["workloads"]:
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert os.path.exists(os.path.join(ROOT, "benchmark", "traffic",
                                           w["traffic"] + ".json"))
        spec = run.cell_spec(w["name"])
        assert spec["per_layer"] and len(spec["end_to_end"]) >= 2
        assert {p["name"] for p in spec["per_layer"]} == {
            p["name"] for p in m["per_layer"] if w["name"] in p["workloads"]}
    for c in m["configs"]:
        assert c["file"].startswith("benchmark/")
        with open(os.path.join(ROOT, c["file"])) as fh:
            body = json.load(fh)
        assert body["reduced"] == c["reduced"] and body["source"] == \
            c["source"]
    for p in m["per_layer"]:
        assert p["moves"] in e2e and set(p["workloads"]) <= set(cells)
        assert os.path.exists(os.path.join(ROOT, "benchmark", "metrics",
                                           p["name"] + ".py"))
        if "_roofline" in p["name"]:
            assert p["unit"] == "%"


CNS_LAYER = ["cns_bp_per_s.host", "device_idle_pct.cns",
             "wavefront_roofline.cns", "cns.seed_s_per_mb",
             "cns.dp_s_per_mb", "cns.dp_wait_pct", "cns.vote_s_per_mb",
             "host_cpu_pct.cns"]


def test_the_consensus_rate_is_end_to_end_and_its_layers_move_it():
    """The consensus cell bounds its rate end to end, and each of its
    per-layer metrics moves that rate, so none is dropped from its spec."""
    spec = run.cell_spec("ecoli_20x.falconsense")
    e2e = {e["name"]: e for e in spec["end_to_end"]}
    assert set(e2e) == {"cns_qv", "cns_bp_per_s", "setup_s"}
    rate = e2e["cns_bp_per_s"]
    assert 0.01 <= rate["bound"] <= 0.25
    assert (rate["unit"], rate["better"], rate["source"]) == (
        "bp/s", "higher", "host_clock")
    layer = {p["name"]: p for p in spec["per_layer"]}
    assert set(layer) == set(CNS_LAYER)
    assert all(layer[n]["moves"] == "cns_bp_per_s" for n in CNS_LAYER)
    assert "cns_bp_per_s" not in {
        e["name"] for e in run.cell_spec("n50_25x.unzip_polish")[
            "end_to_end"]}


def test_new_config_traffic_and_metric_are_found_by_name(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    m = manifest()
    with open(root / "benchmark" / "configs" / "ecoli_cns_20x.json") as fh:
        conf = json.load(fh)
    conf.update(name="toy_cns", length=30_000)
    (root / "benchmark" / "configs" / "toy_cns.json").write_text(
        json.dumps(conf))
    (root / "benchmark" / "traffic" / "toy.json").write_text(json.dumps(
        {"driver": "falconsense", "slots": 1, "min_overlap": 700,
         "scored": 1}))
    (root / "benchmark" / "metrics" / "toy_requests.py").write_text(
        "def read(ctx):\n"
        "    return sum(len(r['records']) for r in ctx['results'])\n")
    m["configs"].append({"name": "toy_cns", "source": "toy",
                         "file": "benchmark/configs/toy_cns.json",
                         "reduced": [], "why": "toy"})
    m["workloads"].append({"name": "toy_cns.toy", "config": "toy_cns",
                           "traffic": "toy", "chips": 1, "why": "toy"})
    for e in m["end_to_end"]:
        if e["name"] == "cns_qv":
            e["workloads"].append("toy_cns.toy")
    m["per_layer"].append({"name": "toy_requests", "unit": "requests",
                           "better": "higher", "source": "program_counter",
                           "layer": "job slots", "moves": "cns_qv",
                           "workloads": ["toy_cns.toy"]})
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    spec = run.cell_spec("toy_cns.toy", root=str(root))
    assert spec["config"]["length"] == 30_000
    assert spec["traffic"]["min_overlap"] == 700
    assert spec["driver_file"] == str(root / "benchmark" / "drivers" /
                                      "falconsense.py")
    assert [p["name"] for p in spec["per_layer"]] == ["toy_requests"]
    reader = slots.load_file(str(root / "benchmark" / "metrics" /
                                 "toy_requests.py"), "toy")
    assert reader.read({"results": [{"records": [1, 2]}]}) == 2


def test_unknown_cell_gives_no_result(capsys):
    assert run.main(["--workload", "nope", "--seed", "1", "--seconds", "1"],
                    device="cpu") != 0
    assert capsys.readouterr().out == ""


def test_no_card_gives_no_result(capsys):
    """On a machine without a card the run exits non-zero with no result."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert run.main(["--workload", "ecoli_20x.falconsense", "--seed", "1",
                     "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""
