"""The assembly cell on the port itself at a tiny size on the CPU: the
slots run the port's ``run_unzip`` and ``run_quiver`` (its plain torch DP
here) and the run prints its result line; with the cell's control (the
port with 2-phasing and 4-polish's consensus off by its own knobs) the
comparison with the reference fails (some minutes each)."""
import json

import pytest

from benchmark import run

TINY = {"config": {"genome_bp": 6000, "contig_fractions": [1.0],
                   "pread_len": 2000, "raw_len": 2000},
        "traffic": {"slots": 1, "warmup_bp": 3000}}


@pytest.mark.parametrize("control", [False, True])
def test_assembly_cell_on_the_port(capsys, monkeypatch, control):
    monkeypatch.setattr(run, "DRAIN_LIMIT_S", 900)
    monkeypatch.setattr(run, "SETUP_LIMIT_S", 900)
    rc = run.main(["--workload", "n50_25x.unzip_polish", "--seed",
                   "4000000007", "--seconds", "1", "--trace", "1"],
                  device="cpu", overrides=TINY, control=control)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"] and list(line)[-1] == "checks"
    assert line["failed"] == 0 and line["attempted"] == 1
    assert "quiver.polish_windows_s_per_mb" in line["metrics"]
    if control:
        checks = line["checks"]
        assert line["correct"] is False
        for name in ("cns_err_per_mb", "phase_err_pct"):
            assert checks[name]["value"] > checks[name]["limit"], checks
