"""The four-host cell, ``fungal_25x.ranks4``, on the CPU: four CPU ranks of
one gloo world through ``run.main(device="cpu")`` at a tiny size.

The ranks run the stand-in of ``ranks_faults.py`` (the port's plain DP
takes minutes a kilobase here), which moves its records through the
port's own collectives.  Checked: the result line, traced and untraced,
with every per-layer reader that a CPU run can feed; the vote that keeps
the ranks on the same jobs when their clocks straddle the window's end; a
rank that raises, which ends the run with no result well inside the drain
limit; and two faults of the collectives that must turn ``correct``
false.  The device reader and the collective readers are checked on
hand-made rows.  Last, the cell on the port itself (its plain DP, ~2.5
min a run): four 6 kb contigs, sound and under the control.
"""
import json
import os
import shutil
import time

import pytest

from benchmark import run, slots
from benchmark.collectives import outermost
from benchmark.tests import ranks_faults

CELL = "fungal_25x.ranks4"
TINY = {"config": {"genome_bp": 60_000},
        "traffic": {"warmup_bp": 8000, "timeout_s": 60}}


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    root = tmp_path_factory.mktemp("checkout")
    shutil.copy(os.path.join(run.ROOT, "BENCHMARK.json"), root)
    shutil.copytree(os.path.join(run.ROOT, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    return root


def run_cell(capfd, root, fault="ranks_oracle", trace=0,
             seed=3_000_000_019, seconds=1, **kw):
    over = {k: dict(v) for k, v in TINY.items()}
    over["traffic"]["driver"] = ranks_faults.driver_file(
        str(root / "benchmark"), fault)
    t = time.time()
    rc = run.main(["--workload", CELL, "--seed", str(seed), "--seconds",
                   str(seconds), "--trace", str(trace)], device="cpu",
                  overrides=over, root=str(root), **kw)
    cap = capfd.readouterr()
    out = cap.out.strip().splitlines()
    line = json.loads(out[-1]) if rc == 0 else None
    return rc, line, time.time() - t, cap.err


@pytest.mark.parametrize("trace", [0, 1])
def test_the_cell_runs_over_four_ranks(capfd, checkout, trace):
    rc, line, _, err = run_cell(capfd, checkout, trace=trace)
    assert rc == 0, err[-3000:]
    assert line["correct"] is True, line
    assert line["failed"] == 0
    assert line["attempted"] >= 4 and line["attempted"] % 4 == 0
    spec = run.cell_spec(CELL)
    if trace:       # all but the device's: a CPU run traces no device
        want = {m["name"] for m in spec["per_layer"]} - {
            "device_idle_pct.ranks4"}
        assert set(line["metrics"]) == want, line["metrics"]
        assert all(v["value"] > 0 for v in line["metrics"].values())
        assert line["metrics"]["dist.wait_pct"]["value"] < 100
    else:
        assert set(line["metrics"]) == {"asm_qv", "setup_s"}
    for name, c in line["checks"].items():
        assert c["value"] <= c["limit"], name
    for rank in range(4):
        assert f"[rank {rank}] card None" in err


def test_ranks_straddling_the_window_end_run_the_same_jobs(capfd,
                                                           checkout):
    """Rank 3 ends each job 1.5 s after the others, so at the end of job 0
    ranks 0-2 are inside the 2 s window and rank 3 is past it: rank 3
    votes 0, learns that the others start job 1, and runs it too."""
    rc, line, secs, err = run_cell(capfd, checkout, fault="ranks_straggler",
                                   seconds=2)
    assert rc == 0, err[-3000:]
    jobs = [int(x.split("jobs ")[1].split(":")[0])
            for x in err.splitlines()
            if x.startswith("[slot ") and " set-up " in x]
    assert len(jobs) == 4 and len(set(jobs)) == 1 and jobs[0] >= 2, jobs
    assert line["correct"] is True and line["attempted"] == 4 * jobs[0]


def test_a_rank_that_raises_ends_the_run_with_no_result(capfd, checkout):
    rc, line, secs, err = run_cell(capfd, checkout,
                                   fault="ranks_rank_raises")
    assert rc != 0 and line is None
    assert "rank 2 fails in unzip" in err and "no result" in err
    assert secs < run.DRAIN_LIMIT_S / 2


@pytest.mark.parametrize("fault, check", [
    ("ranks_exchange_keeps_own", "phase_err_pct"),
    ("ranks_primary_keeps_own", "p_span_err_pct"),
])
def test_a_broken_collective_is_not_correct(capfd, checkout, fault, check):
    rc, line, _, err = run_cell(capfd, checkout, fault=fault)
    assert rc == 0, err[-3000:]
    assert line["correct"] is False
    c = line["checks"][check]
    assert c["value"] > c["limit"], line["checks"]


def _trace(path, busy: list) -> dict:
    """A slot's trace: the mark at trace time 1 s, then kernels on its
    card over ``busy`` (wall seconds, the mark read at wall 101 s)."""
    ev = [{"ph": "X", "cat": "kernel", "name": "spin_kernel",
           "ts": 1e6 - 5, "dur": 10}]
    ev += [{"ph": "X", "cat": "kernel", "name": "k", "ts": (a - 100) * 1e6,
            "dur": (b - a) * 1e6} for a, b in busy]
    path.write_text(json.dumps({"traceEvents": ev}))
    return {"path": str(path), "wall": (101.0, 101.0)}


def test_device_idle_is_each_cards_own(tmp_path):
    """Two cards busy over different halves of a 10 s window: each idle
    50%, where the union of the two would read the window fully busy."""
    from benchmark import trace
    results = [{"trace": _trace(tmp_path / "a.json", [(101.0, 106.0)])},
               {"trace": _trace(tmp_path / "b.json", [(106.0, 111.0)])}]
    merged = trace.merge([trace.read(r["trace"]["path"], r["trace"]["wall"])
                          for r in results], 101.0, 111.0)
    ctx = {"device": "cuda", "results": results, "t0": 101.0,
           "t_last": 111.0, "trace": merged}
    reader = slots.load_file(os.path.join(
        run.ROOT, "benchmark", "metrics", "device_idle_pct.ranks4.py"), "r")
    assert merged["busy_s"] == pytest.approx(10.0)
    assert reader.read(ctx) == pytest.approx(50.0)
    assert reader.read({**ctx, "device": "cpu"}) is None
    assert reader.read({**ctx, "trace": None}) is None


def _rows(*spec):
    """Rows of a hand-made nesting: (name, id, parent, s, bytes_in), the
    bytes kept only where given, as only the leaf helpers carry them."""
    return [{"stage": n, "id": i, "parent": p, "s": s, "t0": 0.0,
             **({} if b is None else {"bytes_in": b})}
            for n, i, p, s, b in spec]


def test_collective_readers_count_the_outermost_spans():
    """Two ranks' records of one job over a 0.8 Mb genome: an exchange
    holding its rounds, a barrier, a gather; an untraced job adds
    nothing."""
    rank = _rows(("run_unzip", 1, None, 8.0, None),
                 ("dist.exchange_to_owners", 2, 1, 2.0, None),
                 ("dist.allgather_bytes", 3, 2, 1.5, None),
                 ("dist.all_gather_rows", 4, 3, 0.25, 40),
                 ("dist.all_gather_rows", 5, 3, 1.0, 960),
                 ("dist.barrier", 6, 1, 0.5, 0))
    quiver = _rows(("run_quiver", 7, None, 2.0, None),
                   ("dist.gather_to_primary", 8, 7, 0.5, None),
                   ("dist.allgather_bytes", 9, 8, 0.5, None),
                   ("dist.all_gather_rows", 10, 9, 0.5, 200))
    rec = {"failed": False, "bp": 400_000,
           "stages": {"unzip": rank, "quiver": quiver}}
    bare = {"failed": False, "bp": 400_000,
            "stages": {"unzip": rank[:1], "quiver": quiver[:1]}}
    ctx = {"results": [{"records": [rec]}, {"records": [rec, bare]}]}
    want = {"dist.collective_s_per_mb": 2 * 3.0 / 0.8,
            "dist.wait_pct": 100.0 * 3.0 / 10.0,
            "dist.bytes_per_mb": 2 * 1200 / 0.8}
    for name, value in want.items():
        reader = slots.load_file(os.path.join(
            run.ROOT, "benchmark", "metrics", f"{name}.py"), name)
        assert reader.read(ctx) == pytest.approx(value), name
        assert reader.read({"results": [{"records": [bare]}]}) is None


def test_outermost_counting_equals_the_leaves_over_a_known_nesting():
    """Where every call's seconds are its children's, the outermost rows'
    seconds are the leaves': one exchange of two rounds of two gathers,
    a gather beside it, and a dist row under a pipeline span."""
    rows = _rows(
        ("run_unzip", 1, None, 10.0, None),
        ("align.compute", 2, 1, 6.0, None),
        ("dist.exchange_to_owners", 3, 2, 4.0, None),
        ("dist.allgather_bytes", 4, 3, 1.5, None),
        ("dist.all_gather_rows", 5, 4, 0.5, 8),
        ("dist.all_gather_rows", 6, 4, 1.0, 64),
        ("dist.allgather_bytes", 7, 3, 2.5, None),
        ("dist.all_gather_rows", 8, 7, 2.0, 8),
        ("dist.all_gather_rows", 9, 7, 0.5, 32),
        ("dist.barrier", 10, 1, 0.25, 0),
        ("hasm.placement", 11, 1, 1.0, None),
    )
    top = outermost(rows)
    assert [r["id"] for r in top] == [3, 10]
    ids = {r["parent"] for r in rows}
    leaves = [r for r in rows if r["stage"].startswith("dist.")
              and r["id"] not in ids]
    assert sum(r["s"] for r in top) == sum(r["s"] for r in leaves) == 4.25
    # rows out of order, and a parent that was never kept, change nothing
    assert [r["id"] for r in outermost(rows[::-1])] == [10, 3]
    assert [r["id"] for r in outermost(rows[3:])] == [4, 7, 10]


@pytest.mark.parametrize("control", [False, True])
def test_the_cell_on_the_port(capfd, monkeypatch, control):
    """The port's own ``run_unzip`` and ``run_quiver`` over the four CPU
    ranks, through the cell's driver, at 24 kb (four 6 kb contigs, 2 kb
    reads): every rank runs the job, and host 0's outputs pass; the
    configuration's control runs as well and does not."""
    monkeypatch.setattr(run, "DRAIN_LIMIT_S", 900)
    monkeypatch.setattr(run, "SETUP_LIMIT_S", 900)
    over = {"config": {"genome_bp": 24_000, "contig_fractions": [0.25] * 4,
                       "pread_len": 2000, "raw_len": 2000},
            "traffic": {"warmup_bp": 8000}}
    rc = run.main(["--workload", CELL, "--seed", "4000000007", "--seconds",
                   "1", "--trace", "0"], device="cpu", overrides=over,
                  control=control)
    cap = capfd.readouterr()
    assert rc == 0, cap.err[-3000:]
    line = json.loads(cap.out.strip().splitlines()[-1])
    assert line["correct"] is (not control) and line["failed"] == 0, line
    assert line["attempted"] == 4
