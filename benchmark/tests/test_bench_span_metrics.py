"""The readers of the port's host spans on a hand-made ``ctx``: each gives
the value worked out by hand, and None where the jobs and the slots'
traces carry no span rows (an untraced run, or a port without the
recorder)."""
import json
import os

import pytest

from benchmark import run, slots

BENCH = os.path.join(run.ROOT, "benchmark")


def _row(name, s, **kw):
    return {"stage": name, "s": s, "ts": 100.0 + s, "t0": 100.0, **kw}


def _ctx(with_rows: bool, tmp_path) -> dict:
    """Two slots of two cores; a failed job's rows do not count.
    FalconSense's rows are in each slot's trace, one request's."""
    def asm(bp, failed=False):
        unzip = [_row("align_compute", 9.0),
                 _row("overlap.compute", 8.0, thread="df-overlap-compute"),
                 _row("hasm.join_wait", 2.0),
                 _row("run_unzip", 20.0, proc_cpu_s=30.0)]
        quiver = [_row("polish.arrow", 1.5), _row("polish.arrow", 0.5),
                  _row("run_quiver", 10.0, proc_cpu_s=6.0)]
        stages = ({"unzip": unzip, "quiver": quiver} if with_rows
                  else {"unzip": unzip[:1], "quiver": []})
        return {"bp": bp, "failed": failed, "stages": stages}

    def trace(s):
        rows = [_row("cns.seed", 0.3), _row("cns.dp", 0.4),
                _row("cns.dp.pack", 0.05), _row("cns.dp.wait", 0.01),
                _row("cns.dp.wait", 0.01), _row("cns.dp.post", 0.3),
                _row("cns.vote", 0.1)]
        meta = {"schemaVersion": 1, "traceEvents": [], "fu_other": rows}
        if with_rows:
            meta["fu_spans.9"] = rows[:4]
            meta["fu_spans.12"] = rows[4:] + [
                _row("falconsense", 0.8, proc_cpu_s=0.9, bp=10_000)]
        path = tmp_path / f"trace.slot{s}.{with_rows}.json"
        path.write_text(json.dumps(meta))
        return {"path": str(path), "wall": (0.0, 0.0)}

    results = []
    for s in range(2):
        results.append({"slot": s, "cores": [2 * s, 2 * s + 1],
                        "records": [asm(400_000), asm(400_000, True)],
                        "trace": trace(s)})
    return {"results": results}


# per slot: one sound assembly of 0.4 Mb and one sound request of 0.01 Mb
WANT = {
    "cns.seed_s_per_mb": 2 * 0.3 / 0.02,
    "cns.dp_s_per_mb": 2 * 0.4 / 0.02,
    "cns.dp_wait_pct": 100.0 * 0.02 / 0.4,
    "cns.vote_s_per_mb": 2 * 0.1 / 0.02,
    "unzip.overlap_s_per_mb": 2 * 8.0 / 0.8,
    "unzip.overlap_hidden_pct": 100.0 * (1 - 2.0 / 8.0),
    "quiver.arrow_s_per_mb": 2 * 2.0 / 0.8,
    "host_cpu_pct.asm": 100.0 * (30.0 + 6.0) / ((20.0 + 10.0) * 2),
    "host_cpu_pct.cns": 100.0 * 0.9 / (0.8 * 2),
}


def _reader(name):
    return slots.load_file(os.path.join(BENCH, "metrics", f"{name}.py"),
                           f"fu_bench_metric_{name}")


@pytest.mark.parametrize("name", sorted(WANT))
def test_span_reader_reads_the_hand_worked_value(name, tmp_path):
    assert _reader(name).read(_ctx(True, tmp_path)) == \
        pytest.approx(WANT[name])
    assert _reader(name).read(_ctx(False, tmp_path)) is None
    untraced = _ctx(False, tmp_path)
    for res in untraced["results"]:
        del res["trace"]
    assert _reader(name).read(untraced) is None


def test_every_span_metric_is_in_the_manifest():
    man = run.load_json(os.path.join(run.ROOT, "BENCHMARK.json"))
    spans = {m["name"]: m for m in man["per_layer"]
             if m["source"] == "program_span"}
    assert set(WANT) <= set(spans)
    for name in WANT:
        cell = spans[name]["workloads"]
        assert cell == (["ecoli_20x.falconsense"] if name.startswith("cns.")
                        or name.endswith(".cns")
                        else ["n50_25x.unzip_polish"])
        spec = run.cell_spec(cell[0])
        assert spans[name]["moves"] in {m["name"] for m in spec["end_to_end"]}
        assert name in {m["name"] for m in spec["per_layer"]}


def test_gaps_are_labelled_by_each_threads_innermost_span(tmp_path):
    """A slot's label at t is the innermost span on each of its threads,
    from the slot's trace: the prefetch thread's ``overlap.cand`` beside
    the main thread's ``hasm.join_wait``; a slot with no job then reads
    "no job"."""
    def trace(name, *spans):
        rows = [{"stage": n, "id": i, "t0": a, "ts": b, "s": b - a,
                 "thread": th} for i, (n, a, b, th) in enumerate(spans)]
        path = tmp_path / name
        path.write_text(json.dumps({"traceEvents": [], "fu_spans.3": rows}))
        return {"path": str(path), "wall": (0.0, 0.0)}
    pre = "df-overlap-compute"
    results = [
        {"records": [{"start": 0.0, "end": 100.0, "failed": False}],
         "trace": trace("asm.json", ("run_unzip", 1, 90, "MainThread"),
                        ("stage.3-hasm", 10, 60, "MainThread"),
                        ("hasm.join_wait", 20, 50, "MainThread"),
                        ("overlap.compute", 5, 55, pre),
                        ("overlap.cand", 15, 45, pre))},
        {"records": [{"start": 1.0, "end": 2.0, "failed": False}],
         "trace": trace("cns.json", ("cns.seed", 1.1, 1.9, "MainThread"),
                        ("falconsense", 1.0, 1.95, "MainThread"))}]
    hosts = [run.host_spans(res) for res in results]
    assert run._label(hosts, 30.0) == "hasm.join_wait+no job+overlap.cand"
    assert run._label(hosts, 1.5) == "cns.seed+run_unzip"
    assert run._label(hosts, 0.5) == "job+no job"
