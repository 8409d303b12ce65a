"""The port's span recorder (utils/profiling.py) and FalconSense's spans.

Off (no profiler recording) a span only times its block; under a
``torch.profiler`` session with CPU activity it keeps a record a span:
its parent on its own thread, or the open root for a thread that has none
open, the thread's name and CPU time, a root's process CPU time, the
span's attributes.  FalconSense's consensus is the same either way.
"""
import json
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from falcon_unzip_tpu_torch.models.consensus import FalconSense
from falcon_unzip_tpu_torch.utils import profiling
from falcon_unzip_tpu_torch.utils.fixtures import template_reads
from falcon_unzip_tpu_torch.utils.metrics import MetricsLog
from falcon_unzip_tpu_torch.utils.profiling import drain, log_spans, span

# one intra-op thread: the suite runs several pytest workers on one host
torch.set_num_threads(1)

CNS = ["falconsense", "cns.seed", "cns.dp", "cns.dp.pack", "cns.dp.wait",
       "cns.dp.post", "cns.vote"]


def _busy(s: float) -> None:
    end = time.perf_counter() + s
    while time.perf_counter() < end:
        pass


def test_off_a_span_times_and_keeps_nothing():
    drain()
    assert not profiling.enabled()
    with span("x", n=1) as sp:
        _busy(0.01)
    assert 0.01 <= sp.s < 1.0
    assert drain() == []


def test_on_a_span_keeps_its_record():
    drain()
    t = time.time()
    with profile(activities=[ProfilerActivity.CPU]):
        assert profiling.enabled()
        with span("root", job=7) as root:
            with span("child"):
                _busy(0.01)

            def work():
                with span("elsewhere"):
                    _busy(0.01)
            th = threading.Thread(target=work, name="helper")
            th.start()
            th.join()
    t1 = time.time()
    recs = {r["stage"]: r for r in drain()}
    assert sorted(recs) == ["child", "elsewhere", "root"]
    r, c, e = recs["root"], recs["child"], recs["elsewhere"]
    assert r["parent"] is None and r["job"] == 7 and "proc_cpu_s" in r
    assert c["parent"] == r["id"] and "proc_cpu_s" not in c
    # a thread with no span open hangs under the process's open root
    assert e["parent"] == r["id"] and e["thread"] == "helper"
    assert c["thread"] == r["thread"] == threading.current_thread().name
    assert r["s"] == root.s
    for x in (c, e):
        assert r["t0"] <= x["t0"] <= x["ts"] <= r["ts"]
        assert 0 < x["cpu_s"] <= x["s"]
    assert t - 1e-3 <= r["t0"] and r["ts"] <= t1 + 1e-3
    assert r["ts"] - r["t0"] == pytest.approx(r["s"], abs=2e-6)


def test_log_spans_writes_a_row_a_span_with_its_own_end(tmp_path):
    """A row a span, its ts the span's end unrounded (MetricsLog's own ts
    is to the millisecond), so that ts - s is the span's start."""
    drain()
    with profile(activities=[ProfilerActivity.CPU]):
        with span("a") as sp:
            _busy(0.002)
    log = MetricsLog(str(tmp_path / "metrics.jsonl"))
    log_spans(log)
    log_spans(log)                   # drained: nothing more
    with open(tmp_path / "metrics.jsonl") as fh:
        rows = [json.loads(ln) for ln in fh]
    assert [r["stage"] for r in rows] == ["a"]
    row = rows[0]
    assert set(row) == {"ts", "stage", "id", "parent", "thread", "t0", "s",
                        "cpu_s", "proc_cpu_s"}
    assert row["s"] == sp.s
    assert row["ts"] - row["s"] == pytest.approx(row["t0"], abs=2e-6)


def test_a_roots_records_go_into_the_profilers_trace(tmp_path):
    """Each root's tree of records is metadata of the profiler's exported
    trace, under fu_spans.<root id>; drain still returns them all."""
    drain()
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    for job in range(2):
        with span("root", job=job):
            with span("child"):
                with span("leaf"):
                    pass
    prof.stop()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    kept = drain()
    with open(path) as fh:
        meta = json.load(fh)
    trees = {k: v for k, v in meta.items()
             if k.startswith(profiling.TRACE_KEY)}
    roots = [r for r in kept if r["stage"] == "root"]
    assert sorted(trees) == sorted(f"{profiling.TRACE_KEY}{r['id']}"
                                   for r in roots)
    for root in roots:
        rows = trees[f"{profiling.TRACE_KEY}{root['id']}"]
        assert [r["stage"] for r in rows] == ["leaf", "child", "root"]
        assert rows == [r for r in kept if r["id"] in
                        {x["id"] for x in rows}]
        assert rows[-1]["job"] == root["job"]


def test_falconsense_spans_on_and_off():
    """The same consensus with the recorder off and on; on, each call
    records its root and each of its parts once (one chunk of pairs)."""
    _, template, reads, _ = template_reads(1200, 6, 5)
    fs = FalconSense(None, "cpu")
    drain()
    off = fs(template, reads)
    assert drain() == []
    with profile(activities=[ProfilerActivity.CPU]):
        on = [fs(template, reads) for _ in range(2)]
    recs = drain()
    for cns in on:
        assert np.array_equal(cns, off)
    names = [r["stage"] for r in recs]
    for name in CNS:
        assert names.count(name) == 2, name
    by_id = {r["id"]: r for r in recs}
    for r in recs:
        if r["stage"] == "falconsense":
            assert r["parent"] is None and r["bp"] == len(template)
            continue
        p = by_id[r["parent"]]
        want = "cns.dp" if r["stage"].startswith("cns.dp.") \
            else "falconsense"
        assert p["stage"] == want, r
        assert p["t0"] <= r["t0"] and r["ts"] <= p["ts"]


def test_spans_from_many_threads_are_all_kept():
    """More threads than cores open and close spans under one root with
    a short switch interval: every record is kept, each under its own
    thread's span or the root."""
    n_threads, n_spans = 2 * (os.cpu_count() or 4), 200
    drain()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            with span("root"):
                def work():
                    for _ in range(n_spans):
                        with span("outer"):
                            with span("inner"):
                                pass
                threads = [threading.Thread(target=work, name=f"w{i}")
                           for i in range(n_threads)]
                for th in threads:
                    th.start()
                for th in threads:
                    th.join(timeout=60)
                assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    recs = drain()
    assert len(recs) == 2 * n_threads * n_spans + 1
    by_id = {r["id"]: r for r in recs}
    assert len(by_id) == len(recs)
    root = next(r for r in recs if r["stage"] == "root")
    for r in recs:
        if r["stage"] == "outer":
            assert r["parent"] == root["id"]
        elif r["stage"] == "inner":
            p = by_id[r["parent"]]
            assert p["stage"] == "outer" and p["thread"] == r["thread"]
